"""Node bootstrap: start/stop the per-node services.

Counterpart of ``ray_tpu/_private/node.py``: a head node owns the GCS, the
scheduler ("raylet-lite"), and the native shared-memory object store
daemon, all rooted in a session directory under ``session_root()``
(``<tmp>/ray_tpu_torch/``, or a root named by a hash of ``<tmp>`` when
that path is too long for unix sockets).  The root and the shared-memory segment names
(``rtpt_<pid>_<node>``) differ from the JAX package's (``/tmp/ray_tpu/``,
``rtpu_...``), so both runtimes live side by side in one process and
``init(address="auto")`` of one never finds the other's GCS.  Resource
detection counts GPUs with ``torch.cuda.device_count()``
(``RAY_TPU_NUM_GPUS`` overrides), which reads the device count without
creating a CUDA context: the card belongs to the worker that wins the
``GPU`` resource.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import threading
import time
from typing import Optional

from ray_tpu_torch._private.gcs import Gcs, GcsClient, GcsServer, NodeInfo
from ray_tpu_torch._private.scheduler import Scheduler
from ray_tpu_torch.core.store_client import StoreClient, StoreServer

DEFAULT_STORE_CAPACITY = 1 << 31  # default; see RTPU_STORE_CAPACITY

SESSION_ROOT_NAME = "ray_tpu_torch"
SHM_PREFIX = "rtpt_"
# The longest path a session binds is a worker's direct-call socket,
# <root>/session_<ts>_<pid>_<node>/w_<id>.sock; sun_path holds 107 bytes.
_MAX_ROOT_LEN = 107 - len(
    "/session_2026-01-01_00-00-00_4194304_000000/w_0000000000000000.sock")


def session_root() -> str:
    """The directory the port's sessions live under: ``ray_tpu_torch`` in
    the temporary directory.  When that path is too long for the
    session's unix sockets, ``/tmp/rtpt_<hash of the temporary
    directory>``: processes with different temporary directories never
    share a root, so ``address="auto"`` never reaches another's cluster."""
    tmp = tempfile.gettempdir()
    root = os.path.join(tmp, SESSION_ROOT_NAME)
    if len(root) > _MAX_ROOT_LEN:
        digest = hashlib.sha256(
            os.path.realpath(tmp).encode()).hexdigest()[:8]
        root = os.path.join("/tmp", SHM_PREFIX + digest)
    return root


def live_session_sockets(name: str = "sched.sock") -> list:
    """The ``session_*/<name>`` sockets under ``session_root()`` that
    accept a connection, newest first.  A crashed cluster leaves its
    sockets on disk, so each is probed before it is returned.  The CLI,
    ``init(address="auto")`` and the job client all find a cluster here."""
    import glob
    import socket

    def mtime(path):
        try:
            return os.path.getmtime(path)
        except OSError:  # its session ended between the glob and here
            return 0.0

    paths = sorted(glob.glob(os.path.join(session_root(), "session_*", name)),
                   key=mtime, reverse=True)
    live = []
    for path in paths:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(1.0)
        try:
            s.connect(path)
            live.append(path)
        except OSError:
            continue
        finally:
            s.close()
    return live

# Recovery-plane self-instrumentation: restarts performed by
# _supervise_store (process-wide singleton, created on first restart so
# idle nodes register nothing).
_STORE_RESTARTS = None


def _store_restart_counter():
    global _STORE_RESTARTS
    if _STORE_RESTARTS is None:
        from ray_tpu_torch.util.metrics import Counter

        # family name built from parts, as the port's other families are
        _STORE_RESTARTS = Counter(
            "store" + "_daemon_restarts_total",
            description="Store daemon crashes recovered in place by the "
                        "node supervisor")
    return _STORE_RESTARTS


def _cluster_token_or_empty() -> str:
    """This cluster's shared-secret token ("" for tokenless local
    clusters) — authenticates store-daemon transfer peers too."""
    from ray_tpu_torch._private import protocol

    return protocol.cluster_token() or ""


def detect_num_gpus() -> int:
    """The node's GPUs: ``RAY_TPU_NUM_GPUS`` if set, else
    ``torch.cuda.device_count()`` (no CUDA context is created)."""
    env = os.environ.get("RAY_TPU_NUM_GPUS")
    if env:
        return int(env)
    try:
        import torch

        return int(torch.cuda.device_count())
    except Exception:
        return 0


def default_resources() -> dict:
    res = {"CPU": float(os.cpu_count() or 1)}
    n_gpu = detect_num_gpus()
    if n_gpu:
        res["GPU"] = float(n_gpu)
    return res


class Node:
    """One cluster node: object store + scheduler (+ GCS service on the head).

    head=True starts the GCS tables and serves them on ``gcs.sock`` inside
    the session dir; worker nodes (head=False) pass ``gcs_address`` (the
    head's gcs.sock path) and join via a GcsClient — the reference analogue
    is services.py start_gcs_server vs start_raylet (SURVEY §3.1).
    """

    def __init__(
        self,
        resources: Optional[dict] = None,
        object_store_memory: Optional[int] = None,
        min_workers: int = 2,
        max_workers: Optional[int] = None,
        session_dir: Optional[str] = None,
        head: bool = True,
        gcs_address: Optional[str] = None,
        include_dashboard: bool = True,
        node_id: Optional[bytes] = None,
        merge_default_resources: bool = True,
        listen_host: Optional[str] = None,
        gcs_persist_path: Optional[str] = None,
        labels: Optional[dict] = None,
    ):
        self.labels = dict(labels or {})
        """listen_host: bind the node's control-plane services (GCS on the
        head, scheduler everywhere) to TCP on this interface instead of
        unix sockets — required for clusters spanning hosts.  The object
        store stays node-local shm either way; cross-node object bytes
        flow through the schedulers' chunked fetch path.  Defaults to the
        RTPU_LISTEN_HOST env var (unset = unix sockets)."""
        self.node_id = node_id or os.urandom(16)
        self.is_head = head
        self.listen_host = (listen_host
                            if listen_host is not None
                            else os.environ.get("RTPU_LISTEN_HOST") or None)
        from ray_tpu_torch._private import protocol as _protocol

        if gcs_address is not None:
            if self.listen_host:
                # joining node: a token embedded in the address wins, else
                # RTPU_CLUSTER_TOKEN must already hold the head's token
                tok, gcs_address = _protocol.split_token_addr(gcs_address)
                if tok:
                    os.environ[_protocol._TOKEN_ENV] = tok
                if (not _protocol.cluster_token()
                        and _protocol.is_tcp_addr(gcs_address)):
                    raise ValueError(
                        "joining a TCP cluster requires the head's cluster "
                        "token: set RTPU_CLUSTER_TOKEN or use a "
                        "token@host:port address")
                _protocol.ensure_cluster_token()
            # local (unix-socket) joining nodes adopt the head's token via
            # the GCS flag sync below — which runs BEFORE the store daemon
            # spawns, so its transfer plane authenticates against the head
        else:
            # head: generate the cluster token even for local unix-socket
            # clusters (exported via env so worker processes and external
            # nodes inherit it) — the store daemons' loopback TCP transfer
            # plane must always be token-authed
            _protocol.ensure_cluster_token()
        ts = time.strftime("%Y-%m-%d_%H-%M-%S")
        self.session_dir = session_dir or os.path.join(
            session_root(),
            f"session_{ts}_{os.getpid()}_{self.node_id[:3].hex()}")
        os.makedirs(self.session_dir, exist_ok=True)

        if merge_default_resources:
            merged = default_resources()
            if resources:
                merged.update(resources)
        else:
            # Exact mode (autoscaler-launched nodes): advertise PRECISELY
            # the declared node-type shape so the scale-up planner's
            # bin-packing matches what actually joins.
            merged = dict(resources or {})
        self.resources = merged

        capacity = object_store_memory or _default_store_capacity()
        shm_name = f"{SHM_PREFIX}{os.getpid()}_{self.node_id[:4].hex()}"
        if self.listen_host:
            sched_socket = f"{self.listen_host}:0"  # kernel-assigned port
        else:
            sched_socket = os.path.join(self.session_dir, "sched.sock")
        self._gcs_proc = None
        if head:
            # Durable control plane (reference: Redis-backed GCS fault
            # tolerance): point RTPU_GCS_PERSIST (or gcs_persist_path) at
            # a stable file and a restarted head restores actors/PGs/KV.
            persist = (gcs_persist_path
                       or os.environ.get("RTPU_GCS_PERSIST") or None)
            gcs_bind = (f"{self.listen_host}:0" if self.listen_host
                        else os.path.join(self.session_dir, "gcs.sock"))
            if os.environ.get("RTPU_PYTHON_GCS"):
                # Fallback: in-process Python GCS (debugging / platforms
                # without the native toolchain).
                self.gcs = Gcs(persist_path=persist)
                self.gcs_server = GcsServer(self.gcs, gcs_bind)
                self.gcs_address = self.gcs_server.socket_path
            else:
                # Default: the native C++ GCS daemon (reference: the
                # gcs_server process spawned by services.py:1442).  The
                # head talks to it through GcsClient like every other
                # node — one control plane, no in-process special case.
                self.gcs_address = self._spawn_native_gcs(gcs_bind, persist)
                self.gcs = GcsClient(self.gcs_address)
                self.gcs_server = None
        else:
            if gcs_address is None:
                raise ValueError("worker nodes need gcs_address "
                                 "(the head's gcs.sock path)")
            self.gcs = GcsClient(gcs_address)
            self.gcs_server = None
            self.gcs_address = gcs_address
        self._sync_cluster_flags()
        # The store daemon spawns AFTER the GCS flag sync so a joining
        # node's transfer plane is token-authed with the head's cluster
        # token (the token rides the propagated flags for local nodes).
        self.store_server = StoreServer(
            socket_path=os.path.join(self.session_dir, "store.sock"),
            shm_name=shm_name,
            capacity=capacity,
            # memory pressure spills sealed objects to disk instead of
            # dropping them (reference: object spilling, SURVEY §2.1)
            spill_dir=os.path.join(self.session_dir, "spill"),
            # daemon-to-daemon transfer plane: TCP clusters bind the
            # node's interface; local (unix) clusters use loopback so
            # in-process multi-node tests exercise the native path too
            xfer_host=self.listen_host or "127.0.0.1",
            cluster_token=_cluster_token_or_empty(),
        )
        self.scheduler = Scheduler(
            socket_path=sched_socket,
            store_socket=self.store_server.socket_path,
            shm_name=shm_name,
            store_capacity=capacity,
            gcs=self.gcs,
            gcs_address=self.gcs_address,
            node_resources=merged,
            min_workers=min_workers,
            # None = size from CPUs; an EXPLICIT 0 means no real workers
            # (scale harness / driver-only nodes), never the default
            max_workers=(max(4, int(merged.get("CPU", 4)) * 2)
                         if max_workers is None else max_workers),
            node_id=self.node_id,
            is_head=head,
            labels=self.labels,
        )
        # Register AFTER the scheduler binds: with TCP the advertised
        # address carries the kernel-assigned port.
        self.sched_address = self.scheduler.socket_path
        xfer_addr = ""
        if self.store_server.xfer_port:
            xfer_addr = (f"{self.store_server.xfer_host}:"
                         f"{self.store_server.xfer_port}")
        self.gcs.register_node(NodeInfo(
            self.node_id, resources=dict(merged), is_head=head,
            sched_socket=self.sched_address,
            store_socket=self.store_server.socket_path,
            xfer_addr=xfer_addr,
            labels=self.labels))
        # Store-daemon supervision (tentpole of the store-plane robustness
        # work): the daemon is the node's one unsupervised single point of
        # failure — watch it and turn a crash into a recoverable incident.
        self._store_sup_stop = threading.Event()
        self._store_sup = threading.Thread(
            target=self._supervise_store, name="store-supervisor",
            daemon=True)
        self._store_sup.start()
        if head:
            # Job submission lives on the head (reference: JobManager in the
            # dashboard head process, dashboard/modules/job/job_manager.py).
            from ray_tpu_torch._private.job_manager import JobManager

            self.scheduler.job_manager = JobManager(
                self.gcs, self.gcs_address, self.session_dir)
            # restored PENDING/RUNNING jobs lost their supervisor with
            # the previous head process: record the truth
            self.scheduler.job_manager.reconcile()
            # Persisted-GCS recovery: re-create actors restored as
            # RESTARTING (no-op on a fresh control plane).
            self.scheduler.recover_restored_actors()
        # Structured event export for external consumers (reference:
        # export_event_logger.py); enabled by RTPU_EXPORT_EVENTS.  Every
        # node exports its own task events; the head also subscribes to
        # the GCS actor/node channels (once, cluster-wide).
        from ray_tpu_torch.util.events import start_exporter

        self._event_exporter = start_exporter(self.gcs_address,
                                              subscribe=head)
        # per-scheduler wiring: in-process multi-node clusters must not
        # share (or hijack) one process-global exporter
        self.scheduler._event_exporter = self._event_exporter
        # metrics_snapshot threads the store daemon's incarnation through
        # as the counter-reset generation for cumulative store_* gauges
        self.scheduler._store_server = self.store_server
        self.dashboard = None
        self.dashboard_url = None
        if head and include_dashboard and not os.environ.get(
                "RTPU_DISABLE_DASHBOARD"):
            try:
                from ray_tpu_torch.dashboard import DashboardHead

                self.dashboard = DashboardHead(self.gcs, self.sched_address)
                self.dashboard_url = self.dashboard.url
                if self.dashboard_url:
                    self.gcs.kv_put("dashboard", b"url",
                                    self.dashboard_url.encode())
            except Exception:
                self.dashboard = None  # aiohttp missing / port exhaustion

    def _supervise_store(self):
        """Watch the store daemon process; on unexpected exit, recover.

        Recovery order matters: the node's object-directory entries are
        dropped FIRST (single-copy objects tombstone as LOST, so blocked
        getters reconstruct via lineage instead of waiting on a store
        that restarted empty), then the daemon is respawned on the same
        socket/shm name with a bumped incarnation, the node re-registers
        its new transfer-plane address, and the incident is recorded in
        the GCS KV.  Clients ride through the gap via their
        reconnect-with-backoff (RTPU_STORE_RETRY_S).
        """
        while not self._store_sup_stop.wait(0.2):
            rc = self.store_server.poll()
            if rc is None:
                continue
            if self._store_sup_stop.is_set():
                return
            try:
                self.gcs.drop_node_objects(self.node_id)
            except Exception:
                pass  # head gone / restarting; tombstoning is best-effort
            try:
                if not self.store_server.restart():
                    continue
            except Exception:
                # respawn failed (fd exhaustion, shm pressure): next tick
                # retries rather than abandoning the plane
                time.sleep(1.0)
                continue
            try:
                _store_restart_counter().inc()
            except Exception:
                pass  # observability must never block recovery
            try:
                # straight into this node's bank — the supervisor thread
                # has no worker context for the emit() flusher to use
                self.scheduler.bank_events([{
                    "kind": "store.daemon_restart", "severity": "error",
                    "message": (f"store daemon exited rc={rc}; respawned "
                                f"as incarnation "
                                f"{self.store_server.incarnation}"),
                    "data": {"exit_code": rc,
                             "incarnation": self.store_server.incarnation},
                }])
            except Exception:
                pass
            xfer_addr = ""
            if self.store_server.xfer_port:
                xfer_addr = (f"{self.store_server.xfer_host}:"
                             f"{self.store_server.xfer_port}")
            try:
                # upsert: peers learn the NEW transfer-plane port
                self.gcs.register_node(NodeInfo(
                    self.node_id, resources=dict(self.resources),
                    is_head=self.is_head, sched_socket=self.sched_address,
                    store_socket=self.store_server.socket_path,
                    xfer_addr=xfer_addr, labels=self.labels))
            except Exception:
                pass
            try:
                from ray_tpu_torch._private import wire

                self.gcs.kv_put(
                    "incidents",
                    b"store_restart:" + self.node_id.hex().encode(),
                    wire.encode({
                        "node_id": self.node_id,
                        "exit_code": rc,
                        "incarnation": self.store_server.incarnation,
                        "ts": time.time(),
                    }))
            except Exception:
                pass

    def _sync_cluster_flags(self):
        """Flag propagation (reference: ray.init _system_config serialized
        to every raylet; SURVEY §5 config/flag system).  The head publishes
        its explicitly-set registry flags to the GCS; joining nodes adopt
        them into the environment (local settings win), so worker processes
        cluster-wide see one effective config.  `rtpu status` dumps it."""
        from ray_tpu_torch._private import flags, wire

        try:
            if self.is_head:
                self.gcs.kv_put("config", b"flags",
                                wire.encode(flags.explicit()))
            else:
                blob = self.gcs.kv_get("config", b"flags")
                if blob:
                    for k, v in wire.decode(blob).items():
                        if k in flags.FLAGS:
                            os.environ.setdefault(k, v)
        except Exception:
            pass  # config sync is best-effort; defaults still apply

    def _spawn_native_gcs(self, bind: str, persist: Optional[str]) -> str:
        """Start the C++ GCS daemon; returns its connectable address."""
        import subprocess

        from ray_tpu_torch._private.gcs import NODE_DEATH_TIMEOUT_S
        from ray_tpu_torch._private.protocol import advertised_host, is_tcp_addr
        from ray_tpu_torch.native.build import binary_path

        adv = os.path.join(self.session_dir, "gcs.advertise")
        cmd = [binary_path("gcs_server"), "--bind", bind,
               "--advertise-file", adv,
               "--death-timeout-s", str(NODE_DEATH_TIMEOUT_S),
               "--parent-pid", str(os.getpid())]
        if persist:
            cmd += ["--persist", persist]
        log = open(os.path.join(self.session_dir, "gcs_server.err"), "ab")
        try:
            self._gcs_proc = subprocess.Popen(
                cmd, stdout=log, stderr=log, close_fds=True)
        finally:
            log.close()
        deadline = time.time() + 15.0
        while time.time() < deadline:
            if os.path.exists(adv):
                addr = open(adv).read().strip()
                if addr:
                    if is_tcp_addr(addr):
                        # daemon reports its bound port; rewrite a wildcard
                        # bind host into something peers can dial
                        host, _, port = addr.rpartition(":")
                        addr = f"{advertised_host(host)}:{port}"
                    return addr
            if self._gcs_proc.poll() is not None:
                raise RuntimeError(
                    "native GCS daemon exited at startup (see "
                    f"{self.session_dir}/gcs_server.err); set "
                    "RTPU_PYTHON_GCS=1 to fall back to the Python GCS")
            time.sleep(0.02)
        raise RuntimeError("native GCS daemon did not come up in 15s")

    def new_store_client(self) -> StoreClient:
        return StoreClient(
            self.store_server.socket_path,
            self.store_server.shm_name,
            self.store_server.capacity,
        )

    def shutdown(self):
        # stop supervision FIRST: an intentional store shutdown must not
        # race a supervised restart
        sup_stop = getattr(self, "_store_sup_stop", None)
        if sup_stop is not None:
            sup_stop.set()
            self._store_sup.join(timeout=2)
        exporter = getattr(self, "_event_exporter", None)
        if exporter is not None:
            exporter.shutdown()
        jm = getattr(self.scheduler, "job_manager", None)
        if jm is not None:
            jm.shutdown()
        if self.dashboard is not None:
            self.dashboard.shutdown()
        if not self.is_head:
            # Attached (non-head) node leaving gracefully: tell the GCS now
            # instead of making peers wait out the heartbeat timeout.
            try:
                self.gcs.mark_node_dead(self.node_id)
            except Exception:
                pass  # head may already be gone
        self.scheduler.shutdown()
        self.store_server.shutdown()
        if self.gcs_server is not None:
            self.gcs_server.shutdown()
        if self._gcs_proc is not None:
            self._gcs_proc.terminate()
            try:
                self._gcs_proc.wait(timeout=5)
            except Exception:
                self._gcs_proc.kill()


def _default_store_capacity() -> int:
    try:
        import shutil

        free = shutil.disk_usage("/dev/shm").free
        from ray_tpu_torch._private import flags as flags_mod

        cap = flags_mod.get("RTPU_STORE_CAPACITY")
        return min(cap, max(1 << 28, int(free * 0.5)))
    except OSError:
        return 1 << 28
