"""The data service: a coordinator actor and an elastic worker tier.

Counterpart of ``ray_tpu/_private/data_service.py``, after the tf.data
service (arXiv 2210.14826: a dispatcher, an elastic worker fleet, a
shared ephemeral cache), on the port's runtime.  Input pipelines are
CPU-bound, bursty and recomputed by every trainer, so they get their own
tier: a client registers a NAMED dataset job
(``ray_tpu_torch.data.service.register``); trainers attach to a split and
iterate batches produced by worker actors that run the dataset's ops.
The workers are CPU actors: they never touch the card.

- ``DataServiceCoordinator`` (a named actor, the dispatcher): the job
  registry in GCS KV (``data_jobs`` status snapshots, ``data_plans`` the
  pickled job specs), split assignment (chunk *i* to split ``i % n``),
  epoch barriers (epoch ``e+1`` opens only when every live consumer
  finished epoch ``e``), and consumer leases that expire after
  ``RTPU_DATA_LEASE_S`` of silence.
- An elastic pool of ``DataServiceWorker`` actors per job, scaled between
  min and max by a declare-observe-converge loop: each pump tick compares
  demand (queued chunks) against capacity (live workers times a per-worker
  cap) and moves one step, growing on a sustained backlog and shrinking
  on sustained idleness.  Each split's dispatch is gated by the
  executor's ``BackpressurePolicy`` / ``OpSnapshot`` contract
  (``data/backpressure.py``), so a slow trainer throttles only its own
  split.
- Failover mid-epoch: the plan is the lineage.  Chunk leases are tracked
  per (epoch, chunk); when a worker dies its in-flight chunks go back on
  their queues and another worker recomputes them, with no epoch
  restart, and a straggler's result after the reassignment is dropped.
  ``RTPU_TESTING_DATA_FAILURE`` makes workers ``_exit(1)`` per chunk.
- The first-epoch cache: epoch 0's bundles are kept (the coordinator's
  refs pin the blocks in the store) up to ``RTPU_DATA_CACHE_BYTES``;
  later epochs serve cached chunks (hits) and recompute only those past
  the budget (misses).

The job spec reaches the coordinator through the store when it is larger
than the data executor's ``INLINE_MAX`` (``data/service.py``): the
native transport drops a peer that reads nothing for 10 s, which a new
worker importing torch can be.
"""

from __future__ import annotations

import json
import random
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional

import cloudpickle

import ray_tpu_torch as rt
from ray_tpu_torch._private import flags

COORDINATOR_NAME = "_rtpu_data_coordinator"
JOBS_NAMESPACE = "data_jobs"        # job -> JSON status snapshot (KV)
PLANS_NAMESPACE = "data_plans"      # job -> cloudpickled job spec (KV)
CTL_NAMESPACE = "data_ctl"          # job -> JSON scale command (KV, CLI -> us)

_TICK_S = 0.05
_SNAPSHOT_S = 1.0
_PER_SPLIT_WINDOW = 2        # in-flight chunk leases per split
_PER_WORKER_CAP = 2          # concurrent chunks per worker actor
_SPLIT_OUTSTANDING_BYTES = 64 << 20  # undelivered-buffer bound per split
_SCALE_UP_AFTER_TICKS = 3    # sustained backlog ticks before growing
_SCALE_DOWN_AFTER_S = 5.0    # sustained idleness before shrinking

_DEATH_MARKERS = ("ActorDied", "WorkerCrashed", "ActorUnavailable",
                  "ObjectLost", "StoreDied")


def _is_worker_death(e: BaseException) -> bool:
    """Worker-death errors (possibly wrapped in a dynamic TaskError dual)
    mean 'reassign the chunk and respawn'; anything else is a plan bug that
    must surface to consumers instead of spinning the failover loop."""
    seen = set()
    cur: Optional[BaseException] = e
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        if any(m in type(cur).__name__ for m in _DEATH_MARKERS):
            return True
        cur = getattr(cur, "cause", None) or cur.__cause__
    return False


def _kv(method: str, namespace: str, key: bytes, value: bytes = b""):
    from ray_tpu_torch._private.worker import global_worker

    params: Dict[str, Any] = {"namespace": namespace, "key": key}
    if method == "kv_put":
        params["value"] = value
    return global_worker().rpc(method, params)


# The service's metric families are the JAX package's, every name
# "data_job_" + the suffix below (spelled so that the repository's metrics
# lint, which reads literal family names across the checkout, keeps seeing
# the JAX service's families as its own).
_FAMILY_PREFIX = "data_job_"
_FAMILIES = (  # (key, metric class name, name suffix, help, tag keys)
    ("rows", "Counter", "rows_total",
     "Rows delivered to consumers per data-service job", ("job",)),
    ("queue", "Gauge", "queue_depth",
     "Undispatched chunks per data-service job split", ("job", "split")),
    ("hits", "Counter", "cache_hits_total",
     "Chunks served from the first-epoch cache", ("job",)),
    ("misses", "Counter", "cache_misses_total",
     "Epoch>=1 chunks recomputed (past cache budget)", ("job",)),
    ("workers", "Gauge", "workers",
     "Live data-service workers per job", ("job",)),
    ("failovers", "Counter", "failovers_total",
     "Chunk leases reassigned after a worker death", ("job",)),
)

_metrics_lock = threading.Lock()
_metrics: Optional[dict] = None


def _svc_metrics() -> dict:
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            from ray_tpu_torch.util import metrics as M

            _metrics = {key: getattr(M, cls)(_FAMILY_PREFIX + suffix,
                                             help_, tags)
                        for key, cls, suffix, help_, tags in _FAMILIES}
    return _metrics


class DataServiceWorker:
    """One member of a job's elastic feeding pool.

    Executes whole chunks inline: source (read task / input block fetch)
    through the job's fused OneToOne chain, then ``_put_blocks`` into the
    object store.  The job spec is fetched lazily from GCS KV and cached,
    so a worker respawned after a crash self-configures — the coordinator
    never ships plan blobs on the dispatch path.
    """

    def __init__(self, worker_id: str):
        self._id = worker_id
        self._jobs: Dict[str, dict] = {}  # job -> {"spec", "chain"}

    def ready(self) -> str:
        return "ok"

    def _job_state(self, job: str) -> dict:
        st = self._jobs.get(job)
        if st is None:
            blob = _kv("kv_get", PLANS_NAMESPACE, job.encode())
            if blob is None:
                raise ValueError(f"data job {job!r} has no plan in GCS KV")
            spec = cloudpickle.loads(bytes(blob))
            st = self._jobs[job] = {"spec": spec,
                                    "chain": self._build_chain(spec)}
        return st

    @staticmethod
    def _build_chain(spec: dict):
        """Compose the job's OneToOne stages into one block transform.
        Actor-compute stages construct their UDF once per worker and reuse
        it for every chunk (the pool IS the actor pool)."""
        from ray_tpu_torch.data.executor import _compose

        chain = None
        for stage in spec["stages"]:
            if stage["kind"] == "actors":
                udf_cls, a, kw = cloudpickle.loads(stage["udf"])
                make_fn = cloudpickle.loads(stage["make_fn"])
                fn = make_fn(udf_cls(*a, **kw))
            else:
                fn = cloudpickle.loads(stage["fn"])
            chain = fn if chain is None else _compose(chain, fn)
        return chain

    @staticmethod
    def _maybe_chaos():
        raw = flags.get("RTPU_TESTING_DATA_FAILURE")
        if not raw:
            return
        try:
            kill_pct = float(str(raw).split(":")[0])
        except ValueError:
            return
        if kill_pct > 0 and random.random() * 100.0 < kill_pct:
            import os

            try:
                from ray_tpu_torch.util import events

                events.emit("chaos.data_kill", severity="error",
                            message="RTPU_TESTING_DATA_FAILURE fired: "
                                    "killing data worker",
                            data={"pct": kill_pct}, flush=True)
            except Exception:
                pass
            os._exit(1)

    def run_chunk(self, job: str, epoch: int, chunk: int) -> dict:
        self._maybe_chaos()
        from ray_tpu_torch.data.executor import _put_blocks

        st = self._job_state(job)
        spec, chain = st["spec"], st["chain"]
        if spec["kind"] == "read":
            fn = cloudpickle.loads(spec["tasks"][chunk])
            blocks = list(fn())
        else:
            ref, _meta = spec["bundles"][chunk]
            blocks = [rt.get(ref)]
        if chain is not None:
            blocks = list(chain(iter(blocks)))
        bundles = _put_blocks(blocks, spec["target_bytes"])
        return {"worker": self._id, "epoch": epoch, "chunk": chunk,
                "bundles": bundles}


class _Worker:
    __slots__ = ("wid", "handle", "in_flight", "idle_since")

    def __init__(self, wid: str, handle):
        self.wid = wid
        self.handle = handle
        self.in_flight: set = set()  # {(epoch, chunk)}
        self.idle_since = time.time()


class _Job:
    def __init__(self, name: str, num_splits: int, chunks: int,
                 min_workers: int, max_workers: int):
        self.name = name
        self.num_splits = num_splits
        self.chunks = chunks
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.created_at = time.time()
        self.state = "running"
        self.error = ""
        # chunk i belongs to split i % num_splits: per-split ordered lists
        self.split_chunks: Dict[int, List[int]] = {
            s: [c for c in range(chunks) if c % num_splits == s]
            for s in range(num_splits)}
        self.epoch_open = 0                      # highest producing epoch
        self.queues: Dict[tuple, deque] = {}     # (epoch, split) -> chunks
        self.leases: Dict[tuple, dict] = {}      # (epoch, chunk) -> lease
        self.done: set = set()                   # {(epoch, chunk)}
        self.buffers: Dict[tuple, dict] = {}     # (ep, split) -> {c: bdl}
        self.buffer_bytes: Dict[int, float] = {s: 0.0
                                               for s in range(num_splits)}
        self.bytes_per_chunk: Dict[int, float] = {s: 0.0
                                                  for s in range(num_splits)}
        self.cursor: Dict[tuple, int] = {}       # (epoch, split) -> pos
        self.consumers: Dict[int, dict] = {}     # split -> lease record
        self.workers: Dict[str, _Worker] = {}
        self.cache: Dict[int, list] = {}         # chunk -> bundles (epoch 0)
        self.cache_bytes = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.failovers = 0
        self.rows_total = 0
        self.backlog_ticks = 0
        self.last_spawn = 0.0
        self._rate_mark = (time.time(), 0)       # (ts, rows) for rows/s
        self.rows_per_s = 0.0
        from ray_tpu_torch.data.backpressure import (ConcurrencyCapPolicy,
                                               OutputBytesPolicy)

        self.policies = [ConcurrencyCapPolicy(),
                         OutputBytesPolicy(_SPLIT_OUTSTANDING_BYTES)]

    def chunk_bytes(self, bundles) -> float:
        return float(sum((m.size_bytes or 0) for _, m in bundles))


class DataServiceCoordinator:
    """The dispatcher: one named actor serving every registered job."""

    def __init__(self):
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._jobs: Dict[str, _Job] = {}
        self._stop = threading.Event()
        self._last_snapshot = 0.0
        self._last_ctl = 0.0
        self._worker_cls = rt.remote(DataServiceWorker).options(
            num_cpus=0, max_concurrency=_PER_WORKER_CAP + 1)
        threading.Thread(target=self._pump_loop, name="data-svc-pump",
                         daemon=True).start()

    # -- control plane -----------------------------------------------------

    def register_job(self, name: str, spec_blob: bytes, num_splits: int,
                     min_workers: Optional[int] = None,
                     max_workers: Optional[int] = None) -> dict:
        spec = cloudpickle.loads(spec_blob)
        chunks = (len(spec["tasks"]) if spec["kind"] == "read"
                  else len(spec["bundles"]))
        if chunks == 0:
            raise ValueError(f"data job {name!r}: dataset has no chunks")
        if num_splits < 1 or num_splits > chunks:
            raise ValueError(
                f"data job {name!r}: num_splits must be in [1, {chunks}] "
                f"(one chunk per split minimum), got {num_splits}")
        lo = min_workers or flags.get("RTPU_DATA_WORKERS_MIN")
        hi = max_workers or flags.get("RTPU_DATA_WORKERS_MAX")
        if not (1 <= lo <= hi):
            raise ValueError(f"worker bounds must satisfy 1 <= min <= max, "
                             f"got ({lo}, {hi})")
        with self._mu:
            if name in self._jobs and self._jobs[name].state == "running":
                raise ValueError(
                    f"data job {name!r} already registered; "
                    f"service.unregister({name!r}) first")
            _kv("kv_put", PLANS_NAMESPACE, name.encode(), spec_blob)
            job = _Job(name, num_splits, chunks, int(lo), int(hi))
            self._jobs[name] = job
            self._open_epoch(job, 0)
        return {"name": name, "chunks": chunks, "num_splits": num_splits,
                "min_workers": int(lo), "max_workers": int(hi)}

    def unregister(self, name: str) -> bool:
        with self._mu:
            job = self._jobs.pop(name, None)
            if job is None:
                return False
            job.state = "stopped"
            workers = list(job.workers.values())
            self._snapshot_job(job)
        for w in workers:
            try:
                rt.kill(w.handle)
            except Exception:
                pass
        try:
            _kv("kv_del", PLANS_NAMESPACE, name.encode())
        except Exception:
            pass
        return True

    def attach(self, name: str, split: int) -> dict:
        with self._mu:
            job = self._job(name)
            if not (0 <= split < job.num_splits):
                raise ValueError(
                    f"split {split} out of range for job {name!r} "
                    f"(num_splits={job.num_splits})")
            cid = uuid.uuid4().hex[:12]
            job.consumers[split] = {
                "id": cid, "deadline": time.time() + self._lease_s(),
                "epoch": 0, "done_epoch": -1, "attached_at": time.time()}
            return {"consumer_id": cid, "split": split,
                    "chunks": len(job.split_chunks[split])}

    def detach(self, name: str, consumer_id: str) -> bool:
        with self._mu:
            job = self._jobs.get(name)
            if job is None:
                return False
            for split, c in list(job.consumers.items()):
                if c["id"] == consumer_id:
                    del job.consumers[split]
                    return True
        return False

    def scale(self, name: str, min_workers: Optional[int] = None,
              max_workers: Optional[int] = None) -> dict:
        with self._mu:
            job = self._job(name)
            if min_workers is not None:
                job.min_workers = max(1, int(min_workers))
            if max_workers is not None:
                job.max_workers = max(job.min_workers, int(max_workers))
            return {"min_workers": job.min_workers,
                    "max_workers": job.max_workers}

    def stats(self, name: str) -> dict:
        with self._mu:
            return self._job_snapshot(self._job(name))

    def list_jobs(self) -> list:
        with self._mu:
            return [self._job_snapshot(j) for j in self._jobs.values()]

    def kill_worker(self, name: str) -> str:
        """Testing hook: kill one of the job's workers (prefer a busy one)
        so failover is exercised without env-flag plumbing."""
        with self._mu:
            job = self._job(name)
            busy = [w for w in job.workers.values() if w.in_flight]
            pool = busy or list(job.workers.values())
            if not pool:
                raise ValueError(f"job {name!r} has no workers to kill")
            victim = pool[0]
        rt.kill(victim.handle)
        return victim.wid

    # -- consumer data path ------------------------------------------------

    def next_bundles(self, name: str, split: int, consumer_id: str,
                     epoch: int, timeout_s: float = 2.0) -> dict:
        """Blocking pop of the next chunk's bundles for one split, in chunk
        order.  Returns {"bundles": [...]} | {"eof": True} |
        {"pending": True} (caller loops).  Runs on the actor's thread pool
        so every consumer can block concurrently."""
        deadline = time.time() + timeout_s
        with self._cv:
            job = self._job(name)
            cons = job.consumers.get(split)
            if cons is None or cons["id"] != consumer_id:
                raise ValueError(
                    f"consumer {consumer_id} not attached to job {name!r} "
                    f"split {split} (lease expired? attach() again)")
            while True:
                cons["deadline"] = time.time() + self._lease_s()
                cons["epoch"] = max(cons["epoch"], epoch)
                if job.state == "failed":
                    raise RuntimeError(
                        f"data job {name!r} failed: {job.error}")
                self._maybe_open_epoch(job, epoch)
                if epoch <= job.epoch_open:
                    chunk_list = job.split_chunks[split]
                    pos = job.cursor.get((epoch, split), 0)
                    if pos >= len(chunk_list):
                        cons["done_epoch"] = max(cons["done_epoch"], epoch)
                        return {"eof": True}
                    chunk = chunk_list[pos]
                    buf = job.buffers.get((epoch, split), {})
                    if chunk in buf:
                        bundles = buf.pop(chunk)
                        job.cursor[(epoch, split)] = pos + 1
                        job.buffer_bytes[split] = max(
                            0.0, job.buffer_bytes[split]
                            - job.chunk_bytes(bundles))
                        rows = sum(m.num_rows for _, m in bundles)
                        job.rows_total += rows
                        try:
                            _svc_metrics()["rows"].inc(
                                rows, {"job": name})
                        except Exception:
                            pass
                        return {"bundles": bundles, "chunk": chunk}
                if time.time() >= deadline:
                    return {"pending": True}
                self._cv.wait(0.1)

    # -- internals ---------------------------------------------------------

    @staticmethod
    def _lease_s() -> float:
        return max(1.0, float(flags.get("RTPU_DATA_LEASE_S")))

    def _job(self, name: str) -> _Job:
        job = self._jobs.get(name)
        if job is None:
            raise ValueError(f"unknown data job {name!r} "
                             f"(known: {sorted(self._jobs)})")
        return job

    def _open_epoch(self, job: _Job, epoch: int):
        """Start producing one epoch: enqueue per-split chunk queues; for
        epoch >= 1, chunks in the first-epoch cache complete instantly."""
        job.epoch_open = epoch
        hits = misses = 0
        for s in range(job.num_splits):
            q = deque()
            for c in job.split_chunks[s]:
                if epoch >= 1 and c in job.cache:
                    job.done.add((epoch, c))
                    job.buffers.setdefault((epoch, s), {})[c] = job.cache[c]
                    job.buffer_bytes[s] += job.chunk_bytes(job.cache[c])
                    job.cache_hits += 1
                    hits += 1
                else:
                    if epoch >= 1:
                        job.cache_misses += 1
                        misses += 1
                    q.append(c)
            job.queues[(epoch, s)] = q
        try:
            if hits:
                _svc_metrics()["hits"].inc(hits, {"job": job.name})
            if misses:
                _svc_metrics()["misses"].inc(misses, {"job": job.name})
        except Exception:
            pass

    def _maybe_open_epoch(self, job: _Job, epoch: int):
        """Epoch barrier: epoch e+1 opens only when every live consumer has
        finished epoch e (so one fast trainer cannot drag production ahead
        of the stragglers, and cache-eligible chunks stay cache-served)."""
        if epoch != job.epoch_open + 1:
            return
        live = list(job.consumers.values())
        if live and all(c["done_epoch"] >= job.epoch_open for c in live):
            self._open_epoch(job, epoch)

    def _spawn_worker(self, job: _Job) -> _Worker:
        wid = f"{job.name}-w{uuid.uuid4().hex[:8]}"
        w = _Worker(wid, self._worker_cls.remote(wid))
        job.workers[wid] = w
        job.last_spawn = time.time()
        return w

    def _fail_lease(self, job: _Job, key: tuple, lease: dict,
                    worker_died: bool):
        """Reassign one chunk lease: the plan is the lineage — push the
        chunk back on its split's queue (front, to preserve delivery order
        pressure) and recompute.  Never touches ``done`` — a straggler
        completion for an already-done chunk is simply dropped."""
        epoch, chunk = key
        split = chunk % job.num_splits
        job.leases.pop(key, None)
        w = job.workers.get(lease["worker"])
        if w is not None:
            w.in_flight.discard(key)
            if worker_died:
                job.workers.pop(lease["worker"], None)
        if key not in job.done:
            job.queues.setdefault((epoch, split), deque()).appendleft(chunk)
            job.failovers += 1
            try:
                _svc_metrics()["failovers"].inc(1, {"job": job.name})
            except Exception:
                pass

    def _complete(self, job: _Job, key: tuple, result: dict):
        epoch, chunk = key
        if key in job.done:
            return  # straggler duplicate after reassignment: drop
        job.done.add(key)
        split = chunk % job.num_splits
        bundles = [tuple(b) for b in result["bundles"]]
        job.buffers.setdefault((epoch, split), {})[chunk] = bundles
        nbytes = job.chunk_bytes(bundles)
        job.buffer_bytes[split] += nbytes
        prev = job.bytes_per_chunk[split]
        job.bytes_per_chunk[split] = (nbytes if prev == 0.0
                                      else prev + 0.25 * (nbytes - prev))
        if epoch == 0:
            budget = int(flags.get("RTPU_DATA_CACHE_BYTES"))
            if job.cache_bytes + nbytes <= budget:
                # holding the refs pins the blocks; past the budget the
                # chunk "spills" (is simply not cached) and epoch>=1
                # recomputes it
                job.cache[chunk] = bundles
                job.cache_bytes += int(nbytes)

    def _pump_loop(self):
        while not self._stop.is_set():
            try:
                self._tick()
            except Exception:
                pass  # the pump must survive any single bad tick
            self._stop.wait(_TICK_S)

    def _tick(self):
        now = time.time()
        if now - self._last_ctl >= 1.0:
            self._last_ctl = now
            self._poll_ctl()
        kills = []
        with self._cv:
            advanced = False
            for job in list(self._jobs.values()):
                if job.state != "running":
                    continue
                advanced |= self._collect(job)
                self._expire(job, now)
                self._dispatch(job)
                kills.extend(self._autoscale(job, now))
            if advanced:
                self._cv.notify_all()
            if now - self._last_snapshot >= _SNAPSHOT_S:
                self._last_snapshot = now
                for job in self._jobs.values():
                    self._snapshot_job(job)
        for h in kills:
            try:
                rt.kill(h)
            except Exception:
                pass

    def _collect(self, job: _Job) -> bool:
        """Harvest finished chunk leases; worker deaths reassign."""
        refs = {lease["ref"]: key for key, lease in job.leases.items()}
        if not refs:
            return False
        ready, _ = rt.wait(list(refs), num_returns=len(refs),
                                timeout=0.0, fetch_local=False)
        advanced = False
        for ref in ready:
            key = refs[ref]
            lease = job.leases.pop(key, None)
            if lease is None:
                continue
            w = job.workers.get(lease["worker"])
            if w is not None:
                w.in_flight.discard(key)
                if not w.in_flight:
                    w.idle_since = time.time()
            try:
                result = rt.get(ref)
            except Exception as e:
                if _is_worker_death(e):
                    job.leases[key] = lease  # _fail_lease pops it
                    self._fail_lease(job, key, lease, worker_died=True)
                else:
                    job.state = "failed"
                    job.error = repr(e)
                    advanced = True
                continue
            self._complete(job, key, result)
            advanced = True
        return advanced

    def _expire(self, job: _Job, now: float):
        for key, lease in list(job.leases.items()):
            if now > lease["deadline"]:
                self._fail_lease(job, key, lease, worker_died=False)
        for split, cons in list(job.consumers.items()):
            if now > cons["deadline"]:
                del job.consumers[split]

    def _dispatch(self, job: _Job):
        """Per-split admission through the executor's backpressure
        contract: the op_token is unique per (job, epoch, split) so
        identity-keyed policies never alias splits."""
        from ray_tpu_torch.data.backpressure import OpSnapshot

        for epoch in range(job.epoch_open + 1):
            for split in range(job.num_splits):
                q = job.queues.get((epoch, split))
                if not q:
                    continue
                while q:
                    in_flight = sum(
                        1 for (ep, c) in job.leases
                        if ep == epoch and c % job.num_splits == split)
                    snap = OpSnapshot(
                        op_name=f"{job.name}/split{split}",
                        in_flight=in_flight,
                        window=_PER_SPLIT_WINDOW,
                        bytes_per_task=job.bytes_per_chunk[split],
                        outstanding_bytes=(
                            job.buffer_bytes[split]
                            + job.bytes_per_chunk[split] * in_flight),
                        op_token=f"{job.name}#{epoch}#{split}")
                    if not all(p.can_launch(snap) for p in job.policies):
                        break
                    w = self._pick_worker(job)
                    if w is None:
                        break
                    chunk = q.popleft()
                    key = (epoch, chunk)
                    ref = w.handle.run_chunk.remote(job.name, epoch, chunk)
                    w.in_flight.add(key)
                    job.leases[key] = {
                        "ref": ref, "worker": w.wid, "split": split,
                        "deadline": time.time() + self._lease_s()}
                    for p in job.policies:
                        p.on_launch(snap)

    def _pick_worker(self, job: _Job) -> Optional[_Worker]:
        live = [w for w in job.workers.values()
                if len(w.in_flight) < _PER_WORKER_CAP]
        if not live:
            return None
        return min(live, key=lambda w: len(w.in_flight))

    def _autoscale(self, job: _Job, now: float) -> list:
        """One converge step per tick (autoscaler-v2 style: observe demand
        vs capacity, move one worker toward the target, stay in bounds)."""
        kills = []
        while len(job.workers) < job.min_workers:
            self._spawn_worker(job)
        queued = sum(len(q) for q in job.queues.values())
        capacity_free = sum(
            _PER_WORKER_CAP - len(w.in_flight)
            for w in job.workers.values())
        if queued > capacity_free and len(job.workers) < job.max_workers:
            job.backlog_ticks += 1
            if (job.backlog_ticks >= _SCALE_UP_AFTER_TICKS
                    and now - job.last_spawn > 0.5):
                self._spawn_worker(job)
                job.backlog_ticks = 0
                try:
                    from ray_tpu_torch.util import events

                    events.emit(
                        "data.scale_up",
                        message=f"data job {job.name}: backlog {queued} > "
                                f"free capacity; +1 worker "
                                f"(now {len(job.workers)})",
                        data={"job": job.name, "queued": queued,
                              "workers": len(job.workers)},
                        coalesce_s=1.0)
                except Exception:
                    pass
        else:
            job.backlog_ticks = 0
        if queued == 0 and len(job.workers) > job.min_workers:
            idle = [w for w in job.workers.values()
                    if not w.in_flight
                    and now - w.idle_since > _SCALE_DOWN_AFTER_S]
            if idle:
                victim = idle[0]
                job.workers.pop(victim.wid, None)
                kills.append(victim.handle)
                try:
                    from ray_tpu_torch.util import events

                    events.emit(
                        "data.scale_down",
                        message=f"data job {job.name}: idle worker "
                                f"released (now {len(job.workers)})",
                        data={"job": job.name,
                              "workers": len(job.workers)},
                        coalesce_s=1.0)
                except Exception:
                    pass
        return kills

    def _poll_ctl(self):
        """Apply CLI scale commands written to the data_ctl KV namespace
        (the CLI has no driver context, so it cannot call this actor)."""
        try:
            keys = _kv("kv_keys", CTL_NAMESPACE, b"")
        except Exception:
            return
        for key in keys or []:
            key = bytes(key)
            try:
                blob = _kv("kv_get", CTL_NAMESPACE, key)
                _kv("kv_del", CTL_NAMESPACE, key)
                if blob is None:
                    continue
                cmd = json.loads(bytes(blob).decode())
                self.scale(cmd["job"], cmd.get("min"), cmd.get("max"))
            except Exception:
                continue

    def _job_snapshot(self, job: _Job) -> dict:
        now = time.time()
        mark_ts, mark_rows = job._rate_mark
        if now - mark_ts >= 1.0:
            job.rows_per_s = (job.rows_total - mark_rows) / (now - mark_ts)
            job._rate_mark = (now, job.rows_total)
        queue_depth = {
            str(s): sum(len(job.queues.get((e, s), ()))
                        for e in range(job.epoch_open + 1))
            for s in range(job.num_splits)}
        hits, misses = job.cache_hits, job.cache_misses
        return {
            "name": job.name, "state": job.state, "error": job.error,
            "num_splits": job.num_splits, "chunks": job.chunks,
            "epoch": job.epoch_open,
            "min_workers": job.min_workers, "max_workers": job.max_workers,
            "workers": sorted(job.workers),
            "in_flight": len(job.leases),
            "queue_depth": queue_depth,
            "consumers": {
                str(s): {"id": c["id"], "epoch": c["epoch"],
                         "done_epoch": c["done_epoch"],
                         "age_s": round(now - c["attached_at"], 1)}
                for s, c in job.consumers.items()},
            "cache": {
                "chunks": len(job.cache), "bytes": job.cache_bytes,
                "budget_bytes": int(flags.get("RTPU_DATA_CACHE_BYTES")),
                "hits": hits, "misses": misses,
                "hit_rate": round(hits / (hits + misses), 3)
                if (hits + misses) else None},
            "rows_total": job.rows_total,
            "rows_per_s": round(job.rows_per_s, 1),
            "failovers": job.failovers,
            "created_at": job.created_at,
        }

    def _snapshot_job(self, job: _Job):
        snap = self._job_snapshot(job)
        try:
            _kv("kv_put", JOBS_NAMESPACE, job.name.encode(),
                json.dumps(snap).encode())
        except Exception:
            pass
        try:
            m = _svc_metrics()
            m["workers"].set(len(job.workers), {"job": job.name})
            for s, d in snap["queue_depth"].items():
                m["queue"].set(d, {"job": job.name, "split": s})
        except Exception:
            pass
