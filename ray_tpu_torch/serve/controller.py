"""ServeController: the control-plane actor for applications/deployments.

Counterpart of ``ray_tpu/serve/controller.py``, the reference's controller
+ deployment state machines (Ray's python/ray/serve/_private/controller.py:87 ServeController,
deployment_state.py:1360 DeploymentState / :2469 DeploymentStateManager,
autoscaling_state.py:81): holds target state per deployment, runs a
reconcile thread (spawn/stop replica actors, replace dead or unhealthy
ones), an autoscaler on replica queue lengths (+ handle-reported pressure
for scale-from-zero), and bumps a version number that handles/proxies watch
(the reference's LongPollHost broadcast, here a condition variable served
over a high-concurrency actor method).

Concurrency notes: actor methods (deploy/delete) run on the actor's thread
pool concurrently with the reconcile daemon thread — `_lock` guards all
state mutation; the blocking replica-ready wait happens OUTSIDE the lock and
re-checks deployment generation before tracking the new replica (a replica
spawned for a deleted/redeployed generation is killed, not leaked).
Liveness comes from the GCS actor table, not from probing the replica's
(possibly saturated) request thread pool.  Replicas are actors of the
port's runtime started with the deployment's ``ray_actor_options``: a
replica asking ``num_gpus`` holds the card from its own process.
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch._private.worker import global_worker
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.replica import ReplicaActor


# The replica death counter is the JAX controller's family, named "serve_"
# + its suffix (spelled so for the metrics lint, as the replica's families
# are: ``serve/replica.py``).
_FAMILY_PREFIX = "serve_"
_DEATH_COUNTER = None


def _death_counter():
    """Lazy (the controller actor registers it on first replica death;
    idle control planes register nothing): the deterministic signal SLO
    death-rate rules key on."""
    global _DEATH_COUNTER
    if _DEATH_COUNTER is None:
        from ray_tpu_torch.util.metrics import Counter

        _DEATH_COUNTER = Counter(
            _FAMILY_PREFIX + "replica_deaths_total",
            description="Serve replicas observed dead and purged from "
                        "routing (controller _note_dead)",
            tag_keys=("app", "deployment"))
    return _DEATH_COUNTER


@dataclass
class _DeploymentState:
    name: str
    app_name: str
    cls_blob: bytes
    init_args_blob: bytes
    config: DeploymentConfig
    generation: int = 0
    target_replicas: int = 1
    replicas: List[Any] = field(default_factory=list)  # ActorHandles
    deleted: bool = False
    # replicas spawned but not yet ready: (handle, ready_ref, deadline)
    starting: List[Any] = field(default_factory=list)
    # replica-creation failure tracking (backoff + deploy-failed surface)
    failures: int = 0
    last_error: str = ""
    next_attempt: float = 0.0
    # autoscaling bookkeeping
    over_since: Optional[float] = None
    under_since: Optional[float] = None
    last_probe: float = 0.0
    last_loads: List[int] = field(default_factory=list)
    # (ts, total_load) samples for look-back smoothing
    load_history: Any = field(default_factory=deque)
    # scale-from-zero: handles report queued requests when no replicas
    pending_reports: float = 0.0
    pending_ts: float = 0.0
    # health checks
    health_failures: Dict[bytes, int] = field(default_factory=dict)
    last_health: float = 0.0
    # request-router stats plane: latest router_stats() sample
    # per replica, piggybacked onto get_replicas for handles
    router_stats: Dict[bytes, Any] = field(default_factory=dict)
    last_router_poll: float = 0.0
    # replicas recently seen DEAD (rid, ts): piggybacked onto get_replicas
    # so handle routers purge the corpse's stats/prefix homes immediately
    # instead of waiting out RTPU_ROUTER_STALE_S
    dead_replicas: Any = field(default_factory=deque)
    # KV-tier replication throttle: family root hex -> last prehydrate ts
    kv_pushes: Dict[str, float] = field(default_factory=dict)


@dataclass
class _AppState:
    name: str
    route_prefix: str
    ingress: str
    http_method: str = "__call__"
    deployments: Dict[str, _DeploymentState] = field(default_factory=dict)
    status: str = "DEPLOYING"


def _engine_summary(engine: Optional[dict]) -> Optional[dict]:
    """Compact view of LLMEngine.stats() for the KV snapshot (full digests
    stay on the in-band handle path; the KV doc is for humans/CLI)."""
    if not engine:
        return None
    pc = engine.get("prefix_cache") or {}
    return {"active_slots": engine.get("active_slots"),
            "free_pages": engine.get("free_pages"),
            "resident_pages": engine.get("resident_pages"),
            "waiting": engine.get("waiting"),
            "preempted": engine.get("preempted"),
            "page_evictions": engine.get("page_evictions"),
            "prefix_hit_rate": pc.get("hit_rate"),
            "prefill_tokens_saved": engine.get("prefill_tokens_saved"),
            "cow_copies": engine.get("cow_copies"),
            "evictions_cold_family": pc.get("evictions_cold_family"),
            "evictions_hot_root_forced": pc.get("evictions_hot_root_forced"),
            "kv_seals": engine.get("kv_seals"),
            "kv_pulls": engine.get("kv_pulls"),
            "kv_pull_fallbacks": engine.get("kv_pull_fallbacks")}


def _actor_is_dead(handle) -> bool:
    try:
        state = global_worker().rpc("actor_state",
                                    {"actor_id": handle.actor_id})
        return state == "DEAD"
    except Exception:
        return False  # control-plane hiccup: do not treat as death


class ServeController:
    def __init__(self):
        self._apps: Dict[str, _AppState] = {}
        self._version = 0
        self._cond = threading.Condition()
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._http_port: Optional[int] = None
        self._reconcile_thread = threading.Thread(
            target=self._loop, daemon=True)
        self._reconcile_thread.start()

    # ------------------------- deploy API ---------------------------------

    def deploy_application(self, name: str, route_prefix: str,
                           ingress: str, deployments: List[dict]) -> str:
        http_method = "__call__"
        for spec in deployments:
            if spec["name"] == ingress:
                http_method = spec.get("http_method", "__call__")
        with self._lock:
            for other in self._apps.values():
                if other.name != name and other.route_prefix == route_prefix:
                    raise ValueError(
                        f"route_prefix {route_prefix!r} is already used by "
                        f"application {other.name!r} (reference Serve also "
                        f"rejects duplicate prefixes at deploy time)")
            old = self._apps.get(name)
            app = _AppState(name=name, route_prefix=route_prefix,
                            ingress=ingress, http_method=http_method)
            for spec in deployments:
                cfg: DeploymentConfig = cloudpickle.loads(spec["config"])
                prev = (old.deployments.get(spec["name"])
                        if old is not None else None)
                ds = _DeploymentState(
                    name=spec["name"], app_name=name,
                    cls_blob=spec["cls_blob"],
                    init_args_blob=spec["init_args_blob"], config=cfg,
                    generation=(prev.generation + 1 if prev else 0),
                    target_replicas=(cfg.autoscaling_config.min_replicas
                                     if cfg.autoscaling_config
                                     else cfg.num_replicas))
                app.deployments[ds.name] = ds
            self._apps[name] = app
            drained = []
            if old is not None:
                for ds in old.deployments.values():
                    ds.deleted = True
                    drained.extend(ds.replicas)
                    drained.extend(r for r, _, _ in ds.starting)
                    ds.replicas, ds.starting = [], []
        for r in drained:
            self._drain_and_kill(r, 0.0)  # old code, no graceful drain
        self._bump()
        return "ok"

    def delete_application(self, name: str) -> str:
        with self._lock:
            app = self._apps.pop(name, None)
            drained = []
            if app is not None:
                for ds in app.deployments.values():
                    ds.deleted = True
                    drained.extend(ds.replicas)
                    drained.extend(r for r, _, _ in ds.starting)
                    ds.replicas, ds.starting = [], []
        for r in drained:
            self._drain_and_kill(r, 0.0)
        if app is not None:
            self._bump()
        return "ok"

    def shutdown(self) -> str:
        self._stop.set()
        for name in list(self._apps):
            self.delete_application(name)
        return "ok"

    def set_http_port(self, port: int) -> str:
        self._http_port = port
        return "ok"

    def get_http_port(self) -> Optional[int]:
        return self._http_port

    # ------------------------- read API -----------------------------------

    def get_replicas(self, app_name: str, deployment: str) -> dict:
        now = time.monotonic()
        with self._lock:
            app = self._apps.get(app_name)
            ds = app.deployments.get(deployment) if app else None
            if ds is None:
                return {"replicas": [], "version": self._version}
            # piggyback the router-stats samples (queue depth, engine
            # page/prefix-cache stats); age_s lets the handle's router
            # measure staleness from COLLECTION time, not delivery
            stats = {rid: {**payload,
                           "age_s": max(0.0, now - payload.get("_ts", now))}
                     for rid, payload in ds.router_stats.items()}
            for payload in stats.values():
                payload.pop("_ts", None)
            return {"replicas": list(ds.replicas),
                    "version": self._version,
                    "policy": getattr(ds.config, "request_router_policy",
                                      "pow2") or "pow2",
                    "stats": stats,
                    # recent deaths (vs scale-downs): handles purge these
                    # from router stats/prefix homes on refresh
                    "dead": [rid for rid, ts in ds.dead_replicas
                             if now - ts <= self._DEAD_TTL_S]}

    def report_no_replica(self, app_name: str, deployment: str,
                          queued: int = 1) -> str:
        """Handles report queued requests against a zero-replica deployment
        so the autoscaler can scale from zero (reference: handle-side
        queue metrics feed autoscaling_state.py)."""
        with self._lock:
            app = self._apps.get(app_name)
            ds = app.deployments.get(deployment) if app else None
            if ds is not None:
                ds.pending_reports = float(queued)
                ds.pending_ts = time.monotonic()
        return "ok"

    def get_routing_table(self, known_version: int = -1,
                          timeout_s: float = 0.0) -> dict:
        """Long-poll when timeout_s > 0: blocks until version != known
        (reference: long_poll.py LongPollHost.listen_for_change)."""
        if timeout_s > 0:
            with self._cond:
                self._cond.wait_for(
                    lambda: self._version != known_version,
                    timeout=timeout_s)
        with self._lock:
            routes = {app.route_prefix: {"app": app.name,
                                         "ingress": app.ingress,
                                         "http_method": app.http_method,
                                         "status": app.status}
                      for app in self._apps.values()}
            return {"routes": routes, "version": self._version}

    def get_app_status(self, name: str) -> dict:
        with self._lock:
            app = self._apps.get(name)
            if app is None:
                return {"status": "NOT_FOUND"}
            detail = {}
            failed = False
            for ds in app.deployments.values():
                detail[ds.name] = {"target": ds.target_replicas,
                                   "running": len(ds.replicas),
                                   "failures": ds.failures,
                                   "last_error": ds.last_error}
                failed |= ds.failures >= 3
            status = "DEPLOY_FAILED" if failed else app.status
            return {"status": status, "deployments": detail}

    # ------------------------- reconcile loop ------------------------------

    def _bump(self):
        with self._cond:
            self._version += 1
            self._cond.notify_all()

    def _loop(self):
        while not self._stop.is_set():
            try:
                changed = False
                with self._lock:
                    snapshot = [(app, list(app.deployments.values()))
                                for app in self._apps.values()]
                for app, dss in snapshot:
                    for ds in dss:
                        changed |= self._reconcile(ds)
                        changed |= self._probe_and_autoscale(ds)
                        changed |= self._health_check(ds)
                        self._collect_router_stats(ds)
                    with self._lock:
                        # RUNNING requires the FULL target per deployment
                        # (reference: app is RUNNING when every deployment
                        # is HEALTHY at target), so serve.run returning
                        # means the whole replica set serves traffic
                        ready = all(
                            len(d.replicas) >= d.target_replicas
                            for d in app.deployments.values())
                        new_status = "RUNNING" if ready else "DEPLOYING"
                        if new_status != app.status:
                            app.status = new_status
                            changed = True
                if changed:
                    self._bump()
            except Exception:  # noqa: BLE001 — keep the loop alive
                traceback.print_exc()
            time.sleep(0.1)

    def _reconcile(self, ds: _DeploymentState) -> bool:
        changed = False
        # 1. drop replicas whose actor process died (GCS state, cheap and
        #    immune to a saturated replica thread pool)
        with self._lock:
            replicas = list(ds.replicas)
        dead = [r for r in replicas if _actor_is_dead(r)]
        if dead:
            with self._lock:
                ds.replicas = [r for r in ds.replicas if r not in dead]
                for r in dead:
                    ds.health_failures.pop(r.actor_id, None)
                    self._note_dead(ds, r.actor_id)
            changed = True
        # 2. poll replicas that are still starting (non-blocking — one slow
        #    init must not stall other deployments; the reference controller
        #    likewise starts replicas concurrently and polls readiness)
        now = time.monotonic()
        with self._lock:
            starting = list(ds.starting)
        for entry in starting:
            replica, ready_ref, deadline = entry
            ready, _ = ray_tpu_torch.wait([ready_ref], num_returns=1, timeout=0)
            if ready:
                with self._lock:
                    if entry not in ds.starting:
                        # a concurrent delete/redeploy drained this entry
                        # and owns killing its replica
                        continue
                    ds.starting.remove(entry)
                try:
                    ray_tpu_torch.get(ready_ref)
                except Exception as e:  # noqa: BLE001
                    self._note_failure(ds, e)
                    self._kill_quiet(replica)
                    continue
                with self._lock:
                    ds.failures = 0
                    ds.last_error = ""
                    if ds.deleted or len(ds.replicas) >= ds.target_replicas:
                        stale = True
                    else:
                        ds.replicas.append(replica)
                        stale = False
                        changed = True
                if stale:
                    self._kill_quiet(replica)
            elif now > deadline:
                with self._lock:
                    if entry not in ds.starting:
                        continue
                    ds.starting.remove(entry)
                self._note_failure(
                    ds, TimeoutError("replica start timed out"))
                self._kill_quiet(replica)
        # 3. spawn (without blocking) up to target, honoring the failure
        #    backoff.  get() on creation args happens on the worker side.
        with self._lock:
            # >=3 consecutive creation failures surfaces DEPLOY_FAILED
            # (get_application_status), but the spawn loop keeps retrying
            # on the capped backoff (30s once failing persistently): a
            # permanently broken deployment churns at most one worker
            # process per backoff period, while a previously healthy app
            # hit by transient failures self-heals without a redeploy
            # (reference Serve likewise never stops reconciling).
            want = (0 if ds.deleted or now < ds.next_attempt
                    else ds.target_replicas - len(ds.replicas)
                    - len(ds.starting))
            opts = dict(ds.config.ray_actor_options)
            opts.setdefault("max_concurrency",
                            ds.config.max_ongoing_requests)
        for _ in range(max(0, want)):
            replica = ray_tpu_torch.remote(ReplicaActor).options(**opts).remote(
                ds.cls_blob, ds.init_args_blob, ds.config.user_config,
                ds.app_name, ds.name)
            with self._lock:
                if ds.deleted:
                    # deleted between the `want` computation and now: the
                    # drain already ran, so this entry would never be
                    # polled again — kill instead of leaking the actor
                    stale_spawn = True
                else:
                    ds.starting.append((replica, replica.ready.remote(),
                                        now + 120.0))
                    stale_spawn = False
            if stale_spawn:
                self._kill_quiet(replica)
        # 3. scale down with graceful drain
        with self._lock:
            excess = []
            while len(ds.replicas) > ds.target_replicas:
                excess.append(ds.replicas.pop())
            grace = ds.config.graceful_shutdown_timeout_s
        for r in excess:
            self._drain_and_kill(r, grace)
            changed = True
        return changed

    def _collect_router_stats(self, ds: _DeploymentState) -> None:
        """Poll ReplicaActor.router_stats every ``RTPU_ROUTER_STATS_S``
        (the heartbeat lane of the request-router subsystem) and publish a
        JSON snapshot to the GCS KV so the CLI/dashboard/state planes can
        read routing state from any process."""
        import os

        period = float(os.environ.get("RTPU_ROUTER_STATS_S", "0.5"))
        now = time.monotonic()
        if now - ds.last_router_poll < period:
            return
        ds.last_router_poll = now
        with self._lock:
            replicas = list(ds.replicas)
        if not replicas:
            with self._lock:
                ds.router_stats = {}
            self._publish_router_stats(ds, {})
            return
        refs = [r.router_stats.remote() for r in replicas]
        ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=1.0)
        samples: Dict[bytes, Any] = {}
        for r, ref in zip(replicas, refs):
            if ref not in ready:
                continue  # saturated replica: keep the previous sample
            try:
                payload = ray_tpu_torch.get(ref)
            except Exception:  # noqa: BLE001 — stats lane must not throw
                continue
            payload["_ts"] = time.monotonic()
            samples[r.actor_id] = payload
        with self._lock:
            # retain prior samples for replicas that missed this round so
            # routers degrade to stale data (then ignore it) rather than
            # flapping between stats and none
            merged = {rid: p for rid, p in ds.router_stats.items()
                      if any(r.actor_id == rid for r in replicas)}
            merged.update(samples)
            ds.router_stats = merged
        self._publish_router_stats(ds, merged)
        self._replicate_kv(ds, merged)

    def _replicate_kv(self, ds: _DeploymentState,
                      samples: Dict[bytes, Any]) -> None:
        """KV-tier family replication: the engines' stats
        samples carry per-family heat rows (kv_families); each of the
        hottest families should be resident on ``RTPU_KV_REPLICAS``
        replicas, so a single replica death never takes a hot family's
        only warm copy.  Under-replicated families get a fire-and-forget
        kv_prehydrate on replicas missing them — the replica pulls the
        sealed spine from the store tier; replicas without a tier treat
        it as a no-op.  Throttled per family root."""
        import os

        want = int(os.environ.get("RTPU_KV_REPLICAS", "2") or 2)
        with self._lock:
            replicas = list(ds.replicas)
        if want <= 1 or len(replicas) < 2:
            return
        by_id = {r.actor_id: r for r in replicas}
        holders: Dict[str, set] = {}
        heat: Dict[str, int] = {}
        for rid, payload in samples.items():
            if rid not in by_id:
                continue
            engine = payload.get("engine") or {}
            if engine.get("kv_tier") is None:
                return  # deployment has no tier: nothing to replicate
            for row in engine.get("kv_families") or []:
                root = row.get("root")
                if not root:
                    continue
                holders.setdefault(root, set()).add(rid)
                heat[root] = max(heat.get(root, 0),
                                 int(row.get("hits") or 0))
        now = time.monotonic()
        goal = min(want, len(by_id))
        for root in sorted(heat, key=lambda r: -heat[r])[:8]:
            have = holders.get(root, set())
            if not have or len(have) >= goal:
                continue
            if now - ds.kv_pushes.get(root, 0.0) < 2.0:
                continue
            ds.kv_pushes[root] = now
            targets = [r for rid, r in by_id.items() if rid not in have]
            pushed = 0
            for r in targets[:goal - len(have)]:
                try:
                    r.kv_prehydrate.remote([root])
                    pushed += 1
                except Exception:  # noqa: BLE001 — replication is
                    pass           # best-effort durability, not liveness
            if pushed:
                try:
                    from ray_tpu_torch.util import events

                    # incident-plane record of the fan-out: the resulting
                    # kv.pull events on the target replicas correlate back
                    # to this push by family root
                    events.emit(
                        "kv.replicate",
                        message=f"replicating family {root[:12]} to "
                                f"{pushed} replica(s) "
                                f"({ds.app_name}/{ds.name})",
                        data={"root": root, "targets": pushed,
                              "deployment": ds.name,
                              "holders": len(have)},
                        coalesce_s=5.0)
                except Exception:  # noqa: BLE001
                    pass

    def _publish_router_stats(self, ds: _DeploymentState,
                              samples: Dict[bytes, Any]) -> None:
        import json

        now = time.monotonic()
        doc = {
            "app": ds.app_name,
            "deployment": ds.name,
            "policy": getattr(ds.config, "request_router_policy",
                              "pow2") or "pow2",
            "target_replicas": ds.target_replicas,
            "running_replicas": len(ds.replicas),
            "replicas": {
                (rid.hex() if isinstance(rid, bytes) else str(rid)): {
                    "queue_len": p.get("queue_len", 0),
                    "total": p.get("total", 0),
                    "age_s": round(max(0.0, now - p.get("_ts", now)), 3),
                    "engine": _engine_summary(p.get("engine")),
                }
                for rid, p in samples.items()},
        }
        try:
            global_worker().rpc("kv_put", {
                "namespace": "serve_routing",
                "key": f"{ds.app_name}/{ds.name}".encode(),
                "value": json.dumps(doc).encode()})
        except Exception:  # noqa: BLE001 — observability is best-effort
            pass

    def _note_failure(self, ds: _DeploymentState, exc: BaseException):
        # not always called from an except block (e.g. start timeouts), so
        # log the passed exception, not the (possibly absent) active one
        traceback.print_exception(type(exc), exc, exc.__traceback__)
        with self._lock:
            ds.failures += 1
            ds.last_error = repr(exc)
            ds.next_attempt = time.monotonic() + min(
                0.2 * (2 ** ds.failures), 30.0)

    def _kill_quiet(self, replica):
        try:
            ray_tpu_torch.kill(replica)
        except Exception:
            pass

    def _drain_and_kill(self, replica, grace_s: float):
        """Wait (async) for in-flight requests to finish, then kill
        (reference: replica graceful_shutdown loop)."""

        def drain():
            deadline = time.monotonic() + grace_s
            while time.monotonic() < deadline:
                try:
                    if ray_tpu_torch.get(replica.queue_len.remote(),
                                   timeout=5) == 0:
                        break
                except Exception:
                    break
                time.sleep(0.2)
            self._kill_quiet(replica)

        if grace_s <= 0:
            self._kill_quiet(replica)
        else:
            threading.Thread(target=drain, daemon=True).start()

    def _probe_and_autoscale(self, ds: _DeploymentState) -> bool:
        """One concurrent queue_len probe round per ~0.5s serves the
        autoscaler; saturated replicas that miss the probe deadline are
        counted at max_ongoing_requests (they are busy, not dead)."""
        ac = ds.config.autoscaling_config
        if ac is None:
            return False
        now = time.monotonic()
        if now - ds.last_probe < 0.5:
            return False
        ds.last_probe = now
        with self._lock:
            replicas = list(ds.replicas)
        if replicas:
            refs = [r.drain_peak_load.remote() for r in replicas]
            ready, not_ready = ray_tpu_torch.wait(
                refs, num_returns=len(refs), timeout=2.0)
            loads = []
            for ref in refs:
                if ref in ready:
                    try:
                        loads.append(ray_tpu_torch.get(ref))
                    except Exception:
                        loads.append(0)
                else:
                    loads.append(ds.config.max_ongoing_requests)
            total = float(sum(loads))
        else:
            total = 0.0
        # scale-from-zero pressure from handles (expires after 5s)
        if ds.pending_reports and now - ds.pending_ts < 5.0:
            total += ds.pending_reports
        # look-back smoothing: decide on the window PEAK so bursts shorter
        # than replica startup keep the target up until they're truly over
        look_back = getattr(ac, "look_back_period_s", 30.0)
        ds.load_history.append((now, total))
        while (ds.load_history
               and now - ds.load_history[0][0] > look_back):
            ds.load_history.popleft()
        total = max(t for _, t in ds.load_history)
        desired = max(
            ac.min_replicas,
            min(ac.max_replicas,
                int(-(-total // max(ac.target_ongoing_requests, 1e-9)))))
        changed = False
        with self._lock:
            if desired > ds.target_replicas:
                ds.under_since = None
                if ds.over_since is None:
                    ds.over_since = now
                if now - ds.over_since >= ac.upscale_delay_s:
                    ds.target_replicas = desired
                    ds.over_since = None
                    changed = True
            elif desired < ds.target_replicas:
                ds.over_since = None
                if ds.under_since is None:
                    ds.under_since = now
                if now - ds.under_since >= ac.downscale_delay_s:
                    ds.target_replicas = desired
                    ds.under_since = None
                    changed = True
            else:
                ds.over_since = ds.under_since = None
        return changed

    def _health_check(self, ds: _DeploymentState) -> bool:
        """Run user health checks every health_check_period_s.  Probe
        timeouts (saturated pool) do NOT count as failures — only explicit
        exceptions do; process death is handled by the GCS path."""
        period = ds.config.health_check_period_s
        now = time.monotonic()
        if period <= 0 or now - ds.last_health < period:
            return False
        ds.last_health = now
        with self._lock:
            replicas = list(ds.replicas)
        if not replicas:
            return False
        refs = [r.check_health.remote() for r in replicas]
        ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=2.0)
        to_replace = []
        for r, ref in zip(replicas, refs):
            if ref not in ready:
                continue  # busy, not unhealthy
            try:
                ray_tpu_torch.get(ref)
                ds.health_failures.pop(r.actor_id, None)
            except Exception:
                n = ds.health_failures.get(r.actor_id, 0) + 1
                ds.health_failures[r.actor_id] = n
                if n >= 3:
                    to_replace.append(r)
        if not to_replace:
            return False
        with self._lock:
            ds.replicas = [r for r in ds.replicas if r not in to_replace]
            for r in to_replace:
                ds.health_failures.pop(r.actor_id, None)
                self._note_dead(ds, r.actor_id)
        for r in to_replace:
            self._kill_quiet(r)
        return True

    _DEAD_TTL_S = 30.0  # how long a death stays in the get_replicas feed

    def _note_dead(self, ds: _DeploymentState, rid: bytes) -> None:
        """Record a replica death for the router purge feed (caller holds
        _lock); its stale stats sample goes with it.  The death also goes
        on the cluster event plane (buffered emit — never a synchronous
        push under _lock) and bumps the replica death counter, which SLO
        death-rate rules key on."""
        ds.router_stats.pop(rid, None)
        ds.dead_replicas.append((rid, time.monotonic()))
        while (ds.dead_replicas and time.monotonic()
               - ds.dead_replicas[0][1] > self._DEAD_TTL_S):
            ds.dead_replicas.popleft()
        try:
            _death_counter().inc(tags={"app": ds.app_name,
                                       "deployment": ds.name})
        except Exception:
            pass
        try:
            from ray_tpu_torch.util import events

            events.emit(
                "serve.replica_dead", severity="warning",
                message=f"replica {rid.hex()[:12]} of "
                        f"{ds.app_name}/{ds.name} died; router purged",
                data={"app": ds.app_name, "deployment": ds.name,
                      "replica": rid.hex()})
        except Exception:
            pass
