"""Application metrics: Counter / Gauge / Histogram.

Counterpart of ``ray_tpu/util/metrics.py``.  Every process keeps one local
registry; ``snapshot()`` reads it (one dict per metric).  Under the port's
runtime a background flusher pushes that snapshot over the node
scheduler's control socket (``metrics_push``) every
``RTPU_METRICS_FLUSH_S``, and the scheduler aggregates it per node
(``metrics_snapshot``).  Tag semantics as in the JAX package: declared
``tag_keys``, default tags, per-call overrides.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.util import tracing

_registry_lock = threading.Lock()
_registry: List["Metric"] = []
_flusher_started = False
_flush_stop = threading.Event()
_flush_gen = 0


def _flush_interval() -> float:
    from ray_tpu_torch._private import flags

    return max(0.25, float(flags.get("RTPU_METRICS_FLUSH_S")))


def _ensure_flusher():
    global _flusher_started, _flush_gen
    with _registry_lock:
        if _flusher_started:
            return
        _flusher_started = True
        _flush_gen += 1
        gen = _flush_gen
        _flush_stop.clear()
    threading.Thread(target=_flush_loop, args=(gen,), name="metrics-flush",
                     daemon=True).start()


def _flush_loop(gen: int):
    global _flusher_started
    while True:
        stopped = _flush_stop.wait(_flush_interval())
        with _registry_lock:
            if gen != _flush_gen:
                return  # superseded by a newer flusher
            if stopped:
                _flusher_started = False
                return  # clean exit on shutdown_flusher()
        _flush_once()


def _flush_once():
    from ray_tpu_torch._private import worker as worker_mod

    ctx = worker_mod.global_worker_or_none()
    if ctx is None:
        return  # no runtime in this process (yet/anymore)
    snap = snapshot()
    if not snap:
        return
    try:
        ctx.rpc("metrics_push", {
            "source": ctx.worker_id or b"driver",
            "metrics": snap,
        })
    except Exception:
        pass  # node shutting down; metrics are best-effort


def shutdown_flusher(flush: bool = False):
    """Stop the background flusher, optionally pushing one final snapshot
    first."""
    if flush:
        try:
            _flush_once()
        except Exception:
            pass
    _flush_stop.set()


def resume_flusher():
    """Restart the flusher after a shutdown when metrics already exist
    (a fresh ``init()`` in the same process re-uses the registry)."""
    with _registry_lock:
        empty = not _registry
    if not empty:
        _ensure_flusher()


def snapshot() -> List[dict]:
    with _registry_lock:
        metrics = list(_registry)
    return [m._snapshot() for m in metrics]


class Metric:
    _kind = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        if not name:
            raise ValueError("metric name is required")
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._values: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()
        with _registry_lock:
            _registry.append(self)
        _ensure_flusher()

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        bad = set(tags) - set(self._tag_keys)
        if bad:
            raise ValueError(f"tags {sorted(bad)} not in declared tag_keys "
                             f"{self._tag_keys}")
        self._default_tags = dict(tags)
        return self

    def _tag_tuple(self, tags: Optional[Dict[str, str]]) -> Tuple[str, ...]:
        merged = dict(self._default_tags)
        if tags:
            bad = set(tags) - set(self._tag_keys)
            if bad:
                raise ValueError(
                    f"tags {sorted(bad)} not in declared tag_keys "
                    f"{self._tag_keys}")
            merged.update(tags)
        return tuple(merged.get(k, "") for k in self._tag_keys)

    def clear(self) -> None:
        """Drop every recorded series (tag values and histogram state)."""
        with self._lock:
            self._values.clear()
            hist = getattr(self, "_hist", None)
            if hist is not None:
                hist.clear()

    @property
    def info(self) -> dict:
        return {"name": self._name, "description": self._description,
                "tag_keys": self._tag_keys,
                "default_tags": dict(self._default_tags)}

    def _snapshot(self) -> dict:
        with self._lock:
            values = dict(self._values)
        return {"name": self._name, "kind": self._kind,
                "description": self._description,
                "tag_keys": self._tag_keys, "values": values}


class Counter(Metric):
    _kind = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None):
        if value < 0:
            raise ValueError("counters only increase")
        key = self._tag_tuple(tags)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value


class Gauge(Metric):
    _kind = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = self._tag_tuple(tags)
        with self._lock:
            self._values[key] = float(value)


DEFAULT_BOUNDARIES = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 60)

# Serving-latency histogram families expected to carry exemplar trace ids
# (the bucket-indexed "which request landed here" links).
EXEMPLAR_FAMILIES = (
    "llm_ttft_s",
    "llm_tpot_s",
    "llm_e2e_s",
    "llm_queue_wait_s",
    "llm_prefill_s",
    "serve_request_latency_s",
)


class Histogram(Metric):
    _kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[Sequence[float]] = None,
                 tag_keys: Optional[Sequence[str]] = None):
        super().__init__(name, description, tag_keys)
        self._boundaries = tuple(boundaries or DEFAULT_BOUNDARIES)
        # per tag tuple: [bucket counts..., +inf count, sum]
        self._hist: Dict[Tuple[str, ...], list] = {}
        # per tag tuple: {bucket index: last trace id to land there}
        self._exemplars: Dict[Tuple[str, ...], Dict[int, str]] = {}

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None,
                exemplar: Optional[str] = None):
        if exemplar is None:
            # ambient pickup: an observe inside a traced request links the
            # bucket to that request without every call site threading ids
            ctx = tracing.current_context()
            if ctx is not None:
                exemplar = ctx[0]
        key = self._tag_tuple(tags)
        with self._lock:
            h = self._hist.get(key)
            if h is None:
                h = self._hist[key] = [0] * (len(self._boundaries) + 1) + [0.0]
            for i, b in enumerate(self._boundaries):
                if value <= b:
                    bucket = i
                    break
            else:
                bucket = len(self._boundaries)
            h[bucket] += 1
            h[-1] += value
            if exemplar:
                self._exemplars.setdefault(key, {})[bucket] = str(exemplar)

    def clear(self) -> None:
        super().clear()
        with self._lock:
            self._exemplars.clear()

    def _snapshot(self) -> dict:
        with self._lock:
            hist = {k: list(v) for k, v in self._hist.items()}
            exemplars = {k: dict(v) for k, v in self._exemplars.items() if v}
        snap = {"name": self._name, "kind": self._kind,
                "description": self._description,
                "tag_keys": self._tag_keys,
                "boundaries": self._boundaries, "hist": hist}
        if exemplars:
            snap["exemplars"] = exemplars
        return snap
