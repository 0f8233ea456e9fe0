"""The port's goodput tracker (``ray_tpu_torch/util/goodput.py``) on the
same inputs as the JAX package's tests (``tests/test_goodput.py``): step
phases bracket into disjoint buckets that sum to elapsed wall time, the
steady-state rate excludes the warm-up steps, MFU is the analytic
6*N*tokens flops over the peak, and the record has the JAX tracker's keys.
"""

import time

import pytest

from ray_tpu_torch.util import goodput


def _tracker(**kw):
    kw.setdefault("export_metrics", False)
    return goodput.GoodputTracker(**kw)


def test_phase_brackets_accumulate():
    gp = _tracker(run="gp-anatomy")
    for _ in range(3):
        with gp.step() as st:
            with st.phase("data"):
                time.sleep(0.01)
            with st.phase("compute"):
                time.sleep(0.02)
    rep = gp.report()
    gp.close()
    assert rep["steps"] == 3
    assert rep["phase_sum_s"]["data"] >= 3 * 0.01
    assert rep["phase_sum_s"]["compute"] >= 3 * 0.02
    assert rep["phase_sum_s"]["compute"] > rep["phase_sum_s"]["data"]
    assert rep["anatomy"]["compute"]["p50_ms"] >= 20.0
    assert rep["anatomy"]["total"]["mean_ms"] >= 30.0


def test_unknown_phase_rejected():
    gp = _tracker(run="gp-badphase")
    with gp.step() as st:
        with pytest.raises(ValueError, match="unknown phase"):
            with st.phase("prefetch"):
                pass
    gp.close()


def test_buckets_sum_to_elapsed():
    gp = _tracker(run="gp-buckets")
    with gp.compile_bracket():
        time.sleep(0.02)
    with gp.recovery():
        time.sleep(0.01)
    for _ in range(2):
        with gp.step() as st:
            with st.phase("data"):
                time.sleep(0.005)
            with st.phase("h2d"):
                time.sleep(0.005)
            with st.phase("compute"):
                time.sleep(0.01)
            with st.phase("checkpoint"):
                time.sleep(0.005)
    time.sleep(0.02)  # untracked host time must land in 'idle'
    rep = gp.report()
    gp.close()
    assert set(rep["buckets"]) == set(goodput.BUCKETS)
    total = sum(rep["buckets"].values())
    assert total == pytest.approx(rep["elapsed_s"], rel=0.01)
    assert rep["buckets"]["compile"] >= 0.02
    assert rep["buckets"]["recovery"] >= 0.01
    assert rep["buckets"]["data_stall"] >= 2 * 0.01
    assert rep["buckets"]["checkpoint"] >= 2 * 0.005
    assert rep["buckets"]["goodput"] >= 2 * 0.01
    assert rep["buckets"]["idle"] >= 0.02
    assert rep["restarts"] == 1
    assert sum(rep["fractions"].values()) == pytest.approx(1.0, rel=0.01)


def test_steady_state_excludes_warmup():
    gp = _tracker(run="gp-steady", tokens_per_step=1000, warmup_steps=1)
    with gp.step() as st:
        with st.phase("compute"):
            time.sleep(0.2)
    for _ in range(4):
        with gp.step() as st:
            with st.phase("compute"):
                time.sleep(0.01)
    rep = gp.report()
    gp.close()
    steady = rep["tokens_per_sec_steady"]
    naive = 5 * 1000 / rep["elapsed_s"]
    assert steady is not None and steady > naive * 2
    assert steady > 50_000


def test_analytic_flops_and_the_h100_peak():
    """6 * N * tokens, as the JAX package's fallback; the peak is the
    H100's dense bf16 rate."""
    from ray_tpu.util import goodput as jgoodput

    assert goodput.analytic_step_flops(10, 3) == 180.0
    for n, tok in ((10, 3), (1_923_088_384, 16_384)):
        assert goodput.analytic_step_flops(n, tok) == \
            jgoodput.analytic_step_flops(n, tok)
    gp = _tracker(run="gp-peak")
    assert gp.peak_tflops == 989.0 and gp.warmup_steps == 1
    gp.set_flops_per_step(goodput.analytic_step_flops(10, 3))
    assert gp.report()["flops_source"] == "analytic"


def test_mfu_is_tflops_over_peak():
    gp = _tracker(run="gp-mfu", warmup_steps=0, peak_tflops=1.0,
                  flops_per_step=1e9)
    for _ in range(3):
        with gp.step() as st:
            with st.phase("compute"):
                time.sleep(0.01)
    rep = gp.report()
    gp.close()
    assert rep["model_tflops_per_s"] is not None
    assert rep["mfu"] == pytest.approx(rep["model_tflops_per_s"] / 1.0)
    assert 0.005 < rep["mfu"] < 0.2


def test_report_has_the_jax_trackers_keys():
    """The same steps through both trackers: the same record keys, step
    counts and bucket names."""
    from ray_tpu.util import goodput as jgoodput

    reps = []
    for mod in (goodput, jgoodput):
        gp = mod.GoodputTracker(run="gp-keys", tokens_per_step=10,
                                warmup_steps=1, export_metrics=False)
        for _ in range(2):
            with gp.step() as st:
                with st.phase("compute"):
                    pass
        reps.append(gp.report())
        gp.close()
    ours, theirs = reps
    assert set(ours) == set(theirs)
    assert set(ours["anatomy"]) == set(theirs["anatomy"])
    assert ours["steps"] == theirs["steps"] == 2
    assert goodput.PHASES == jgoodput.PHASES
    assert goodput.BUCKETS == jgoodput.BUCKETS


def test_metric_families_are_the_jax_trackers():
    gp = goodput.GoodputTracker(run="gp-export", tokens_per_step=10,
                                warmup_steps=0, flops_per_step=1e6)
    with gp.step() as st:
        with st.phase("compute"):
            time.sleep(0.001)
    gp.close()
    from ray_tpu_torch.util import metrics

    rows = {r["name"]: r for r in metrics.snapshot()
            if r["name"].startswith("train_")}
    assert len(rows) == 9
    assert rows["train_step_s"]["kind"] == "histogram"
    assert rows["train_mfu"]["kind"] == "gauge"


def _steps_on_a_clock(mod, clock, **kw):
    """Four steps through ``mod``'s tracker on a hand-driven clock: the
    same wall times whatever the machine."""
    clock[0] = 100.0
    kw.setdefault("warmup_steps", 1)
    gp = mod.GoodputTracker(run="gp-flag", tokens_per_step=256,
                            flops_per_step=3.0e12, export_metrics=False,
                            **kw)
    for i in range(4):
        with gp.step() as st:
            with st.phase("data"):
                clock[0] += 0.001
            with st.phase("compute"):
                clock[0] += 0.01 * (i + 1)
    rep = gp.report()
    gp.close()
    return rep


@pytest.mark.parametrize("peak", ["121", "989.5", "1979"])
def test_the_peak_flag_sets_both_trackers_mfu(peak, monkeypatch):
    """``RTPU_GOODPUT_PEAK_TFLOPS`` is the MFU denominator of both
    packages' trackers: the same steps give the same peak and MFU."""
    from ray_tpu.util import goodput as jgoodput

    monkeypatch.setenv("RTPU_GOODPUT_PEAK_TFLOPS", peak)
    clock = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    ours = _steps_on_a_clock(goodput, clock)
    theirs = _steps_on_a_clock(jgoodput, clock)
    assert ours["peak_tflops"] == theirs["peak_tflops"] == float(peak)
    assert ours["mfu"] == theirs["mfu"]
    assert ours["mfu"] == pytest.approx(
        3.0e12 * 3 / (0.001 * 3 + 0.01 * (2 + 3 + 4)) / 1e12 / float(peak))
    # an explicit peak still wins over the flag
    assert _steps_on_a_clock(goodput, clock, peak_tflops=2.0)[
        "peak_tflops"] == 2.0


@pytest.mark.parametrize("warmup", [None, "0", "2"])
def test_the_warmup_flag_sets_both_trackers_steady_state(warmup,
                                                         monkeypatch):
    """``RTPU_GOODPUT_WARMUP`` (default 1) is the warmup of both packages'
    trackers where the caller gives none: the same steps give the same
    steady-state throughput and MFU."""
    from ray_tpu.util import goodput as jgoodput

    if warmup is None:
        monkeypatch.delenv("RTPU_GOODPUT_WARMUP", raising=False)
    else:
        monkeypatch.setenv("RTPU_GOODPUT_WARMUP", warmup)
    monkeypatch.setenv("RTPU_GOODPUT_PEAK_TFLOPS", "100")  # defaults differ
    clock = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    ours = _steps_on_a_clock(goodput, clock, warmup_steps=None)
    theirs = _steps_on_a_clock(jgoodput, clock, warmup_steps=None)
    assert ours["warmup_steps"] == theirs["warmup_steps"] == int(
        warmup or 1)
    for key in ("tokens_per_sec_steady", "model_tflops_per_s", "mfu"):
        assert ours[key] == theirs[key], key


def test_the_peak_defaults_to_the_h100s(monkeypatch):
    from ray_tpu_torch._private import flags

    monkeypatch.delenv("RTPU_GOODPUT_PEAK_TFLOPS", raising=False)
    assert flags.get("RTPU_GOODPUT_PEAK_TFLOPS") == 989.0
    clock = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    rep = _steps_on_a_clock(goodput, clock)
    assert rep["peak_tflops"] == 989.0
    assert rep["mfu"] == rep["model_tflops_per_s"] / 989.0
