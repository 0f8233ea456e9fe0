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
