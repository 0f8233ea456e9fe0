"""``chip_smoke.py``'s ``run_sharded_layouts`` rehearsed on the CPU.

The phase's own functions at the tiny GPT-2: the world-size-1 steps in the
test process, then ``LAYOUTS`` (a sequence over sp and tp, the MLP over the
data axis dp, the MLP over the product of ep and tp) on 4 spawned gloo
ranks, and ``check_layouts`` holding every rank's two losses and grad norms
to the world-size-1 ones at the phase's tolerances.  The kernels' wrappers
take their plain versions on CPU tensors and count nothing, so the launches
must read 0 here; on the card they must read 12 a step.
"""

import dataclasses

import pytest

import chip_smoke


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    from ray_tpu_torch.models import gpt2

    cfg = dataclasses.replace(gpt2.GPT2Config.tiny(), loss_chunk=0)
    return chip_smoke.sharded_layouts(
        "cpu", cfg, 4, 32, str(tmp_path_factory.mktemp("layouts")))


def test_every_layout_agrees_with_world_size_1(layouts):
    reference, ranks = layouts
    want = {k: 0 for k in chip_smoke.launch_counts()}
    worst = chip_smoke.check_layouts(reference, ranks, want)
    assert worst["loss"] <= chip_smoke.LAYOUT_LOSS_TOL
    assert len(ranks) == chip_smoke.LAYOUT_RANKS
    assert reference["losses"][1] < reference["losses"][0]


def test_gloo_took_every_collective_on_the_ranks_device(layouts):
    _, ranks = layouts
    for res in ranks:
        assert res["gloo"] == {"all_gather": "cpu", "all_reduce": "cpu"}


def test_check_layouts_fails_a_rank_off_by_more_than_the_tolerance(layouts):
    """The negative control: one rank's second loss moved by twice the
    tolerance, or one launch missing, fails the phase."""
    reference, ranks = layouts
    want = {k: 0 for k in chip_smoke.launch_counts()}
    name = next(iter(chip_smoke.LAYOUTS))
    moved = [dict(res, layouts=dict(res["layouts"])) for res in ranks]
    run = dict(moved[3]["layouts"][name])
    run["losses"] = [run["losses"][0],
                     run["losses"][1] + 2 * chip_smoke.LAYOUT_LOSS_TOL]
    moved[3]["layouts"][name] = run
    with pytest.raises(SystemExit, match=f"rank 3 {name} step 1"):
        chip_smoke.check_layouts(reference, moved, want)
    with pytest.raises(SystemExit, match="launches"):
        chip_smoke.check_layouts(reference, ranks,
                                 {k: 1 for k in want})
