"""The port's APPO, IMPALA, DQN, SAC and multi-agent PPO learn on the CPU at
their JAX tests' configurations and gates (``tests/test_rllib.py``,
``test_impala.py``, ``test_dqn.py``, ``test_sac_marwil.py``,
``test_multi_agent.py``), through runner actors of the port's runtime,
and checkpoint and restore.  ``chip_smoke.py``'s RL phase holds them to the
same gates with the learners on the card.
"""

import math

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib import module as tmodule
from ray_tpu_torch.rllib.appo import APPOConfig
from ray_tpu_torch.rllib.dqn import DQNConfig
from ray_tpu_torch.rllib.examples import TargetMatchEnv
from ray_tpu_torch.rllib.impala import IMPALAConfig
from ray_tpu_torch.rllib.multi_agent import MultiAgentPPOConfig
from ray_tpu_torch.rllib.sac import SACConfig
from ray_tpu_torch.train.step import tree_leaves

pytest.importorskip("gymnasium")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small products: one intra-op thread while this file runs, so
    the test workers do not oversubscribe the cores (ROADMAP ground
    rules); restored after, so no other file's numerics change."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _port_runtime(_one_torch_thread):
    """The port's runtime for the algorithms' runner actors, as the JAX
    tests run theirs in the session cluster; its pre-started workers
    take one intra-op thread each."""
    import ray_tpu_torch as rt

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        rt.init(min_workers=4, max_workers=8, object_store_memory=1 << 27,
                resources={"CPU": 8.0})
    yield rt
    rt.shutdown()


def _mapping():
    """The policy mapping, made in a closure: the runner actors get it by
    value (the runtime pickles a module's function by reference where it
    can, and the actors cannot import this module)."""
    def agent(a):
        return f"p_{a}"

    return agent


_agent = _mapping()


# name: (config, iterations, stop once the best return reaches this)
CASES = {
    "appo": (lambda: APPOConfig(num_env_runners=2, num_envs_per_runner=2,
                                rollout_fragment_length=64, lr=5e-3,
                                minibatch_size=128, seed=0), 30, 60.0),
    "impala": (lambda: IMPALAConfig(num_env_runners=2, num_envs_per_runner=4,
                                    rollout_fragment_length=64, lr=7e-4,
                                    entropy_coeff=0.02, seed=1), 30, None),
    "dqn": (lambda: DQNConfig(num_env_runners=2, num_envs_per_runner=2,
                              rollout_fragment_length=64,
                              learning_starts=256, train_batch_size=64,
                              num_updates_per_iter=8,
                              target_network_update_freq=300,
                              epsilon_decay_steps=2500, seed=3), 22, None),
    "sac": (lambda: SACConfig(num_env_runners=2, num_envs_per_runner=2,
                              rollout_fragment_length=64,
                              learning_starts=256, train_batch_size=128,
                              num_updates_per_iter=24, seed=0), 45, 50.0),
    "multi_agent_ppo": (lambda: MultiAgentPPOConfig(
        env=TargetMatchEnv, policy_mapping_fn=_agent, num_env_runners=1,
        rollout_fragment_length=128, seed=0, lr=5e-3, num_epochs=6),
        15, 24.0),
}


@pytest.mark.parametrize("name", list(CASES))
def test_learns_at_the_jax_tests_gate(name):
    make, iters, stop_at = CASES[name]
    algo = make().build(device="cpu")
    best, result = -math.inf, None
    try:
        for _ in range(iters):
            result = algo.train()
            ret = result["episode_return_mean"]
            if ret is not None and np.isfinite(ret):
                best = max(best, ret)
            if stop_at is not None and best >= stop_at:
                break
        if name == "appo":
            assert best >= 60.0 and algo._inflight is not None
        elif name == "impala":
            assert result["loss"] is not None and result["mean_rho"] > 0
            assert best > 60
        elif name == "dqn":
            assert result["num_updates"] > 0 and result["loss"] is not None
            assert best > 60
        elif name == "sac":
            assert best >= 50.0 and result["alpha"] > 0.0
        else:
            assert best >= 24.0
            assert set(result["policies"]) == {"p_a0", "p_a1"}
            assert min(result["per_agent_return_mean"].values()) >= 9.0
    finally:
        algo.stop()


def _learner_state(algo):
    if hasattr(algo, "pi_params"):
        return [algo.pi_params, algo.q_params, algo.q_target,
                algo.log_alpha, algo.pi_opt["mu"], algo.q_opt["nu"]]
    return [algo.params, algo.opt_state["mu"] if "mu" in algo.opt_state
            else {k: v["mu"] for k, v in algo.opt_state.items()}]


@pytest.mark.parametrize("name", ["impala", "dqn", "sac",
                                  "multi_agent_ppo"])
def test_checkpoint_roundtrip(name, tmp_path):
    """save, then restore into a fresh algorithm: the learner's state and
    counters come back equal."""
    cfg = CASES[name][0]()
    for field in ("num_env_runners", "num_envs_per_runner"):
        if hasattr(cfg, field):
            setattr(cfg, field, 1)
    cfg.rollout_fragment_length = 16
    if hasattr(cfg, "learning_starts"):
        cfg.learning_starts = cfg.train_batch_size = 16
        cfg.num_updates_per_iter = 2
    algo = cfg.build(device="cpu")
    path = str(tmp_path / "algo.pkl")
    try:
        algo.train()
        algo.save(path)
        want = [t.clone() for t in tree_leaves(_learner_state(algo))]
    finally:
        algo.stop()
    fresh = cfg.build(device="cpu")
    try:
        before = [t.clone() for t in tree_leaves(_learner_state(fresh))]
        fresh.restore(path)
        got = tree_leaves(_learner_state(fresh))
        assert any(not torch.equal(a, b) for a, b in zip(before, want))
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        count = getattr(fresh, "_iter", getattr(fresh, "iteration", None))
        assert count == 1
        result = fresh.train()  # training goes on from the restored state
        assert result["training_iteration"] == 2
    finally:
        fresh.stop()


def test_learners_keep_their_tensors_on_the_device():
    """Every learner tensor on the learner's device after training; the
    runners get CPU copies."""
    algo = DQNConfig(num_env_runners=1, num_envs_per_runner=1,
                     rollout_fragment_length=16, learning_starts=16,
                     train_batch_size=16,
                     num_updates_per_iter=2).build(device="cpu")
    try:
        algo.train()
        assert {t.device.type for t in tree_leaves(
            [algo.params, algo.target_params])} == {"cpu"}
        copy = tmodule.host_copy(algo.params)
        assert not {t.data_ptr() for t in tree_leaves(copy)} & {
            t.data_ptr() for t in tree_leaves(algo.params)}
    finally:
        algo.stop()
