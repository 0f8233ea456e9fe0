"""``chip_smoke.NumpyCartPole`` against gymnasium's ``CartPole-v1``.

The card's machine has no gymnasium, so ``chip_smoke.py``'s RL phase steps
a numpy CartPole.  Here it is held to gymnasium's, step for step: the same
seed and the same actions give the same observations (float32, exactly),
rewards, ``terminated`` and ``truncated``, across resets, and a balancing
policy runs an episode to the 500-step truncation on both.
"""

import numpy as np
import pytest

import chip_smoke

gym = pytest.importorskip("gymnasium")


def _balance(obs) -> int:
    """A scripted controller that keeps the pole up for 500 steps: push
    toward where the pole and the cart are heading."""
    x, x_dot, theta, theta_dot = obs
    return int(theta + 0.5 * theta_dot + 0.01 * x + 0.1 * x_dot > 0)


def _episodes(env, seed, policy, n_episodes, rng):
    """Every (obs, reward, terminated, truncated) over ``n_episodes``, the
    first reset seeded and the later ones not (as the env runners do)."""
    out = []
    obs, _ = env.reset(seed=seed)
    out.append((obs, None, None, None))
    for _ in range(n_episodes):
        while True:
            action = policy(obs, rng)
            obs, r, term, trunc, _ = env.step(action)
            out.append((obs, r, term, trunc))
            if term or trunc:
                break
        obs, _ = env.reset()
        out.append((obs, None, None, None))
    return out


def _compare(seed, policy, n_episodes):
    got = _episodes(chip_smoke.NumpyCartPole(), seed, policy, n_episodes,
                    np.random.default_rng(seed))
    want = _episodes(gym.make("CartPole-v1"), seed, policy, n_episodes,
                     np.random.default_rng(seed))
    assert len(got) == len(want)
    for i, ((o, r, te, tr), (wo, wr, wte, wtr)) in enumerate(zip(got,
                                                                 want)):
        assert o.dtype == wo.dtype == np.float32, i
        np.testing.assert_array_equal(o, wo, err_msg=str(i))
        assert (r, te, tr) == (wr, wte, wtr), i
    return want


@pytest.mark.parametrize("seed", [0, 3, 1000])
def test_numpy_cartpole_matches_gymnasium(seed):
    """Random actions over four episodes, each ending in a termination."""
    steps = _compare(seed, lambda obs, rng: int(rng.integers(2)), 4)
    terminations = [s for s in steps if s[2]]
    assert len(terminations) == 4


def test_numpy_cartpole_truncates_at_500():
    """A balancing policy: the episode is cut by the time limit at step
    500, not terminated, on both; then one more episode from the unseeded
    reset."""
    steps = _compare(7, lambda obs, rng: _balance(obs), 2)
    ends = [i for i, s in enumerate(steps) if s[2] or s[3]]
    assert ends[0] == 500 and steps[500][3] and not steps[500][2]
    assert all(s[1] == 1.0 for s in steps[1:501])


def test_numpy_cartpole_spaces():
    env = chip_smoke.NumpyCartPole()
    ref = gym.make("CartPole-v1")
    assert env.observation_space.shape == ref.observation_space.shape
    np.testing.assert_array_equal(env.observation_space.high,
                                  ref.observation_space.high)
    assert env.action_space.n == ref.action_space.n
