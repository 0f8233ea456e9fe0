"""Trial schedulers: FIFO, ASHA, median stopping, PBT.

Counterpart of ``ray_tpu/tune/schedulers.py``; that is, of the
reference's scheduler zoo
(Ray's python/ray/tune/schedulers/: async_hyperband.py
AsyncHyperBandScheduler/ASHA, median_stopping_rule.py, pbt.py): the
controller feeds every reported result to the scheduler, which answers
CONTINUE or STOP; PBT additionally answers EXPLOIT with a source trial whose
checkpoint + perturbed config the target should restart from.
"""

from __future__ import annotations

import math
import random
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

CONTINUE = "CONTINUE"
STOP = "STOP"


class TrialScheduler:
    def set_metric(self, metric: str, mode: str):
        self._metric = metric
        self._sign = 1.0 if mode == "max" else -1.0

    def score(self, result: dict) -> float:
        return self._sign * float(result[self._metric])

    def on_result(self, trial_id: str, result: dict) -> str:
        return CONTINUE

    def exploit_decision(self, trial_id: str, result: dict,
                         all_scores: Dict[str, float]
                         ) -> Optional[str]:
        """PBT only: return a source trial id to exploit, else None."""
        return None


class FIFOScheduler(TrialScheduler):
    pass


class ASHAScheduler(TrialScheduler):
    """Async Successive Halving (reference: async_hyperband.py
    _Bracket.on_result): rungs at grace_period * rf^k; a trial reaching a
    rung stops unless its metric is in the top 1/rf of that rung's history.
    """

    def __init__(self, time_attr: str = "training_iteration",
                 grace_period: int = 1, reduction_factor: int = 3,
                 max_t: int = 100):
        self._time_attr = time_attr
        self._rf = reduction_factor
        self._max_t = max_t
        self._rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self._rungs.append(t)
            t *= reduction_factor
        # rung milestone -> list of scores recorded there
        self._rung_history: Dict[int, List[float]] = defaultdict(list)
        self._trial_rung: Dict[str, int] = defaultdict(int)  # next rung idx

    def on_result(self, trial_id: str, result: dict) -> str:
        t = int(result.get(self._time_attr, 0))
        decision = CONTINUE
        while (self._trial_rung[trial_id] < len(self._rungs)
               and t >= self._rungs[self._trial_rung[trial_id]]):
            rung = self._rungs[self._trial_rung[trial_id]]
            hist = self._rung_history[rung]
            s = self.score(result)
            hist.append(s)
            k = max(1, int(math.ceil(len(hist) / self._rf)))
            cutoff = sorted(hist, reverse=True)[k - 1]
            if s < cutoff:
                decision = STOP
            self._trial_rung[trial_id] += 1
        if t >= self._max_t:
            decision = STOP
        return decision


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose best score so far is below the median of other
    trials' running averages (reference: median_stopping_rule.py)."""

    def __init__(self, time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        self._time_attr = time_attr
        self._grace = grace_period
        self._min_samples = min_samples_required
        self._scores: Dict[str, List[float]] = defaultdict(list)

    def on_result(self, trial_id: str, result: dict) -> str:
        s = self.score(result)
        self._scores[trial_id].append(s)
        t = int(result.get(self._time_attr, 0))
        if t < self._grace or len(self._scores) < self._min_samples:
            return CONTINUE
        others = [sum(v) / len(v) for k, v in self._scores.items()
                  if k != trial_id and v]
        if not others:
            return CONTINUE
        others.sort()
        median = others[len(others) // 2]
        best = max(self._scores[trial_id])
        return STOP if best < median else CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: pbt.py PopulationBasedTraining._exploit): every
    perturbation_interval, bottom-quantile trials clone the checkpoint of a
    random top-quantile trial and continue with a perturbed config."""

    def __init__(self, time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: Optional[int] = None):
        self._time_attr = time_attr
        self._interval = perturbation_interval
        self._mutations = hyperparam_mutations or {}
        self._quantile = quantile_fraction
        self._resample_p = resample_probability
        self._rng = random.Random(seed)
        self._last_perturb: Dict[str, int] = defaultdict(int)

    def exploit_decision(self, trial_id: str, result: dict,
                         all_scores: Dict[str, float]) -> Optional[str]:
        t = int(result.get(self._time_attr, 0))
        if t - self._last_perturb[trial_id] < self._interval:
            return None
        self._last_perturb[trial_id] = t
        if len(all_scores) < 2:
            return None
        ranked = sorted(all_scores, key=all_scores.get)
        k = max(1, int(len(ranked) * self._quantile))
        bottom, top = ranked[:k], ranked[-k:]
        if trial_id in bottom:
            return self._rng.choice(top)
        return None

    def perturb(self, config: dict) -> dict:
        """Mutate hyperparams (reference: pbt.py _explore)."""
        from ray_tpu_torch.tune.search import Domain

        out = dict(config)
        for key, spec in self._mutations.items():
            if self._rng.random() < self._resample_p or key not in out:
                if isinstance(spec, Domain):
                    out[key] = spec.sample(self._rng)
                elif isinstance(spec, list):
                    out[key] = self._rng.choice(spec)
                elif callable(spec):
                    out[key] = spec()
            else:
                factor = self._rng.choice([0.8, 1.2])
                if isinstance(out[key], (int, float)):
                    out[key] = type(out[key])(out[key] * factor)
        return out


class HyperBandScheduler(TrialScheduler):
    """HyperBand: multiple successive-halving brackets trading off
    exploration breadth against per-trial budget (reference:
    schedulers/hyperband.py).  Bracket s gives trials a grace period of
    max_t / rf^s; new trials join brackets round-robin, and within a
    bracket the ASHA rung rule decides stop/continue — the asynchronous
    formulation of HyperBand's halving, same as the reference's
    bracket-based implementation."""

    def __init__(self, time_attr: str = "training_iteration",
                 max_t: int = 81, reduction_factor: int = 3):
        if reduction_factor < 2:
            raise ValueError(
                f"reduction_factor must be >= 2, got {reduction_factor}")
        # integer bracket count: float log under-rounds exact powers
        # (log(243, 3) == 4.9999...), which would silently drop the
        # most-exploratory grace=1 bracket
        s_max = 0
        while reduction_factor ** (s_max + 1) <= max_t:
            s_max += 1
        self._brackets: List[ASHAScheduler] = []
        for s in range(s_max, -1, -1):
            grace = max(1, max_t // (reduction_factor ** s))
            self._brackets.append(ASHAScheduler(
                time_attr=time_attr, grace_period=grace,
                reduction_factor=reduction_factor, max_t=max_t))
        self._assignment: Dict[str, int] = {}
        self._next_bracket = 0

    def set_metric(self, metric: str, mode: str):
        super().set_metric(metric, mode)
        for b in self._brackets:
            b.set_metric(metric, mode)

    def bracket_of(self, trial_id: str) -> int:
        if trial_id not in self._assignment:
            self._assignment[trial_id] = self._next_bracket
            self._next_bracket = (self._next_bracket + 1) \
                % len(self._brackets)
        return self._assignment[trial_id]

    def on_result(self, trial_id: str, result: dict) -> str:
        return self._brackets[self.bracket_of(trial_id)].on_result(
            trial_id, result)
