"""Adaptive searchers: TPE (native) + gated external backends.

Counterpart of ``ray_tpu/tune/searchers.py``; that is, of
Ray's python/ray/tune/search/ (optuna/, hyperopt/,
bayesopt/, ...). The native default is a Tree-structured Parzen Estimator —
the algorithm behind Optuna's and HyperOpt's defaults — implemented on
numpy alone so the air-gapped TPU image needs no extra packages. External
libraries plug in through the same Searcher ABC (search.py) and are
import-gated with a clear error, like the reference's
`pip install optuna` guidance.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.tune.search import (
    Choice,
    Domain,
    GridSearch,
    LogUniform,
    QUniform,
    RandInt,
    Searcher,
    Uniform,
)


def _quantize(dom: Domain, x: float):
    """Apply a numeric domain's integer/quantum rounding to x (shared
    by every adaptive searcher's decode/perturb path)."""
    if isinstance(dom, RandInt):
        return int(np.clip(round(x), dom.low, dom.high - 1))
    if isinstance(dom, QUniform):
        return round(x / dom.q) * dom.q
    return x


def _record_completion(searcher, trial_id: str, result, error: bool):
    """Common on_trial_complete bookkeeping: pop the in-flight config,
    negate scores under mode='min', append to .observed-style storage.
    Returns (cfg, score) or None when the trial carries no signal."""
    cfg = searcher._inflight.pop(trial_id, None)
    if cfg is None or error or not result or searcher.metric not in result:
        return None
    score = float(result[searcher.metric])
    if searcher.mode == "min":
        score = -score
    return cfg, score


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator (Bergstra et al., NeurIPS 2011).

    After ``n_initial_points`` random trials, each numeric dimension is
    split into "good" (top gamma quantile) and "bad" observations; we draw
    ``n_candidates`` samples from a KDE over the good set and keep the one
    maximizing l(x)/g(x). Categorical dims use smoothed category counts.
    """

    def __init__(self, metric: str, mode: str = "max",
                 n_initial_points: int = 5, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self.metric = metric
        self.mode = mode
        self.n_initial = n_initial_points
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._np_rng = np.random.default_rng(seed)
        self._space: Dict[str, Any] = {}
        self._observed: List[tuple[Dict[str, Any], float]] = []
        self._inflight: Dict[str, Dict[str, Any]] = {}

    def set_search_space(self, param_space: Dict[str, Any]) -> "TPESearcher":
        for k, v in param_space.items():
            if isinstance(v, GridSearch):
                raise ValueError(
                    "grid_search dimensions belong to BasicVariantGenerator; "
                    "use choice() with TPESearcher")
            self._space[k] = v
        return self

    # -- Searcher ABC ------------------------------------------------------
    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if not self._space:
            raise RuntimeError("call set_search_space(param_space) first")
        if len(self._observed) < self.n_initial:
            cfg = {k: (v.sample(self._rng) if isinstance(v, Domain) else v)
                   for k, v in self._space.items()}
        else:
            cfg = {k: (self._suggest_dim(k, v)
                       if isinstance(v, Domain) else v)
                   for k, v in self._space.items()}
        self._inflight[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id: str, result: Optional[dict],
                          error: bool = False) -> None:
        rec = _record_completion(self, trial_id, result, error)
        if rec is not None:
            self._observed.append(rec)

    # -- TPE internals -----------------------------------------------------
    def _split(self):
        ranked = sorted(self._observed, key=lambda t: -t[1])
        n_good = max(1, int(math.ceil(self.gamma * len(ranked))))
        return ranked[:n_good], ranked[n_good:]

    def _suggest_dim(self, name: str, dom: Domain) -> Any:
        good, bad = self._split()
        if isinstance(dom, Choice):
            return self._categorical(name, dom.options, good, bad)
        if isinstance(dom, (Uniform, LogUniform, QUniform, RandInt)):
            return self._numeric(name, dom, good, bad)
        return dom.sample(self._rng)

    def _categorical(self, name, options, good, bad):
        def weights(obs):
            counts = np.ones(len(options))  # +1 smoothing
            index = {o: i for i, o in enumerate(options)}
            for cfg, _ in obs:
                i = index.get(cfg.get(name))
                if i is not None:
                    counts[i] += 1
            return counts / counts.sum()

        lw, gw = weights(good), weights(bad)
        score = lw / gw
        return options[int(np.argmax(score))]

    def _numeric(self, name, dom, good, bad):
        log = isinstance(dom, LogUniform)
        lo, hi = float(dom.low), float(dom.high)
        if log:
            lo, hi = math.log(lo), math.log(hi)

        def xs_of(obs):
            vals = [float(cfg[name]) for cfg, _ in obs if name in cfg]
            if log:
                vals = [math.log(max(v, 1e-300)) for v in vals]
            return np.asarray(vals)

        good_x, bad_x = xs_of(good), xs_of(bad)
        if good_x.size == 0:
            return dom.sample(self._rng)
        # Parzen bandwidth: range-scaled Silverman-ish
        bw = max((hi - lo) / max(4, good_x.size), 1e-12)
        cands = self._np_rng.choice(good_x, size=self.n_candidates)
        cands = cands + self._np_rng.normal(0.0, bw, size=self.n_candidates)
        cands = np.clip(cands, lo, hi)

        def kde_logpdf(x, data, h):
            if data.size == 0:
                return np.full_like(x, -math.log(hi - lo + 1e-12))
            d = (x[:, None] - data[None, :]) / h
            return np.log(
                np.exp(-0.5 * d * d).sum(axis=1) / (data.size * h) + 1e-300)

        score = kde_logpdf(cands, good_x, bw) - kde_logpdf(cands, bad_x, bw)
        x = float(cands[int(np.argmax(score))])
        if log:
            x = math.exp(x)
        return _quantize(dom, x)


class OptunaSearch(Searcher):
    """Optuna-backed searcher (import-gated; reference search/optuna/)."""

    def __init__(self, metric: str, mode: str = "max", **kwargs):
        try:
            import optuna  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "OptunaSearch requires the 'optuna' package, which is not "
                "in the TPU image; use the native TPESearcher (same "
                "algorithm family) instead") from e
        import optuna

        self.metric = metric
        self.mode = mode
        direction = "maximize" if mode == "max" else "minimize"
        self._study = optuna.create_study(direction=direction, **kwargs)
        self._space: Dict[str, Any] = {}
        self._trials: Dict[str, Any] = {}

    def set_search_space(self, param_space: Dict[str, Any]):
        self._space = param_space
        return self

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        trial = self._study.ask()
        cfg = {}
        for k, v in self._space.items():
            if isinstance(v, Uniform):
                cfg[k] = trial.suggest_float(k, v.low, v.high)
            elif isinstance(v, LogUniform):
                cfg[k] = trial.suggest_float(k, v.low, v.high, log=True)
            elif isinstance(v, RandInt):
                cfg[k] = trial.suggest_int(k, v.low, v.high - 1)
            elif isinstance(v, Choice):
                cfg[k] = trial.suggest_categorical(k, v.options)
            else:
                cfg[k] = v
        self._trials[trial_id] = trial
        return cfg

    def on_trial_complete(self, trial_id: str, result: Optional[dict],
                          error: bool = False) -> None:
        trial = self._trials.pop(trial_id, None)
        if trial is None:
            return
        if error or not result or self.metric not in result:
            self._study.tell(trial, state=2)  # PRUNED
            return
        self._study.tell(trial, float(result[self.metric]))


class AnnealingSearcher(Searcher):
    """Simulated-annealing search (reference: tune/search/ — hyperopt's
    ``anneal`` suggester plays this role there).

    Proposals perturb the best configuration seen so far with a radius
    that cools geometrically per completed trial; a worse incumbent is
    still adopted with probability exp(delta / T), so early exploration
    escapes local optima and late trials exploit.  Numpy-free and
    air-gap friendly like TPESearcher.
    """

    def __init__(self, metric: str, mode: str = "max",
                 initial_radius: float = 0.5, cooling: float = 0.95,
                 initial_temp: float = 1.0,
                 seed: Optional[int] = None):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self.metric = metric
        self.mode = mode
        self._radius = initial_radius
        self._cooling = cooling
        self._temp = initial_temp
        self._rng = random.Random(seed)
        self._space: Dict[str, Any] = {}
        self._inflight: Dict[str, Dict[str, Any]] = {}
        self._incumbent: Optional[tuple[Dict[str, Any], float]] = None
        self._n_done = 0

    def set_search_space(self, param_space: Dict[str, Any]
                         ) -> "AnnealingSearcher":
        for k, v in param_space.items():
            if isinstance(v, GridSearch):
                raise ValueError("grid_search belongs to "
                                 "BasicVariantGenerator")
            self._space[k] = v
        return self

    def _perturb_dim(self, dom: Domain, center: Any, radius: float) -> Any:
        if isinstance(dom, Choice):
            if self._rng.random() < radius:
                return self._rng.choice(dom.options)
            return center
        if isinstance(dom, (Uniform, QUniform, RandInt)):
            lo, hi = float(dom.low), float(dom.high)
            x = float(center) + self._rng.gauss(0, radius * (hi - lo))
            x = min(max(x, lo), hi)
        elif isinstance(dom, LogUniform):
            llo, lhi = math.log(dom.low), math.log(dom.high)
            lx = math.log(max(float(center), 1e-300)) + self._rng.gauss(
                0, radius * (lhi - llo))
            x = math.exp(min(max(lx, llo), lhi))
        else:
            return dom.sample(self._rng)
        return _quantize(dom, x)

    # -- Searcher ABC ------------------------------------------------------
    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if not self._space:
            raise RuntimeError("call set_search_space(param_space) first")
        if self._incumbent is None:
            cfg = {k: (v.sample(self._rng) if isinstance(v, Domain) else v)
                   for k, v in self._space.items()}
        else:
            center, _ = self._incumbent
            radius = self._radius * (self._cooling ** self._n_done)
            cfg = {k: (self._perturb_dim(v, center.get(k), radius)
                       if isinstance(v, Domain) else v)
                   for k, v in self._space.items()}
        self._inflight[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id: str, result: Optional[dict],
                          error: bool = False) -> None:
        cfg = self._inflight.pop(trial_id, None)
        if cfg is None or error or not result or self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "min":
            score = -score
        self._n_done += 1
        if self._incumbent is None:
            self._incumbent = (cfg, score)
            return
        _, inc_score = self._incumbent
        temp = max(self._temp * (self._cooling ** self._n_done), 1e-9)
        if score >= inc_score or self._rng.random() < math.exp(
                min(0.0, (score - inc_score) / temp)):
            self._incumbent = (cfg, score)


class BOHBSearcher(TPESearcher):
    """BOHB's model side (Falkner et al., ICML 2018): TPE density models
    fed per-fidelity, pairing with the HyperBand scheduler
    (tune/schedulers.py) the way the reference pairs TuneBOHB with
    HyperBandForBOHB.

    Observations are grouped by the budget they were measured at
    (``budget_key`` in the reported result, default
    "training_iteration"); suggestions come from the KDE of the HIGHEST
    budget that has accumulated ``n_initial_points`` results — low-rung
    early-stopped trials guide the search until real high-fidelity
    evidence exists, then the model upgrades to it.
    """

    def __init__(self, metric: str, mode: str = "max",
                 budget_key: str = "training_iteration",
                 n_initial_points: int = 5, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None):
        super().__init__(metric, mode, n_initial_points, gamma,
                         n_candidates, seed)
        self.budget_key = budget_key
        self._by_budget: Dict[float, List[tuple[Dict[str, Any], float]]] = {}

    def on_trial_complete(self, trial_id: str, result: Optional[dict],
                          error: bool = False) -> None:
        cfg = self._inflight.pop(trial_id, None)
        if cfg is None or error or not result or self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "min":
            score = -score
        budget = float(result.get(self.budget_key, 0) or 0)
        self._by_budget.setdefault(budget, []).append((cfg, score))
        # the pooled view keeps the random-phase counter in sync
        self._observed.append((cfg, score))

    def _split(self):
        # highest fidelity with enough evidence wins; else pool
        for budget in sorted(self._by_budget, reverse=True):
            obs = self._by_budget[budget]
            if len(obs) >= self.n_initial:
                ranked = sorted(obs, key=lambda t: -t[1])
                n_good = max(1, int(math.ceil(self.gamma * len(ranked))))
                return ranked[:n_good], ranked[n_good:]
        return super()._split()


class GPSearcher(Searcher):
    """Bayesian optimization with a numpy Gaussian process + expected
    improvement (the reference's `bayesopt` integration role, without
    the wheel).

    Numeric dimensions are normalized to [0,1] (log-space for
    LogUniform); an RBF-kernel GP posterior over observed scores scores
    ``n_candidates`` random probes by EI and suggests the argmax.
    Categorical dimensions fall back to smoothed best-arm sampling.
    O(n^3) in observations — intended for the <=few-hundred-trial budgets
    HPO sweeps actually run.
    """

    def __init__(self, metric: str, mode: str = "max",
                 n_initial_points: int = 6, n_candidates: int = 256,
                 length_scale: float = 0.2, noise: float = 1e-4,
                 xi: float = 0.01, seed: Optional[int] = None):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self.metric = metric
        self.mode = mode
        self.n_initial = n_initial_points
        self.n_candidates = n_candidates
        self.length_scale = length_scale
        self.noise = noise
        self.xi = xi
        self._rng = random.Random(seed)
        self._np_rng = np.random.default_rng(seed)
        self._space: Dict[str, Any] = {}
        self._numeric: List[str] = []
        self._inflight: Dict[str, Dict[str, Any]] = {}
        self._observed: List[tuple[Dict[str, Any], float]] = []

    def set_search_space(self, param_space: Dict[str, Any]) -> "GPSearcher":
        for k, v in param_space.items():
            if isinstance(v, GridSearch):
                raise ValueError("grid_search belongs to "
                                 "BasicVariantGenerator")
            self._space[k] = v
            if isinstance(v, (Uniform, LogUniform, QUniform, RandInt)):
                self._numeric.append(k)
        return self

    # -- unit-cube encoding -------------------------------------------------
    def _bounds(self, dom):
        if isinstance(dom, LogUniform):
            return math.log(dom.low), math.log(dom.high), True
        return float(dom.low), float(dom.high), False

    def _encode(self, cfg: Dict[str, Any]) -> np.ndarray:
        xs = []
        for k in self._numeric:
            lo, hi, log = self._bounds(self._space[k])
            v = float(cfg[k])
            if log:
                v = math.log(max(v, 1e-300))
            xs.append((v - lo) / max(hi - lo, 1e-12))
        return np.asarray(xs)

    def _decode_dim(self, k: str, u: float) -> Any:
        dom = self._space[k]
        lo, hi, log = self._bounds(dom)
        v = lo + u * (hi - lo)
        if log:
            v = math.exp(v)
        return _quantize(dom, v)

    # -- GP posterior + EI --------------------------------------------------
    def _ei_argmax(self) -> np.ndarray:
        X = np.stack([self._encode(c) for c, _ in self._observed])
        y = np.asarray([s for _, s in self._observed])
        y_mean, y_std = y.mean(), max(y.std(), 1e-9)
        yn = (y - y_mean) / y_std

        def rbf(a, b):
            d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
            return np.exp(-0.5 * d2 / self.length_scale ** 2)

        K = rbf(X, X) + self.noise * np.eye(len(X))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))

        cand = self._np_rng.random((self.n_candidates, X.shape[1]))
        Ks = rbf(cand, X)
        mu = Ks @ alpha
        v = np.linalg.solve(L, Ks.T)
        var = np.clip(1.0 - (v ** 2).sum(0), 1e-12, None)
        sigma = np.sqrt(var)
        best = yn.max()
        z = (mu - best - self.xi) / sigma
        # standard-normal pdf/cdf without scipy
        pdf = np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
        cdf = 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2)))
        ei = (mu - best - self.xi) * cdf + sigma * pdf
        return cand[int(np.argmax(ei))]

    # -- Searcher ABC ------------------------------------------------------
    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if not self._space:
            raise RuntimeError("call set_search_space(param_space) first")
        if len(self._observed) < self.n_initial:
            cfg = {k: (v.sample(self._rng) if isinstance(v, Domain) else v)
                   for k, v in self._space.items()}
        else:
            # numeric dims via GP+EI; categorical via best-arm — which
            # also carries a categorical-ONLY space past random search
            u = self._ei_argmax() if self._numeric else None
            cfg = {}
            for i, k in enumerate(self._numeric):
                cfg[k] = self._decode_dim(k, float(u[i]))
            for k, v in self._space.items():
                if k in cfg:
                    continue
                if isinstance(v, Choice):
                    cfg[k] = self._best_arm(k, v.options)
                elif isinstance(v, Domain):
                    cfg[k] = v.sample(self._rng)
                else:
                    cfg[k] = v
        self._inflight[trial_id] = cfg
        return cfg

    def _best_arm(self, name: str, options) -> Any:
        # smoothed mean score per category; epsilon-greedy pick
        if self._rng.random() < 0.1:
            return self._rng.choice(options)
        sums = {o: 0.0 for o in options}
        counts = {o: 1.0 for o in options}
        for cfg, score in self._observed:
            o = cfg.get(name)
            if o in sums:
                sums[o] += score
                counts[o] += 1
        return max(options, key=lambda o: sums[o] / counts[o])

    def on_trial_complete(self, trial_id: str, result: Optional[dict],
                          error: bool = False) -> None:
        rec = _record_completion(self, trial_id, result, error)
        if rec is not None:
            self._observed.append(rec)
