"""Tuner: the experiment controller event loop.

Counterpart of ``ray_tpu/tune/tuner.py``; that is, of the reference's
Tuner + TuneController
(Ray's python/ray/tune/tuner.py:43 Tuner.fit,
tune/execution/tune_controller.py:68): launches trial runner actors up to
max_concurrent, polls their reports, feeds each result to the scheduler
(early stop) and — for PBT — clones checkpoints from strong trials into
weak ones with perturbed configs.  ``TuneConfig.resources_per_trial`` is
each trial actor's options: ``{"num_cpus": 1, "num_gpus": 0.5}`` puts two
trials on one card, each seeing it as ``cuda:0`` under its grant.
"""

from __future__ import annotations

import os
import tempfile
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig
from ray_tpu_torch.tune.schedulers import (
    CONTINUE,
    STOP,
    FIFOScheduler,
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_tpu_torch.tune.search import BasicVariantGenerator, Searcher
from ray_tpu_torch.tune.trial import (
    ERRORED,
    RUNNING,
    TERMINATED,
    Trial,
    TrialRunnerActor,
)


_CALL_TIMEOUT_S = 60.0  # a trial actor's stop()


@dataclass
class TuneConfig:
    """Reference: python/ray/tune/tune_config.py."""

    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    search_alg: Optional[Searcher] = None
    scheduler: Optional[TrialScheduler] = None
    seed: Optional[int] = None
    resources_per_trial: Dict[str, float] = field(
        default_factory=lambda: {"num_cpus": 1})


@dataclass
class Result:
    """Reference: python/ray/air/result.py."""

    metrics: Optional[dict]
    config: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    path: str
    error: Optional[str] = None

    @property
    def metrics_dataframe(self):
        import pandas as pd

        return pd.DataFrame([self.metrics]) if self.metrics else None


class ResultGrid:
    """Reference: python/ray/tune/result_grid.py."""

    def __init__(self, results: List[Result], metric: Optional[str],
                 mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    @property
    def errors(self) -> List[str]:
        return [r.error for r in self._results if r.error]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        sign = 1.0 if mode == "max" else -1.0
        candidates = [r for r in self._results
                      if r.metrics and metric in r.metrics]
        if not candidates:
            raise ValueError(f"no trial reported metric {metric!r}")
        return max(candidates,
                   key=lambda r: sign * float(r.metrics[metric]))

    def get_dataframe(self):
        import pandas as pd

        rows = []
        for r in self._results:
            row = dict(r.metrics or {})
            row.update({f"config/{k}": v for k, v in r.config.items()})
            rows.append(row)
        return pd.DataFrame(rows)


class Tuner:
    def __init__(self, trainable: Callable[[dict], Any], *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None):
        self._trainable = trainable
        self._param_space = param_space or {}
        self._tune = tune_config or TuneConfig()
        self._run = run_config or RunConfig()

    def fit(self) -> ResultGrid:
        tc = self._tune
        searcher = tc.search_alg or BasicVariantGenerator(
            self._param_space, tc.num_samples, seed=tc.seed)
        # Reference parity: Tuner hands param_space to the searcher; a
        # user-built searcher may also have called set_search_space itself.
        if (tc.search_alg is not None and self._param_space
                and hasattr(searcher, "set_search_space")
                and not getattr(searcher, "_space", None)):
            searcher.set_search_space(self._param_space)
        scheduler = tc.scheduler or FIFOScheduler()
        if tc.metric:
            scheduler.set_metric(tc.metric, tc.mode)
        exp_name = self._run.name or f"tune_{uuid.uuid4().hex[:8]}"
        storage = os.path.join(
            self._run.storage_path
            or os.path.join(tempfile.gettempdir(), "ray_tpu_torch_results"),
            exp_name)
        os.makedirs(storage, exist_ok=True)

        # Grid/random variants are enumerable up front; ADAPTIVE searchers
        # (TPE & co) are consulted lazily as slots free, so each suggestion
        # sees every completed result (reference: SearchGenerator).
        trials: List[Trial] = []
        adaptive = not isinstance(searcher, BasicVariantGenerator)
        next_idx = 0

        def suggest_one() -> Optional[Trial]:
            nonlocal next_idx
            tid = f"trial_{next_idx:05d}"
            cfg = searcher.suggest(tid)
            if cfg is None:
                return None
            trial = Trial(trial_id=tid, config=cfg,
                          trial_dir=os.path.join(storage, tid))
            next_idx += 1
            trials.append(trial)
            return trial

        if not adaptive:
            while suggest_one() is not None:
                pass

        # Adaptive searchers need bounded concurrency — drawing all
        # num_samples up front would mean every suggestion sees zero
        # completed results (pure random search).
        max_conc = (tc.max_concurrent_trials
                    or (min(tc.num_samples, 4) if adaptive
                        else len(trials)))
        pending = list(trials)
        running: List[Trial] = []
        scores: Dict[str, float] = {}
        sign = 1.0 if tc.mode == "max" else -1.0

        # Trial actors run on the shared AIR actor manager (reference:
        # TuneController over RayActorManager, air/execution/_internal/
        # actor_manager.py): completions route via callbacks; one poll is
        # in flight per trial, so a slow trial never stalls the loop.
        from ray_tpu_torch.air.execution import ActorManager

        mgr = ActorManager()
        inbox: List[tuple] = []  # (trial, poll_payload)
        _POLL_PERIOD_S = 0.05

        def on_actor_dead(tracked, msg: str):
            trial = tracked.data
            if trial in running:
                finalize(trial, ERRORED, f"trial actor died: {msg}",
                         kill=False)
                searcher.on_trial_complete(trial.trial_id,
                                           trial.last_result, error=True)

        def on_poll(tracked, payload):
            inbox.append((tracked.data, payload))

        def on_task_error(tracked, exc):
            # a start/poll raising synchronously (bad trial dir, corrupt
            # checkpoint scan) must fail the trial, not strand it PENDING
            trial = tracked.data
            if trial in running:
                finalize(trial, ERRORED, repr(exc))
                searcher.on_trial_complete(trial.trial_id,
                                           trial.last_result, error=True)

        def launch(trial: Trial, restore_from: Optional[str] = None):
            tracked = mgr.add_actor(
                TrialRunnerActor, options=dict(tc.resources_per_trial),
                data=trial, on_actor_dead=on_actor_dead)
            trial.actor = tracked
            trial.status = RUNNING
            trial.next_poll = 0.0
            running.append(trial)
            mgr.schedule_actor_task(
                tracked, "start",
                (self._trainable, trial.config, trial.trial_dir,
                 restore_from),
                on_result=lambda tr, _v: schedule_poll(tr),
                on_error=on_task_error)

        def schedule_poll(tracked):
            mgr.schedule_actor_task(tracked, "poll", on_result=on_poll,
                                    on_error=on_task_error)

        def finalize(trial: Trial, status: str,
                     error: Optional[str] = None, kill: bool = True):
            trial.status = status
            trial.error = error
            running.remove(trial)
            if trial.actor is not None:
                mgr.remove_actor(trial.actor, kill=kill)
                trial.actor = None

        def record(trial: Trial, rep: dict):
            metrics = rep["metrics"]
            trial.reports.append(metrics)
            trial.last_result = metrics
            if rep.get("checkpoint_dir"):
                trial.checkpoint_dir = os.path.join(
                    trial.trial_dir, rep["checkpoint_dir"])
            if tc.metric and tc.metric in metrics:
                s = sign * float(metrics[tc.metric])
                scores[trial.trial_id] = s
                if (trial.best_result is None
                        or s >= sign * float(
                            trial.best_result[tc.metric])):
                    trial.best_result = metrics

        exhausted = not adaptive
        while pending or running or not exhausted:
            if adaptive and not exhausted:
                while (len(pending) + len(running) < max_conc
                       and next_idx < tc.num_samples):
                    t = suggest_one()
                    if t is None:
                        exhausted = True  # searcher ran out of suggestions
                        break
                    pending.append(t)
                if next_idx >= tc.num_samples:
                    exhausted = True
            while pending and len(running) < max_conc:
                launch(pending.pop(0))
            # re-arm polls that are due (pacing: a trial with no new
            # reports is polled every _POLL_PERIOD_S, not continuously)
            now = time.monotonic()
            for trial in running:
                if (trial.actor is not None and trial.actor.in_flight == 0
                        and now >= getattr(trial, "next_poll", 0.0)):
                    trial.next_poll = now + _POLL_PERIOD_S
                    schedule_poll(trial.actor)
            mgr.wait(timeout=_POLL_PERIOD_S)
            polls, inbox[:] = list(inbox), []
            for trial, poll in polls:
                if trial not in running:
                    continue
                stopped_or_relaunched = False
                for rep in poll["reports"]:
                    record(trial, rep)
                    if rep.get("final"):
                        continue
                    # Heartbeat reports without the tune metric pass through
                    # (reference logs a warning rather than crashing).
                    decision = scheduler.on_result(
                        trial.trial_id, rep["metrics"]) \
                        if tc.metric and tc.metric in rep["metrics"] \
                        else CONTINUE
                    if decision == STOP:
                        ray_tpu_torch.get(trial.actor.handle.stop.remote(),
                                          timeout=_CALL_TIMEOUT_S)
                        finalize(trial, TERMINATED)
                        searcher.on_trial_complete(
                            trial.trial_id, trial.last_result)
                        stopped_or_relaunched = True
                        break
                    src_id = scheduler.exploit_decision(
                        trial.trial_id, rep["metrics"], scores) \
                        if isinstance(scheduler, PopulationBasedTraining) \
                        else None
                    if src_id is not None and src_id != trial.trial_id:
                        src = next(t for t in trials
                                   if t.trial_id == src_id)
                        if src.checkpoint_dir:
                            # exploit: restart from the stronger trial's
                            # checkpoint with a perturbed config
                            ray_tpu_torch.get(
                                trial.actor.handle.stop.remote(),
                                timeout=_CALL_TIMEOUT_S)
                            finalize(trial, TERMINATED)
                            trial.config = scheduler.perturb(src.config)
                            launch(trial,
                                   restore_from=src.checkpoint_dir)
                            stopped_or_relaunched = True
                            break
                if stopped_or_relaunched:
                    continue
                if trial in running and poll["status"] in (
                        TERMINATED, ERRORED):
                    finalize(trial, poll["status"], poll["error"])
                    searcher.on_trial_complete(
                        trial.trial_id, trial.last_result,
                        error=poll["status"] == ERRORED)
                elif poll["reports"]:
                    # fresh data: poll again without the pacing delay
                    trial.next_poll = 0.0

        results = []
        for trial in trials:
            ckpt = (Checkpoint(trial.checkpoint_dir)
                    if trial.checkpoint_dir else None)
            results.append(Result(
                metrics=trial.best_result or trial.last_result,
                config=trial.config, checkpoint=ckpt,
                path=trial.trial_dir, error=trial.error))
        return ResultGrid(results, tc.metric, tc.mode)
