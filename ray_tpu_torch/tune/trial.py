"""Trial state + the runner actor that executes one trial.

Counterpart of ``ray_tpu/tune/trial.py``; that is, of the reference's
Trial FSM + function-trainable runner
(Ray's python/ray/tune/experiment/trial.py,
tune/trainable/function_trainable.py): the user's ``fn(config)`` runs on a
thread inside a dedicated actor; ``ray_tpu_torch.tune.report`` enqueues
metrics
(and persists checkpoints into the trial dir); the controller polls for new
reports and can stop / checkpoint-restart the trial (PBT exploit).
"""

from __future__ import annotations

import os
import queue as queue_mod
import threading
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint

PENDING = "PENDING"
RUNNING = "RUNNING"
TERMINATED = "TERMINATED"
ERRORED = "ERRORED"


@dataclass
class Trial:
    trial_id: str
    config: Dict[str, Any]
    status: str = PENDING
    last_result: Optional[dict] = None
    best_result: Optional[dict] = None
    reports: List[dict] = field(default_factory=list)
    checkpoint_dir: Optional[str] = None  # latest persisted checkpoint
    error: Optional[str] = None
    actor: Any = None  # TrackedActor while running (air.execution)
    trial_dir: str = ""
    next_poll: float = 0.0  # ActorManager pacing (tuner.py)


class _TuneSession:
    """Per-trial-process context backing ``ray_tpu_torch.tune.report`` and
    ``get_checkpoint`` (reference: tune's session in
    train._internal.session)."""

    def __init__(self, trial_dir: str, restore_from: Optional[str]):
        self.trial_dir = trial_dir
        self.restore_from = restore_from
        self.outbox: queue_mod.Queue = queue_mod.Queue()
        self.stop_event = threading.Event()
        # Resume numbering after existing checkpoints so a PBT-restarted
        # trial never merges new files into a stale checkpoint_N dir.
        existing = [int(d.split("_")[1]) for d in os.listdir(trial_dir)
                    if d.startswith("checkpoint_")
                    and d.split("_")[1].isdigit()] \
            if os.path.isdir(trial_dir) else []
        self.index = max(existing, default=0)


_session: Optional[_TuneSession] = None


def get_session() -> Optional[_TuneSession]:
    return _session


class _StopTrial(BaseException):
    """Raised inside the trial fn when the scheduler stops it early; a
    BaseException so user ``except Exception`` blocks don't swallow it
    (mirror of train/context.py _StopTraining)."""


class TrialRunnerActor:
    """One actor per trial (reference: function trainables are remote actors
    driven by TuneController)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._session: Optional[_TuneSession] = None
        self._status = PENDING
        self._error: Optional[str] = None

    def start(self, fn, config: dict, trial_dir: str,
              restore_from: Optional[str] = None) -> str:
        os.makedirs(trial_dir, exist_ok=True)
        global _session
        self._session = _TuneSession(trial_dir, restore_from)
        _session = self._session
        self._status = RUNNING

        def run():
            try:
                out = fn(dict(config))
                if isinstance(out, dict):
                    self._session.outbox.put(
                        {"metrics": out, "checkpoint_dir": None,
                         "final": True})
                self._status = TERMINATED
            except _StopTrial:
                self._status = TERMINATED
            except BaseException:  # noqa: BLE001
                self._error = traceback.format_exc()
                self._status = ERRORED

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return "ok"

    def poll(self) -> dict:
        # Liveness BEFORE draining: a report enqueued between a drain and a
        # later is_alive() check would be lost when the controller finalizes
        # on this poll (the fn thread always enqueues before exiting).
        alive = self._thread is not None and self._thread.is_alive()
        reports = []
        while True:
            try:
                reports.append(self._session.outbox.get_nowait())
            except queue_mod.Empty:
                break
        status = RUNNING if alive else self._status
        return {"reports": reports, "status": status, "error": self._error}

    def stop(self) -> str:
        if self._session is not None:
            self._session.stop_event.set()
        return "ok"

    def join(self, timeout_s: float = 10.0) -> str:
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
        return self._status
