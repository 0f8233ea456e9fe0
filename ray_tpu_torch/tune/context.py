"""ray_tpu_torch.tune.report / get_checkpoint — the trial-side API.

Counterpart of ``ray_tpu/tune/context.py``; that is, of the reference's
ray.tune.report + get_checkpoint
(Ray's python/ray/tune/trainable/util.py and
python/ray/air/session.py lineage): callable from inside a Tune trial
function; checkpoints are persisted into the trial directory immediately so
the controller (PBT exploit, failure recovery) can clone them.
"""

from __future__ import annotations

import os
from typing import Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.tune import trial as trial_mod


def report(metrics: dict, checkpoint: Optional[Checkpoint] = None) -> None:
    session = trial_mod.get_session()
    if session is None:
        # Allow bare calls outside Tune (e.g. unit-testing a trial fn).
        return
    ckpt_rel = None
    if checkpoint is not None:
        session.index += 1
        ckpt_rel = f"checkpoint_{session.index:06d}"
        dest = os.path.join(session.trial_dir, ckpt_rel)
        checkpoint.to_directory(dest)
    session.outbox.put({"metrics": dict(metrics),
                        "checkpoint_dir": ckpt_rel, "final": False})
    if session.stop_event.is_set():
        raise trial_mod._StopTrial()


def get_checkpoint() -> Optional[Checkpoint]:
    session = trial_mod.get_session()
    if session is None or not session.restore_from:
        return None
    if not os.path.exists(session.restore_from):
        return None
    return Checkpoint(session.restore_from)
