"""Feature-usage recording (no egress).

Counterpart of Ray's python/ray/_private/usage/usage_lib.py —
the reference phones usage home unless opted out; this deployment target is
air-gapped, so tags are only recorded to the session directory for operator
inspection (`rtpu status` surfaces nothing unless you look). Env
RAY_TPU_USAGE_STATS_DISABLED=1 disables even local recording.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict

_lock = threading.Lock()
_tags: Dict[str, str] = {}


def usage_stats_enabled() -> bool:
    return os.environ.get("RAY_TPU_USAGE_STATS_DISABLED", "0") != "1"


def record_library_usage(name: str) -> None:
    record_extra_usage_tag(f"library_{name}", "1")


def record_extra_usage_tag(key: str, value: str) -> None:
    if not usage_stats_enabled():
        return
    with _lock:
        _tags[key] = value
    _flush_best_effort()


def get_recorded_tags() -> Dict[str, str]:
    with _lock:
        return dict(_tags)


def _flush_best_effort() -> None:
    try:
        from ray_tpu_torch._private.worker import global_worker_or_none

        ctx = global_worker_or_none()
        node = getattr(ctx, "node", None)
        if node is None:
            return
        path = os.path.join(node.session_dir, "usage_tags.json")
        with _lock:
            payload = {"ts": time.time(), "tags": dict(_tags)}
        with open(path, "w") as f:
            json.dump(payload, f)
    except Exception:
        pass
