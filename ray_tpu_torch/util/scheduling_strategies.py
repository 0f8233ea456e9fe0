"""Scheduling strategies (counterpart of
Ray's python/ray/util/scheduling_strategies.py:15,41,135)."""

from __future__ import annotations

from typing import Optional


class PlacementGroupSchedulingStrategy:
    def __init__(
        self,
        placement_group,
        placement_group_bundle_index: int = -1,
        placement_group_capture_child_tasks: bool = False,
    ):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = (
            placement_group_capture_child_tasks
        )


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id, soft: bool = False):
        self.node_id = node_id
        self.soft = soft


class NodeLabelSchedulingStrategy:
    def __init__(self, hard: Optional[dict] = None, soft: Optional[dict] = None):
        self.hard = hard or {}
        self.soft = soft or {}


# Label-match operators for NodeLabelSchedulingStrategy.
class In:
    def __init__(self, *values):
        self.values = list(values)


class NotIn:
    def __init__(self, *values):
        self.values = list(values)


class Exists:
    pass


class DoesNotExist:
    pass


def labels_match(selector: dict, labels: dict) -> bool:
    """Evaluate a label selector against a node's labels (reference:
    NodeLabelSchedulingStrategy operators,
    python/ray/util/scheduling_strategies.py:135)."""
    labels = labels or {}
    for key, cond in (selector or {}).items():
        present = key in labels
        value = labels.get(key)
        if isinstance(cond, In):
            if not present or value not in cond.values:
                return False
        elif isinstance(cond, NotIn):
            if present and value in cond.values:
                return False
        elif isinstance(cond, Exists):
            if not present:
                return False
        elif isinstance(cond, DoesNotExist):
            if present:
                return False
        else:  # plain value: exact match
            if not present or value != cond:
                return False
    return True
