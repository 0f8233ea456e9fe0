"""ray_tpu_torch.dag: lazy DAGs of actor calls + compiled channel execution.

Counterpart of Ray's python/ray/dag/ (aDAG / compiled graphs).
"""

from ray_tpu_torch.dag.channel import Channel, ChannelClosed
from ray_tpu_torch.dag.compiled import CompiledDAG, CompiledDAGRef
from ray_tpu_torch.dag.dag_node import (
    ClassMethodNode,
    DAGNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
)

__all__ = [
    "Channel",
    "ChannelClosed",
    "ClassMethodNode",
    "CompiledDAG",
    "CompiledDAGRef",
    "DAGNode",
    "InputAttributeNode",
    "InputNode",
    "MultiOutputNode",
]
