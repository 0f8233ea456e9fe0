"""ray_tpu_torch.util.collective: host-plane collectives between actors/tasks.

In-program collectives between the ranks of one program belong to
torch.distributed process groups — see ray_tpu_torch.parallel.  This package
coordinates across actors and tasks, the role the reference's NCCL/Gloo
groups play (Ray's python/ray/util/collective/).
"""

from ray_tpu_torch.util.collective.collective import (
    ReduceOp,
    allgather,
    allreduce,
    barrier,
    broadcast,
    declare_collective_group,
    destroy_collective_group,
    get_collective_group_size,
    get_rank,
    init_collective_group,
    is_group_initialized,
    recv,
    reducescatter,
    send,
)

__all__ = [
    "ReduceOp",
    "allgather",
    "allreduce",
    "barrier",
    "broadcast",
    "declare_collective_group",
    "destroy_collective_group",
    "get_collective_group_size",
    "get_rank",
    "init_collective_group",
    "is_group_initialized",
    "recv",
    "reducescatter",
    "send",
]
