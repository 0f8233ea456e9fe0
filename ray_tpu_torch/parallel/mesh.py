"""Device-mesh management: one ``DeviceMesh`` whose named dims carry every
parallelism strategy.

Counterpart of ``ray_tpu/parallel/mesh.py``.  The mesh's dims are
``AXIS_ORDER``, outermost first: data parallel (``dp``), ZeRO/FSDP
sharded-data parallel (``fsdp``), tensor parallel (``tp``), sequence
parallel (``sp``), expert parallel (``ep``), pipeline stages (``pp``) and
``dcn`` for slices.  A rank's sub-group for an axis is
``mesh.get_group(axis)`` and its coordinate ``mesh.get_local_rank(axis)``;
``axes_group`` is the group over a product of axes, which a dim split over
several axes needs.

A ``DeviceMesh`` needs an initialised process group
(``torch.distributed.init_process_group`` with an explicit address, world
size and rank): ``create_mesh`` lays its dims over the group's ranks and
raises without one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

# Canonical axis order, outermost-first.  dcn MUST stay outermost: it is
# the only axis whose neighbouring devices are not on one fast fabric.
AXIS_ORDER = ("dcn", "pp", "dp", "fsdp", "ep", "sp", "tp")


@dataclass(frozen=True)
class MeshConfig:
    """Sizes of each parallelism axis; -1 on at most one axis means "fill
    with the remaining devices".  ``dcn`` is the number of slices."""

    dcn: int = 1
    dp: int = 1
    fsdp: int = -1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    def resolved(self, num_devices: int) -> dict[str, int]:
        sizes = {"dcn": self.dcn, "pp": self.pp, "dp": self.dp,
                 "fsdp": self.fsdp, "ep": self.ep, "sp": self.sp,
                 "tp": self.tp}
        fills = [k for k, v in sizes.items() if v == -1]
        if len(fills) > 1:
            raise ValueError(f"only one axis may be -1, got {fills}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if fills:
            if num_devices % fixed != 0:
                raise ValueError(
                    f"{num_devices} devices not divisible by fixed axes "
                    f"product {fixed}")
            sizes[fills[0]] = num_devices // fixed
        elif fixed != num_devices:
            raise ValueError(
                f"mesh axes product {fixed} != device count {num_devices}")
        return sizes


def create_mesh(config: Optional[MeshConfig] = None,
                device_type: Optional[str] = None):
    """A ``DeviceMesh`` over the initialised process group's ranks, shaped
    by ``config.resolved(world_size)`` with dims named ``AXIS_ORDER``;
    rank ``r`` sits at the row-major coordinates of ``r``, so ``tp`` is the
    innermost dim.  Ranks carry no slice index, so with ``dcn > 1``
    contiguous rank blocks stand for slices (the JAX package's order for
    devices without ``slice_index``).  ``device_type`` defaults to
    ``"cuda"``; the CPU tests pass ``"cpu"`` (gloo)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "create_mesh needs an initialised process group: call "
            "torch.distributed.init_process_group with an address, world "
            "size and rank first")
    config = config or MeshConfig()
    world = dist.get_world_size()
    sizes = config.resolved(world)
    shape = tuple(sizes[a] for a in AXIS_ORDER)
    return init_device_mesh(device_type or "cuda", shape,
                            mesh_dim_names=AXIS_ORDER)


def single_device_mesh(device_type: Optional[str] = None):
    """The all-ones mesh over a process group of world size 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() != 1:
        raise ValueError("single_device_mesh needs a process group of world "
                         f"size 1, not {dist.get_world_size()}")
    return create_mesh(MeshConfig(fsdp=1), device_type)


def mesh_axis_size(mesh, *axes: str) -> int:
    """Product of the named axes' sizes; an axis the mesh lacks counts 1.
    ``mesh=None`` is one device."""
    if mesh is None:
        return 1
    names = mesh.mesh_dim_names
    return math.prod(mesh.size(names.index(a)) if a in names else 1
                     for a in axes)


def axes_group(mesh, axes):
    """The process group of this rank over the product of the mesh axes
    ``axes`` (a name, or names in the mesh's order).  Its ranks run major
    to minor, as JAX's ``NamedSharding`` lays out a dim split over those
    axes, so a member's rank in the group is the index of its block
    (``sharding.local_block``).  One axis is ``mesh.get_group(axis)``.

    ``new_group`` is collective: the first call for a tuple makes the
    groups of every block row, so every rank of the mesh must make it at
    the same point of its program; later calls reuse them."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    groups = mesh.__dict__.setdefault("_axes_groups", {})
    if axes not in groups:
        import torch.distributed as dist

        names = list(mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims) or len(set(dims)) != len(dims):
            raise ValueError(f"axes {axes} are not distinct and in the "
                             f"mesh's order {tuple(names)}")
        others = [d for d in range(len(names)) if d not in dims]
        width = math.prod(mesh.size(d) for d in dims)
        rows = mesh.mesh.permute(*others, *dims).reshape(-1, width)
        me = dist.get_rank()
        for row in rows:  # the mesh's host tensor of ranks, row-major
            row = [int(r) for r in row]
            group = dist.new_group(row)
            if me in row:
                groups[axes] = group
    return groups[axes]


@dataclass
class MeshContext:
    """Holds the active mesh + logical sharding rules for a worker."""

    mesh: object
    rules: dict = field(default_factory=dict)

    @property
    def num_devices(self) -> int:
        return self.mesh.size()


# Process-global active mesh context, which mesh members install.
_ACTIVE_CTX: Optional[MeshContext] = None


def set_active_mesh_context(ctx: Optional[MeshContext]) -> None:
    global _ACTIVE_CTX
    _ACTIVE_CTX = ctx


def active_mesh_context() -> Optional[MeshContext]:
    return _ACTIVE_CTX
