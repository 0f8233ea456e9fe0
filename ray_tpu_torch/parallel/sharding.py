"""Logical-axis sharding rules: partition specs from semantic axis names.

Counterpart of ``ray_tpu/parallel/sharding.py``.  Model code names each
parameter's axes logically ("embed", "heads", "experts", ...); a rules
table maps logical names to mesh axes, so one model definition serves every
parallelism layout.  ``to_partition_spec`` gives the entries a JAX
``PartitionSpec`` holds (``None``, a mesh-axis name or a tuple of names);
``placements`` turns such a spec into DTensor placements over a
``DeviceMesh`` and ``shard_tree`` distributes a parameter tree by them.
``LocalShards`` is how a forward computes on a rank's local blocks: it
all-gathers the dims that the model uses whole and names the group of the
dims it keeps local (tensor parallelism).

``shard_map`` has no counterpart: the torch code is already per-rank SPMD.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple, Union

# Default rules for transformer LMs.  Values are mesh axis names (or tuples
# thereof), None = replicated.  The dcn (multi-slice) axis carries plain
# data parallelism.
DEFAULT_RULES: dict[str, Union[str, tuple, None]] = {
    "batch": ("dcn", "dp", "fsdp"),
    "seq": "sp",           # sequence/context parallelism
    "embed": "fsdp",       # ZeRO-style param sharding
    "heads": "tp",
    "kv_heads": "tp",
    "head_dim": None,
    "mlp": "tp",
    "vocab": "tp",
    "experts": "ep",
    "expert_mlp": "tp",
    "stage": "pp",
    "norm": None,
    "layers": None,        # the stacked-layer dim stays whole
}

# Spec-entry spelling for intentional replication, alongside plain None.
REPLICATED = "replicated"


def logical_spec(*names: Optional[str]) -> tuple:
    """A logical partition spec: tuple of logical axis names (None or
    ``"replicated"`` = replicated on purpose)."""
    return tuple(names)


def _entry(axes):
    """A rule's value as ``PartitionSpec`` stores it: a sequence of mesh
    axes becomes a tuple, an empty one None and a single one its name."""
    if isinstance(axes, (tuple, list)):
        axes = tuple(axes)
        return None if not axes else axes[0] if len(axes) == 1 else axes
    return axes


def to_partition_spec(logical: tuple, rules: Optional[dict] = None) -> tuple:
    """Map a logical spec through a rules table to partition-spec entries,
    one per tensor dim: ``None``, a mesh-axis name or a tuple of names.

    An axis name absent from the rules raises: silently replicating a
    typo'd name costs memory and comm without any error.  Spell
    intentional replication ``None`` or ``"replicated"`` in the spec, or add
    a ``name: None`` rule."""
    rules = DEFAULT_RULES if rules is None else rules
    axes = []
    for name in logical:
        if name is None or name == REPLICATED:
            axes.append(None)
        elif name in rules:
            axes.append(_entry(rules[name]))
        else:
            raise ValueError(
                f"unknown logical axis {name!r}: not in the sharding rules "
                f"(known: {sorted(rules)}). Use None or 'replicated' for "
                "intentional replication, or add a rule for it.")
    return tuple(axes)


def tree_partition_specs(logical_tree, rules: Optional[dict] = None):
    """``to_partition_spec`` over a nested dict of logical specs."""
    if isinstance(logical_tree, dict):
        return {k: tree_partition_specs(v, rules)
                for k, v in logical_tree.items()}
    return to_partition_spec(logical_tree, rules)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of partition-spec entries ``spec`` on ``mesh``:
    for each mesh dim, ``Shard(d)`` where tensor dim ``d``'s entry names it,
    else ``Replicate()``.

    JAX shards a tensor dim over a tuple of mesh axes major-to-minor in the
    tuple's order; DTensor shards it over mesh dims in mesh order.  The two
    layouts agree only when the tuple follows the mesh's order, so a tuple
    out of that order raises, as does a mesh axis named twice or one the
    mesh lacks."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    seen = set()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for axis in axes:
            if axis not in names:
                raise ValueError(f"mesh axis {axis!r} of spec {spec} is not "
                                 f"in the mesh {tuple(names)}")
            if axis in seen:
                raise ValueError(f"mesh axis {axis!r} shards two tensor dims "
                                 f"in spec {spec}")
            seen.add(axis)
            out[names.index(axis)] = Shard(dim)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(
                f"spec entry {entry} shards tensor dim {dim} over mesh axes "
                f"out of the mesh's order {tuple(names)}: DTensor would lay "
                "the shards out differently from JAX")
    return tuple(out)


def _axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one partition-spec entry, major to minor."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_size(mesh, axis: str) -> int:
    return mesh.size(list(mesh.mesh_dim_names).index(axis))


def local_block(tensor, spec: tuple, mesh):
    """The block of ``tensor`` that ``spec`` puts on this rank of ``mesh``:
    each sharded dim split evenly over its axes, major to minor, at the
    rank's coordinates (JAX's ``NamedSharding`` layout).  A view where no
    dim is split, else a contiguous copy."""
    placements(spec, mesh)  # validates the spec against the mesh
    for dim, entry in enumerate(spec):
        n, idx = 1, 0
        for axis in _axes(entry):
            size = _axis_size(mesh, axis)
            n, idx = n * size, idx * size + mesh.get_local_rank(axis)
        if n == 1:
            continue
        if tensor.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {tensor.shape[dim]} does "
                             f"not split evenly over {_axes(entry)} ({n})")
        per = tensor.shape[dim] // n
        tensor = tensor.narrow(dim, idx * per, per).contiguous()
    return tensor


def shard_tree(tree, logical_tree, mesh, rules: Optional[dict] = None):
    """Distribute a nested dict of tensors over ``mesh`` by its logical
    specs: each leaf becomes a DTensor whose local shard on every rank is
    the block JAX's ``NamedSharding`` puts on the device at the same mesh
    coordinates.  Each rank takes its block of the tensor it holds, with
    no communication, so every rank of the mesh must call it with the same
    tensors."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: shard_tree(v, logical_tree[k], mesh, rules)
                for k, v in tree.items()}
    spec = to_partition_spec(logical_tree, rules)
    return DTensor.from_local(local_block(tree, spec, mesh), mesh,
                              placements(spec, mesh), run_check=False,
                              shape=tree.shape, stride=tree.stride())


class LocalShards:
    """How a forward computes on a rank's local parameter blocks.

    ``local`` names the logical axes the model keeps split (its
    tensor-parallel dims, which it pairs with ``collectives.replicate`` /
    ``sum_replicated``); every other sharded dim is all-gathered before
    use by ``gather``, whose backward sums the cotangents over the axis
    and keeps the rank's block.  ``gathered_axes`` and ``sharded_axes``
    tell the train step which reductions a leaf's gradient has had."""

    def __init__(self, mesh, rules: Optional[dict] = None,
                 local: Iterable[str] = ()):
        self.mesh, self.rules, self.local = mesh, rules, tuple(local)

    def _split(self, logical: tuple) -> List[Tuple[int, str, Tuple]]:
        """(dim, logical name, mesh axes of size > 1) of each split dim."""
        spec = to_partition_spec(logical, self.rules)
        out = []
        for dim, (name, entry) in enumerate(zip(logical, spec)):
            axes = tuple(a for a in _axes(entry)
                         if _axis_size(self.mesh, a) > 1)
            if axes:
                out.append((dim, name, axes))
        return out

    def gathered_axes(self, logical: tuple) -> Tuple[str, ...]:
        """Mesh axes ``gather`` all-gathers a leaf of this spec over."""
        return tuple(a for _, name, axes in self._split(logical)
                     if name not in self.local for a in axes)

    def sharded_axes(self, logical: tuple) -> Tuple[str, ...]:
        """Every mesh axis of size > 1 that splits a leaf of this spec."""
        return tuple(a for _, _, axes in self._split(logical) for a in axes)

    def data_axes(self) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
        """The mesh axes of size > 1 that split the batch and the
        sequence (the rules' "batch" and "seq" entries), major to minor."""
        return tuple(tuple(a for a in _axes(entry)
                           if _axis_size(self.mesh, a) > 1)
                     for entry in to_partition_spec(("batch", "seq"),
                                                    self.rules))

    def group(self, name: str):
        """The process group of the mesh axis that splits logical axis
        ``name``, or None where it is whole."""
        axes = self._split((name,))
        if not axes:
            return None
        if len(axes[0][2]) != 1:
            raise NotImplementedError(
                f"logical axis {name!r} is split over {axes[0][2]}; a local "
                "dim takes one mesh axis")
        return self.mesh.get_group(axes[0][2][0])

    def gather(self, tree, logical_tree):
        """``tree`` with every leaf's non-local split dims all-gathered
        (minor axis first, so the blocks land in JAX's order)."""
        from ray_tpu_torch.parallel import collectives

        if isinstance(tree, dict):
            return {k: self.gather(v, logical_tree[k])
                    for k, v in tree.items()}
        for dim, name, axes in self._split(logical_tree):
            if name in self.local:
                continue
            for axis in reversed(axes):
                tree = collectives.all_gather(
                    tree, self.mesh.get_group(axis), dim)
        return tree
