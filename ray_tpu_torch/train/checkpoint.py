"""Checkpoints: directory handles, top-K retention and tensor trees.

Counterpart of ``ray_tpu/train/checkpoint.py``.  ``Checkpoint`` and
``CheckpointManager`` are copies.  Tensor trees go through
``torch.distributed.checkpoint`` where the JAX package uses orbax: under
an initialised process group every rank writes the shards of its
DTensors and one copy of the replicated tensors, and a restore onto
tensors or DTensors of another layout (another world size, another mesh)
reads the blocks each target needs.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Any, Optional

_METADATA_FILE = ".ray_tpu_ckpt_meta.json"
_MANIFEST = "checkpoint_manifest.json"
_SEP = "/"  # joins a leaf's keys into its name in the saved checkpoint


class Checkpoint:
    """A handle to a checkpoint directory on a filesystem."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def to_directory(self, dest: Optional[str] = None) -> str:
        dest = dest or tempfile.mkdtemp(prefix="ckpt_")
        os.makedirs(dest, exist_ok=True)
        for name in os.listdir(self.path):
            src = os.path.join(self.path, name)
            dst = os.path.join(dest, name)
            if os.path.isdir(src):
                shutil.copytree(src, dst, dirs_exist_ok=True)
            else:
                shutil.copy2(src, dst)
        return dest

    @contextlib.contextmanager
    def as_directory(self):
        """Yield a local directory view of the checkpoint (zero-copy here)."""
        yield self.path

    def get_metadata(self) -> dict:
        meta = os.path.join(self.path, _METADATA_FILE)
        if os.path.exists(meta):
            with open(meta) as f:
                return json.load(f)
        return {}

    def set_metadata(self, metadata: dict) -> None:
        with open(os.path.join(self.path, _METADATA_FILE), "w") as f:
            json.dump(metadata, f)

    def __repr__(self):
        return f"Checkpoint(path={self.path!r})"

    def __reduce__(self):
        return (Checkpoint, (self.path,))


def _flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if _SEP in str(k):
                raise ValueError(f"key {k!r} holds {_SEP!r}")
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
        return out
    return {prefix[:-1]: tree}


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split(_SEP)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _distributed() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def save_pytree(ckpt_dir: str, tree: Any, *, name: str = "state") -> int:
    """Persist a nested dict of tensors, DTensors and Python numbers
    (stored as 0-dim tensors) under ``ckpt_dir/name``.  Under a process
    group every rank calls it with its own blocks.  Returns the bytes of
    tensor data this rank holds in the tree (a DTensor's local block)."""
    import torch
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    from torch.distributed.tensor import DTensor

    path = os.path.join(os.path.abspath(ckpt_dir), name)
    distributed = _distributed()
    if not distributed or dist.get_rank() == 0:
        if os.path.exists(path):
            shutil.rmtree(path)
    if distributed:
        dist.barrier()
    flat = {k: v if isinstance(v, torch.Tensor) else torch.tensor(v)
            for k, v in _flatten(tree).items()}
    dcp.save(flat, checkpoint_id=path, no_dist=not distributed)
    return sum((t.to_local() if isinstance(t, DTensor) else t).nbytes
               for t in flat.values())


def load_pytree(ckpt_dir: str, target: Any = None, *, name: str = "state",
                device=None) -> Any:
    """Restore a tree saved by ``save_pytree``.

    With ``target`` (a tree of the same keys holding tensors or DTensors,
    of any layout, and Python numbers) the tensors load in place, each
    reading the blocks it needs: the resharded restore.  Without it every
    tensor loads whole onto ``device`` (CUDA unless ``device="cpu"``)."""
    import torch
    import torch.distributed.checkpoint as dcp

    from ray_tpu_torch._device import resolve_device

    path = os.path.join(os.path.abspath(ckpt_dir), name)
    if target is None:
        dev = resolve_device(device)
        meta = dcp.FileSystemReader(path).read_metadata()
        flat = {k: torch.empty(m.size, dtype=m.properties.dtype, device=dev)
                for k, m in meta.state_dict_metadata.items()}
        dcp.load(flat, checkpoint_id=path, no_dist=not _distributed())
        return _unflatten(flat)
    flat = _flatten(target)
    numbers = {k: v for k, v in flat.items()
               if not isinstance(v, torch.Tensor)}
    holders = dict(flat, **{k: torch.tensor(v) for k, v in numbers.items()})
    dcp.load(holders, checkpoint_id=path, no_dist=not _distributed())
    for k, v in numbers.items():
        holders[k] = type(v)(holders[k].item())
    return _unflatten(holders)


@dataclass
class _CheckpointRecord:
    index: int
    path: str
    metrics: dict = field(default_factory=dict)


class CheckpointManager:
    """Tracks committed checkpoints, keeps top-K, persists a manifest."""

    def __init__(self, experiment_dir: str, config=None):
        from ray_tpu_torch.train.config import CheckpointConfig

        self._dir = experiment_dir
        self._config = config or CheckpointConfig()
        self._records: list[_CheckpointRecord] = []
        self._load_manifest()

    @property
    def latest_checkpoint(self) -> Optional[Checkpoint]:
        if not self._records:
            return None
        return Checkpoint(self._records[-1].path)

    @property
    def latest_index(self) -> int:
        """The report index of the latest committed checkpoint, or -1."""
        return max((r.index for r in self._records), default=-1)

    def best_checkpoints(self) -> list[tuple[Checkpoint, dict]]:
        return [(Checkpoint(r.path), dict(r.metrics)) for r in self._records]

    def register_checkpoint(self, path: str, metrics: dict, index: int) -> None:
        self._records.append(_CheckpointRecord(index, path, dict(metrics)))
        self._evict()
        self._save_manifest()

    def _score(self, rec: _CheckpointRecord):
        attr = self._config.checkpoint_score_attribute
        if attr is None:
            return rec.index
        val = rec.metrics.get(attr)
        if val is None:  # unscored ranks worst in either order
            return float("-inf")
        return val if self._config.checkpoint_score_order == "max" else -val

    def _evict(self):
        k = self._config.num_to_keep
        if k is None or len(self._records) <= k:
            return
        # Never evict the latest (needed for resume); evict lowest-scored rest.
        latest = self._records[-1]
        rest = sorted(self._records[:-1], key=self._score, reverse=True)
        keep = rest[: max(k - 1, 0)] + [latest]
        for rec in rest[max(k - 1, 0):]:
            shutil.rmtree(rec.path, ignore_errors=True)
        self._records = sorted(keep, key=lambda r: r.index)

    def _manifest_path(self) -> str:
        return os.path.join(self._dir, _MANIFEST)

    def _save_manifest(self):
        os.makedirs(self._dir, exist_ok=True)
        data = [{"index": r.index, "path": r.path, "metrics": r.metrics}
                for r in self._records]
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, self._manifest_path())

    def _load_manifest(self):
        try:
            with open(self._manifest_path()) as f:
                data = json.load(f)
            self._records = [
                _CheckpointRecord(d["index"], d["path"], d.get("metrics", {}))
                for d in data if os.path.exists(d["path"])
            ]
        except (OSError, ValueError):
            self._records = []
