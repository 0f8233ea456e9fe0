"""Device and dtype resolution shared by the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU.  Asked for
the GPU where there is none, they raise: they never carry on quietly on the
CPU, where the plain PyTorch versions would stand in for the kernels.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda``.  Raises
    RuntimeError for a CUDA device when CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def torch_dtype(name: Optional[str]) -> torch.dtype:
    """The torch dtype for a config's dtype name ("bfloat16", "float32")."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
