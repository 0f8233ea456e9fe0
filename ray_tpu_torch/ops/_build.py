"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` into ``ray_tpu_torch/_build/``
under a name keyed on a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads at once.  ``build`` starts one ``nvcc``
per missing library, all together, and waits for them.  Nothing here runs
when the module is imported: the CPU never builds or loads a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

# The nvcc builds this process ran, and their wall seconds: what the
# runtime's device telemetry reports as the port's compile counters.
_build_lock = threading.Lock()
_builds = {"count": 0, "seconds": 0.0}


def build_stats() -> Dict[str, float]:
    """``{"count": n, "seconds": s}``: the libraries this process compiled
    (one per ``nvcc``) and the wall seconds from their start to the end of
    each.  A library found already built counts nothing."""
    with _build_lock:
        return dict(_builds)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA toolkit is "
            "needed to build the port's kernels")
    return str(path)


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed on the sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started at once.  Raises with the compiler's
    output if any fails.  The ptxas report (registers, shared memory,
    spills) is kept beside each library as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    t0 = time.monotonic()
    for name, so in paths.items():
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        so.with_name(so.name + ".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, so)  # atomic: a concurrent builder sees all or none
        with _build_lock:
            _builds["count"] += 1
            _builds["seconds"] += time.monotonic() - t0
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return paths


def library(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed.
    ``bind`` declares argtypes/restype of its C entry points once."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            bind(lib)
            _libs[name] = lib
        return lib
