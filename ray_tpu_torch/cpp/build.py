"""Build the port's C++ worker API and its example programs.

Compiles ``src/client.cc`` and each program of ``examples/`` with g++ on
first use (never at import), in the manner of ``native/build.py``: the
objects are compiled in parallel, one g++ each, then each program is
linked.  Output goes to ``ray_tpu_torch/_build/cpp/<hash>/``, keyed by a
hash of every source and header it reads, so an edit rebuilds.  The
include path names only directories of ``ray_tpu_torch/``: the client's
own headers and ``native/wire.h``.  A missing g++ or a failed build
raises; there is no fallback.

    from ray_tpu_torch.cpp.build import build
    paths = build("demo", "generate")   # {"demo": ".../demo", ...}
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

_CPP_DIR = os.path.dirname(os.path.abspath(__file__))
_PKG_DIR = os.path.dirname(_CPP_DIR)
_BUILD_DIR = os.path.join(_PKG_DIR, "_build", "cpp")

INCLUDE_DIRS = (os.path.join(_PKG_DIR, "native"),
                os.path.join(_CPP_DIR, "include"))
CXXFLAGS = ("-std=c++17", "-O2")
CLIENT_SOURCE = os.path.join(_CPP_DIR, "src", "client.cc")
HEADERS = (os.path.join(_PKG_DIR, "native", "wire.h"),
           os.path.join(_CPP_DIR, "include", "ray_tpu_torch", "client.h"))


def programs() -> list[str]:
    """The example programs ``build`` can make, by name."""
    return sorted(f[:-3] for f in os.listdir(os.path.join(_CPP_DIR,
                                                          "examples"))
                  if f.endswith(".cc"))


def _example(name: str) -> str:
    return os.path.join(_CPP_DIR, "examples", f"{name}.cc")


def include_flags() -> list[str]:
    return [f"-I{d}" for d in INCLUDE_DIRS]


def _build_dir() -> str:
    """The cache directory for the current sources."""
    h = hashlib.sha256()
    for path in (*HEADERS, CLIENT_SOURCE,
                 *(_example(n) for n in programs())):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(CXXFLAGS).encode())
    return os.path.join(_BUILD_DIR, h.hexdigest()[:16])


def _run(procs) -> None:
    """Wait for every (command, process); raise on the first that failed."""
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{err.decode(errors='replace')}")
    if failed:
        raise RuntimeError("C++ client build failed:\n" + "\n".join(failed))


def build(*names: str) -> dict[str, str]:
    """Paths to the example programs ``names`` (all when none is given),
    compiling and linking the ones not built yet."""
    names = names or tuple(programs())
    unknown = set(names) - set(programs())
    if unknown:
        raise ValueError(f"no example program {sorted(unknown)} in "
                         f"{os.path.join(_CPP_DIR, 'examples')}")
    out_dir = _build_dir()
    paths = {n: os.path.join(out_dir, n) for n in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if not todo:
        return paths
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("the C++ client needs g++, which is not on PATH")
    os.makedirs(out_dir, exist_ok=True)
    tag = f".tmp.{os.getpid()}"
    objects = {"client": CLIENT_SOURCE, **{n: _example(n) for n in todo}}
    obj_path = {k: os.path.join(out_dir, f"{k}.o{tag}") for k in objects}
    try:
        compiles = []
        for key, src in objects.items():
            cmd = [gxx, *CXXFLAGS, *include_flags(), "-c", src, "-o",
                   obj_path[key]]
            compiles.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)))
        _run(compiles)
        links = []
        for n in todo:
            cmd = [gxx, *CXXFLAGS, obj_path["client"], obj_path[n], "-o",
                   paths[n] + tag]
            links.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)))
        _run(links)
        for n in todo:
            # atomic: concurrent builds race benignly
            os.replace(paths[n] + tag, paths[n])
    finally:
        for path in [*obj_path.values(), *(paths[n] + tag for n in todo)]:
            if os.path.exists(path):
                os.unlink(path)
    return paths
