"""Build helpers for the port runtime's native (C++) components.

Compiles the shared-memory object store daemon (``shm_store.cc``), the GCS
daemon, the mutable channel and the ``_rtpu_core`` extension with g++ on
first use, caching the result under ``ray_tpu_torch/_build/native/``.  The
sources are copies of the JAX package's, byte for byte but for comments
that cite the reference's sources.  The cache key is
a hash of the sources (plus the ``RTPU_SANITIZE`` mode) so edits trigger
a rebuild; there is no runtime dependency beyond libc/pthread/rt.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

_NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_NATIVE_DIR), "_build", "native")

_BINARIES = {
    "shm_store": {
        "sources": ["shm_store.cc"],
        "flags": ["-O2", "-std=c++17", "-pthread"],
        "libs": ["-lrt"],
    },
    "libmutable_channel": {
        "sources": ["mutable_channel.cc"],
        "flags": ["-O2", "-std=c++17", "-pthread", "-shared", "-fPIC"],
        "libs": ["-lrt"],
        "suffix": ".so",
    },
    "gcs_server": {
        "sources": ["gcs_server.cc"],
        "headers": ["wire.h"],
        "flags": ["-O2", "-std=c++17", "-pthread"],
        "libs": [],
    },
    # CPython extension module (direct-call transport core).  Compiled
    # against this interpreter's headers; symbols resolve at import time,
    # so no -lpython is needed on Linux.
    "_rtpu_core": {
        "sources": ["core_worker.cc"],
        "flags": ["-O2", "-std=c++17", "-pthread", "-shared", "-fPIC"],
        "libs": [],
        "suffix": ".so",
        "python_ext": True,
    },
}


def _source_hash(sources: list[str]) -> str:
    h = hashlib.sha256()
    for src in sources:
        with open(os.path.join(_NATIVE_DIR, src), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


# RTPU_SANITIZE selects an instrumented build (separate cache namespace,
# so sanitized and fast binaries coexist):
#   address (or the legacy "1") -> ASan+UBSan   (`make sanitize`)
#   thread                      -> TSan         (`make sanitize-store`)
def _sanitize_mode() -> str:
    raw = os.environ.get("RTPU_SANITIZE", "").strip().lower()
    if raw in ("", "0", "false", "off"):
        return ""
    if raw in ("1", "address", "asan"):
        return "asan"
    if raw in ("thread", "tsan"):
        return "tsan"
    raise ValueError(
        f"RTPU_SANITIZE={raw!r}: expected 'address' (or legacy '1') "
        "or 'thread'")


_SANITIZE = _sanitize_mode()
_SAN_FLAGS = {
    "asan": ["-fsanitize=address,undefined", "-fno-omit-frame-pointer",
             "-g", "-O1"],
    "tsan": ["-fsanitize=thread", "-fno-omit-frame-pointer", "-g", "-O1"],
}


def binary_path(name: str) -> str:
    """Return the path to a built native binary, compiling it if needed."""
    spec = _BINARIES[name]
    # headers participate in the cache key but not the compile line
    tag = _source_hash(spec["sources"] + spec.get("headers", []))
    if _SANITIZE:
        tag += f"-{_SANITIZE}"
    out = os.path.join(_BUILD_DIR,
                       f"{name}-{tag}{spec.get('suffix', '')}")
    if _SANITIZE and spec.get("suffix") == ".so" \
            and _SANITIZE not in os.environ.get("LD_PRELOAD", ""):
        # Loading a sanitizer-linked DSO into an uninstrumented
        # interpreter aborts the process with a cryptic "runtime does
        # not come first" — fail actionably instead.  Standalone daemon
        # binaries (shm_store, gcs_server) need no preload: the runtime
        # links into the executable itself.
        lib = "libasan/libubsan" if _SANITIZE == "asan" else "libtsan"
        raise RuntimeError(
            f"RTPU_SANITIZE={_SANITIZE} requires {lib} in LD_PRELOAD to "
            "load instrumented extension modules; use `make sanitize` / "
            "`make sanitize-store`")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    srcs = [os.path.join(_NATIVE_DIR, s) for s in spec["sources"]]
    tmp = out + f".tmp.{os.getpid()}"
    flags = list(spec["flags"])
    if _SANITIZE:
        flags = ([f for f in flags if not f.startswith("-O")]
                 + _SAN_FLAGS[_SANITIZE])
    if spec.get("python_ext"):
        import sysconfig

        flags.append(f"-I{sysconfig.get_paths()['include']}")
    cmd = ["g++", *flags, *srcs, "-o", tmp, *spec["libs"]]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, out)  # atomic: concurrent builders race benignly
    return out


def load_extension(name: str):
    """Import a compiled CPython extension module by build name."""
    import importlib.util

    path = binary_path(name)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
