"""Runtime environments: per-task/actor env isolation.

Counterpart of Ray's python/ray/_private/runtime_env/ — the subset
that makes sense on an air-gapped cluster: ``env_vars`` (applied around
execution in the pooled worker), ``working_dir`` and ``py_modules``
(directories zipped into the GCS KV at submission — the reference's
packaging.py path — then materialized once per worker into a content-hash
cache and put on sys.path / cwd). Network installers (pip/conda/uv) are
rejected with a clear error: cluster nodes have no package egress, so an
env that needs them is a deployment-image concern (image_uri in the
reference), not a scheduling-time one.
"""

from __future__ import annotations

import hashlib
import io
import os
import sys
import threading
import zipfile
from typing import Optional

_KV_NS = "runtime_env_packages"
_MAX_PACKAGE_BYTES = 256 << 20
_EXCLUDE_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}

_SUPPORTED = {"env_vars", "working_dir", "py_modules", "pip", "config"}
# conda/container isolation needs an image-build pipeline; pip installs
# work (offline via RTPU_PIP_ARGS wheel mirrors — see ensure_pip_env)
_REJECTED = {"conda", "uv", "container", "image_uri"}


def validate(runtime_env: Optional[dict]) -> Optional[dict]:
    if not runtime_env:
        return None
    bad = set(runtime_env) & _REJECTED
    if bad:
        raise ValueError(
            f"runtime_env fields {sorted(bad)} are not supported: conda/"
            f"container isolation requires an image-build pipeline; use "
            f"'pip' (offline-capable via RTPU_PIP_ARGS) or bake "
            f"dependencies into the node image")
    unknown = set(runtime_env) - _SUPPORTED
    if unknown:
        raise ValueError(f"unknown runtime_env fields {sorted(unknown)}; "
                         f"supported: {sorted(_SUPPORTED)}")
    ev = runtime_env.get("env_vars")
    if ev is not None and not (
        isinstance(ev, dict)
        and all(isinstance(k, str) and isinstance(v, str)
                for k, v in ev.items())
    ):
        raise ValueError("runtime_env['env_vars'] must be a dict[str, str]")
    return runtime_env


def _zip_dir(path: str) -> bytes:
    path = os.path.abspath(os.path.expanduser(path))
    if not os.path.isdir(path):
        raise ValueError(f"runtime_env directory {path!r} does not exist")
    buf = io.BytesIO()
    total = 0
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(path):
            dirs[:] = [d for d in dirs if d not in _EXCLUDE_DIRS]
            for f in files:
                full = os.path.join(root, f)
                total += os.path.getsize(full)
                if total > _MAX_PACKAGE_BYTES:
                    raise ValueError(
                        f"runtime_env package {path!r} exceeds "
                        f"{_MAX_PACKAGE_BYTES >> 20} MiB")
                zf.write(full, os.path.relpath(full, path))
    return buf.getvalue()


# Driver-side memo: abspath -> (stat signature, uploaded uri). Re-zipping a
# working_dir on EVERY .remote() call would collapse submission throughput;
# a stat-only walk detects edits and invalidates.
_upload_cache: dict[str, tuple[int, str]] = {}


def _dir_signature(path: str) -> int:
    h = hashlib.sha1()
    for root, dirs, files in os.walk(path):
        dirs[:] = sorted(d for d in dirs if d not in _EXCLUDE_DIRS)
        for f in sorted(files):
            full = os.path.join(root, f)
            try:
                st = os.stat(full)
            except OSError:
                continue
            h.update(f"{os.path.relpath(full, path)}|{st.st_mtime_ns}|"
                     f"{st.st_size};".encode())
    return int.from_bytes(h.digest()[:8], "little")


def package(runtime_env: Optional[dict], ctx) -> Optional[dict]:
    """Driver side: validate + replace local dirs with kvzip:// URIs.

    Content-addressed: the same directory contents upload once per cluster
    (reference: packaging.py get_uri_for_directory).
    """
    runtime_env = validate(runtime_env)
    if runtime_env is None:
        return None
    out = dict(runtime_env)

    def upload(path: str) -> str:
        if isinstance(path, str) and path.startswith("kvzip://"):
            return path
        apath = os.path.abspath(os.path.expanduser(path))
        sig = _dir_signature(apath)
        cached = _upload_cache.get(apath)
        if cached is not None and cached[0] == sig:
            return cached[1]
        blob = _zip_dir(apath)
        digest = hashlib.sha1(blob).hexdigest()
        key = digest.encode()
        if ctx.rpc("kv_get", {"namespace": _KV_NS, "key": key}) is None:
            ctx.rpc("kv_put", {"namespace": _KV_NS, "key": key,
                               "value": blob})
        uri = f"kvzip://{digest}"
        _upload_cache[apath] = (sig, uri)
        return uri

    if "working_dir" in out and out["working_dir"]:
        out["working_dir"] = upload(out["working_dir"])
    if "py_modules" in out and out["py_modules"]:
        out["py_modules"] = [upload(p) for p in out["py_modules"]]
    return out


_materialize_lock = threading.Lock()


def _cache_root() -> str:
    """Node-local caches live beside the port's sessions, apart from the
    JAX package's."""
    from ray_tpu_torch._private.node import session_root

    return session_root()


def _materialize(uri: str, ctx) -> str:
    """Worker side: fetch a kvzip:// package into the node-local cache."""
    digest = uri[len("kvzip://"):]
    dest = os.path.join(_cache_root(), "runtime_env_cache", digest)
    with _materialize_lock:
        if os.path.isdir(dest):
            return dest
        blob = ctx.rpc("kv_get", {"namespace": _KV_NS,
                                  "key": digest.encode()})
        if blob is None:
            raise RuntimeError(f"runtime_env package {uri} not found in GCS")
        tmp = dest + f".tmp{os.getpid()}"
        with zipfile.ZipFile(io.BytesIO(blob)) as zf:
            zf.extractall(tmp)
        try:
            os.rename(tmp, dest)
        except OSError:
            # Another PROCESS won the race (the threading lock above only
            # covers this process); its extraction is complete because
            # rename is the last step. Drop our copy.
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
            if not os.path.isdir(dest):
                raise
    return dest


class AppliedEnv:
    """Worker-side applied runtime env; undo() restores the process."""

    def __init__(self):
        self._env_prev: dict[str, Optional[str]] = {}
        self._sys_path_added: list[str] = []
        self._prev_cwd: Optional[str] = None

    def undo(self):
        for p in self._sys_path_added:
            try:
                sys.path.remove(p)
            except ValueError:
                pass
        if self._prev_cwd is not None:
            try:
                os.chdir(self._prev_cwd)
            except OSError:
                pass
        for k, prev in self._env_prev.items():
            if prev is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = prev


_pip_env_lock = None  # lazily a threading.Lock (workers are threaded)


def ensure_pip_env(requirements: list) -> str:
    """Materialize a pip requirement set into a content-addressed target
    directory; returns the directory (added to sys.path on apply).

    Counterpart of the reference's pip runtime-env plugin
    (Ray's python/ray/_private/runtime_env/pip.py), sized for
    air-gapped clusters: instead of a full virtualenv + dedicated worker
    process, packages install once per node into a cached ``--target``
    directory and activate additively via sys.path — the same additive
    semantics the reference's pip env has with system-site-packages.
    Offline installs: put extra pip args (e.g. ``--no-index
    --find-links /wheels``) in RTPU_PIP_ARGS.
    """
    import fcntl
    import hashlib
    import subprocess
    import threading

    global _pip_env_lock
    if _pip_env_lock is None:
        _pip_env_lock = threading.Lock()
    reqs = sorted(str(r) for r in requirements)
    extra = os.environ.get("RTPU_PIP_ARGS", "").split()
    tag = hashlib.sha256(
        ("\n".join(reqs + extra)).encode()).hexdigest()[:16]
    pip_root = os.path.join(_cache_root(), "pip_envs")
    dest = os.path.join(pip_root, f"pip-{tag}")
    marker = os.path.join(dest, ".rtpu_ready")
    os.makedirs(pip_root, exist_ok=True)
    # Workers are separate OS PROCESSES: the install critical section needs
    # a file lock, not just a thread lock (a shared --target dir being
    # written by two pips concurrently yields torn package trees — the
    # reference's pip plugin locks the same way).
    with _pip_env_lock, open(dest + ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if os.path.exists(marker):
                return dest
            os.makedirs(dest, exist_ok=True)
            cmd = [sys.executable, "-m", "pip", "install", "--target",
                   dest, "--no-warn-script-location", *extra, *reqs]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"runtime_env pip install failed "
                    f"({' '.join(reqs)}): {proc.stderr[-2000:]}")
            with open(marker, "w") as f:
                f.write("\n".join(reqs))
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)
    return dest


def apply(runtime_env: Optional[dict], ctx) -> Optional[AppliedEnv]:
    if not runtime_env:
        return None
    applied = AppliedEnv()
    try:
        for k, v in (runtime_env.get("env_vars") or {}).items():
            applied._env_prev[k] = os.environ.get(k)
            os.environ[k] = v
        wd = runtime_env.get("working_dir")
        if wd:
            path = _materialize(wd, ctx)
            applied._prev_cwd = os.getcwd()
            os.chdir(path)
            sys.path.insert(0, path)
            applied._sys_path_added.append(path)
        for uri in runtime_env.get("py_modules") or []:
            path = _materialize(uri, ctx)
            sys.path.insert(0, path)
            applied._sys_path_added.append(path)
        pip_reqs = runtime_env.get("pip")
        if pip_reqs:
            if isinstance(pip_reqs, dict):  # {"packages": [...]} form
                pip_reqs = pip_reqs.get("packages") or []
            elif isinstance(pip_reqs, str):
                # one requirement, or a requirements.txt path (the
                # reference accepts both string forms) — NOT a char list
                if pip_reqs.endswith(".txt") and os.path.exists(pip_reqs):
                    with open(pip_reqs) as f:
                        pip_reqs = [ln.strip() for ln in f
                                    if ln.strip()
                                    and not ln.startswith("#")]
                else:
                    pip_reqs = [pip_reqs]
            path = ensure_pip_env(list(pip_reqs))
            sys.path.insert(0, path)
            applied._sys_path_added.append(path)
    except BaseException:
        applied.undo()
        raise
    return applied
