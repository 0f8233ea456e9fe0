"""Store-backed KV page tier: prefix families as digest-addressed blobs.

Counterpart of ``ray_tpu/llm/kv_tier.py``.  The KV pages of a hot prefix
family live in one engine's page pool; this module seals the family's
shared SPINE (the chain of blocks from the family root that later requests
reuse) into a store, addressed by the family's root block digest
(``PrefixCache.digest_for``'s chain hash, so two engines agree on the
address byte for byte).  Another engine then PULLS the spine and hydrates
its pool instead of prefilling cold: the P/D handoff ships a digest instead
of host KV arrays, and a fresh engine warms its hottest families from the
store.  Every pull failure is a typed ``KVPullError`` that the engine turns
into a counted fallback to cold prefill, never a failed request.

The blob format is the JAX package's KVT1, byte for byte: a blob either
package seals, the other decodes.  bf16 has no numpy dtype without
``ml_dtypes`` (which comes with JAX), so bf16 tensors travel as their
``uint16`` bits under the header dtype ``"bfloat16"``.  Decoded arrays are
CPU tensors.

Layering: the tier knows stores and directories; the engine owns all
page-pool mutation (on its scheduler thread) and all metrics.
``WorkerStoreBackend`` and ``GcsDirectory`` hold spines in the port
runtime's shm store and their directory in its GCS, so engines in
different processes (serve replicas) share them; ``InProcessStore`` and
``LocalDirectory`` serve one process.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

_MAGIC = b"KVT1"
_OID_SALT = b"rtpu-kv:"

# How long a directory miss is cached before the engine's admission path
# asks again (keeps a per-cold-request directory lookup off the hot path).
_NEG_TTL_S = 2.0

_FALSY = ("", "0", "false", "no", "off")  # RTPU_KV_TIER values that mean off

# header dtype name -> (torch dtype, numpy dtype of its bits)
_DTYPES = {"float32": (torch.float32, np.float32),
           "float16": (torch.float16, np.float16),
           "bfloat16": (torch.bfloat16, np.uint16)}


class KVPullError(Exception):
    """A tier pull failed in a typed, fallback-able way.

    ``reason`` feeds ``llm_kv_pull_fallbacks_total{reason}``:
      miss       — directory record exists but the store has no bytes
      evicted    — the store reported the object explicitly evicted
      store_died — the store is unreachable
      truncated  — blob shorter than its header promises (torn stripe)
      corrupt    — bad magic/header, or geometry mismatching this engine
      no_pages   — pull succeeded but the pool can't host the spine
    """

    def __init__(self, reason: str, msg: str = ""):
        super().__init__(msg or reason)
        self.reason = reason


def _exc_reason(exc: BaseException) -> str:
    # by name, as the JAX package does: a store client's eviction error
    name = type(exc).__name__
    if name == "ObjectEvictedError":
        return "evicted"
    return "store_died"


def dtype_name(dtype: torch.dtype) -> str:
    """The header name of a torch dtype: numpy's name, as the JAX package
    writes it ("bfloat16", "float32")."""
    return str(dtype).removeprefix("torch.")


# ------------------------- blob codec -----------------------------------


def _bits(kv) -> Tuple[str, bytes]:
    t = torch.as_tensor(kv).detach().cpu().contiguous()
    name = dtype_name(t.dtype)
    if name not in _DTYPES:
        raise ValueError(f"no KVT1 encoding for dtype {t.dtype}")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.uint16)
    return name, t.numpy().tobytes()


def encode_spine(tokens: List[int], kv_k, kv_v, page_size: int) -> bytes:
    """Serialize a family spine: [MAGIC][u32 hlen][json header][k][v].

    kv tensors (or numpy arrays) are [n_layers, blocks, page_size, n_kv,
    head_dim]; the header carries the spine's token content so the puller
    can verify block by block how much of a given prompt the blob covers.
    """
    dt, kb = _bits(kv_k)
    _, vb = _bits(kv_v)
    shape = tuple(kv_k.shape)
    hdr = {"v": 1, "page_size": int(page_size),
           "blocks": int(shape[1]), "layers": int(shape[0]),
           "kv_heads": int(shape[3]), "head_dim": int(shape[4]),
           "dtype": dt, "tokens": [int(t) for t in tokens],
           "k_bytes": len(kb), "v_bytes": len(vb)}
    hb = json.dumps(hdr).encode()
    return b"".join([_MAGIC, struct.pack("<I", len(hb)), hb, kb, vb])


def decode_spine(blob) -> Tuple[List[int], torch.Tensor, torch.Tensor,
                                dict]:
    """Inverse of encode_spine; raises typed KVPullError on damage."""
    blob = bytes(blob)  # own the bytes
    if len(blob) < 8 or blob[:4] != _MAGIC:
        raise KVPullError("corrupt", "bad magic")
    (hlen,) = struct.unpack_from("<I", blob, 4)
    if len(blob) < 8 + hlen:
        raise KVPullError("truncated", "header cut short")
    try:
        hdr = json.loads(blob[8:8 + hlen])
        shape = (hdr["layers"], hdr["blocks"], hdr["page_size"],
                 hdr["kv_heads"], hdr["head_dim"])
        t_dtype, bits = _DTYPES[hdr["dtype"]]
        k_bytes, v_bytes = int(hdr["k_bytes"]), int(hdr["v_bytes"])
        tokens = [int(t) for t in hdr["tokens"]]
    except KeyError as e:
        raise KVPullError("corrupt", f"header missing {e}")
    except Exception as e:  # noqa: BLE001 — any malformed header
        raise KVPullError("corrupt", f"bad header: {e}")
    if len(tokens) != hdr["blocks"] * hdr["page_size"]:
        raise KVPullError("corrupt", "token count != blocks * page_size")
    if len(blob) < 8 + hlen + k_bytes + v_bytes:
        raise KVPullError(
            "truncated", f"blob {len(blob)}B < promised "
            f"{8 + hlen + k_bytes + v_bytes}B")
    count = int(np.prod(shape))

    def tensor(offset: int) -> torch.Tensor:
        # copy out of the (read-only, possibly unaligned) bytes
        a = np.frombuffer(blob, bits, count=count, offset=offset).copy()
        return torch.from_numpy(a.reshape(shape)).view(t_dtype)

    return tokens, tensor(8 + hlen), tensor(8 + hlen + k_bytes), hdr


# ------------------------- store / directory -----------------------------


class InProcessStore:
    """Dict-backed store: the surface of a store client the tier uses."""

    def __init__(self):
        self._objs: Dict[bytes, bytes] = {}
        self._lock = threading.Lock()

    def put(self, oid: bytes, data: bytes) -> None:
        with self._lock:
            self._objs[bytes(oid)] = bytes(data)

    def get_bytes(self, oid: bytes, timeout_ms: int = 0):
        with self._lock:
            return self._objs.get(bytes(oid))

    def contains(self, oid: bytes) -> bool:
        with self._lock:
            return bytes(oid) in self._objs

    def delete(self, oid: bytes) -> None:
        with self._lock:
            self._objs.pop(bytes(oid), None)


class WorkerStoreBackend:
    """This node's shm store (the port runtime's ``StoreClient``) + the
    striped pull plane behind a miss.

    put() also reports the seal over the scheduler RPC lane
    (``note_sealed``) so the GCS records this node as a holder; a local
    get miss then asks the scheduler to ``pull`` — the daemon fetches
    the stripes daemon-to-daemon over ``XFER_PULL_RANGE`` from a holder
    — and polls the local store briefly for the object to land.  Two
    replica processes on one node share the store: one seals, the other
    reads the same object."""

    def __init__(self, worker, pull_wait_s: float = 2.0):
        self._w = worker
        self._pull_wait_s = pull_wait_s

    def put(self, oid: bytes, data: bytes) -> None:
        self._w.store.put(oid, data)
        try:
            self._w.rpc("note_sealed", {"oid": oid})
        except Exception:  # noqa: BLE001 — local put stands on its own
            pass

    def get_bytes(self, oid: bytes, timeout_ms: int = 0):
        got = self._w.store.get_bytes(oid, timeout_ms)
        if got is not None:
            return got
        try:
            self._w.rpc("pull", {"oid": oid})
        except Exception:  # noqa: BLE001 — no transfer plane: a miss
            return None
        deadline = time.monotonic() + self._pull_wait_s
        while time.monotonic() < deadline:
            got = self._w.store.get_bytes(oid, timeout_ms=200)
            if got is not None:
                return got
        return None

    def contains(self, oid: bytes) -> bool:
        return self._w.store.contains(oid)


class LocalDirectory:
    """In-process family directory: root digest hex -> {oid, blocks,
    hits, page_size}."""

    def __init__(self):
        self._recs: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def publish(self, root_hex: str, rec: dict) -> None:
        with self._lock:
            old = self._recs.get(root_hex)
            if old is not None and old.get("blocks", 0) > rec.get(
                    "blocks", 0):
                # never shadow a deeper spine with a shallower reseal
                rec = {**rec, "oid": old["oid"], "blocks": old["blocks"]}
            self._recs[root_hex] = dict(rec)

    def lookup(self, root_hex: str) -> Optional[dict]:
        with self._lock:
            rec = self._recs.get(root_hex)
            return dict(rec) if rec is not None else None

    def hottest(self, n: int) -> List[str]:
        with self._lock:
            items = list(self._recs.items())
        items.sort(key=lambda kv: -int(kv[1].get("hits", 0)))
        return [root for root, _ in items[:n]]

    def drop(self, root_hex: str) -> None:
        with self._lock:
            self._recs.pop(root_hex, None)


class GcsDirectory:
    """Cluster directory over the GCS kv table (namespace ``kv_tier``):
    one record per family root, plus an advisory ``_index`` heat doc for
    warm restarts.  The index merge is read-modify-write and therefore
    racy across publishers — acceptable: it only seeds prehydration
    hints, the per-root records stay authoritative."""

    NS = "kv_tier"
    _INDEX_CAP = 64

    def __init__(self, worker):
        self._w = worker

    def publish(self, root_hex: str, rec: dict) -> None:
        try:
            self._w.rpc("kv_put", {
                "namespace": self.NS, "key": root_hex.encode(),
                "value": json.dumps(rec).encode()})
            raw = self._w.rpc("kv_get", {"namespace": self.NS,
                                         "key": b"_index"})
            idx = json.loads(raw) if raw else {}
            idx[root_hex] = int(rec.get("hits", 0))
            top = dict(sorted(idx.items(), key=lambda kv: -kv[1])
                       [:self._INDEX_CAP])
            self._w.rpc("kv_put", {"namespace": self.NS, "key": b"_index",
                                   "value": json.dumps(top).encode()})
        except Exception:  # noqa: BLE001 — publishing is best-effort
            pass

    def lookup(self, root_hex: str) -> Optional[dict]:
        try:
            raw = self._w.rpc("kv_get", {"namespace": self.NS,
                                         "key": root_hex.encode()})
        except Exception:  # noqa: BLE001
            return None
        if not raw:
            return None
        try:
            return json.loads(raw)
        except Exception:  # noqa: BLE001
            return None

    def hottest(self, n: int) -> List[str]:
        try:
            raw = self._w.rpc("kv_get", {"namespace": self.NS,
                                         "key": b"_index"})
        except Exception:  # noqa: BLE001
            return []
        if not raw:
            return []
        try:
            idx = json.loads(raw)
        except Exception:  # noqa: BLE001
            return []
        return sorted(idx, key=lambda r: -idx[r])[:n]


# ------------------------- the tier --------------------------------------


class KVTier:
    """Digest-addressed KV spine objects over a store + directory.

    Each method is self-contained; the ``_sealed`` and negative-lookup
    memos are per-instance dicts mutated with GIL-atomic ops, so one tier
    may be shared by several engines' scheduler threads.
    """

    def __init__(self, store, directory, *,
                 seal_min_hits: Optional[int] = None):
        self.store = store
        self.directory = directory
        self.seal_min_hits = (int(os.environ.get(
            "RTPU_KV_SEAL_MIN_HITS", "2") or 2)
            if seal_min_hits is None else int(seal_min_hits))
        self._sealed: Dict[str, int] = {}  # root hex -> blocks sealed
        self._neg: Dict[str, float] = {}   # root hex -> miss timestamp
        self.seals = 0
        self.pulls = 0
        # bytes moved and the last pull's wall time, so a slow pull of a
        # lot tells apart from a pull of nothing
        self.pull_bytes = 0
        self.last_pull_ms: Optional[float] = None

    # -- addressing --------------------------------------------------------

    @staticmethod
    def oid_for(root_hex: str, blocks: int) -> bytes:
        """20-byte store oid for one sealed depth of a family.  The depth
        is part of the address: a deeper reseal gets a fresh oid instead
        of overwriting a sealed (immutable) object."""
        h = hashlib.blake2b(digest_size=20)
        h.update(_OID_SALT + bytes.fromhex(root_hex)
                 + int(blocks).to_bytes(4, "little"))
        return h.digest()

    # -- sealing -----------------------------------------------------------

    def maybe_seal(self, prefix_cache, extract: Callable, tokens: List[int],
                   force: bool = False) -> bool:
        """Seal `tokens`' family spine if it is hot enough and grew since
        the last seal.  `extract(pages) -> (kv_k, kv_v)` is the engine's
        host-side page read.  ``force`` skips the heat gate (the P/D
        prefill handoff seals unconditionally — the seal IS the
        transfer)."""
        ps = prefix_cache.page_size
        root_hex = prefix_cache.root_digest_for(tokens, ps)
        if root_hex is None:
            return False
        hits = prefix_cache.family_hits(bytes.fromhex(root_hex))
        if hits < 0:
            return False
        if not force and hits < self.seal_min_hits:
            return False
        spine_tokens, pages = prefix_cache.spine(bytes.fromhex(root_hex))
        if not pages:
            return False
        if len(pages) <= self._sealed.get(root_hex, 0):
            return False
        if root_hex not in self._sealed:
            rec = self.directory.lookup(root_hex)
            if rec is not None and int(rec.get("blocks", 0)) >= len(pages):
                # another engine already sealed at least this depth
                self._sealed[root_hex] = int(rec["blocks"])
                return False
        try:
            kv_k, kv_v = extract(pages)
            blob = encode_spine(spine_tokens, kv_k, kv_v, ps)
            self.store.put(self.oid_for(root_hex, len(pages)), blob)
        except Exception:  # noqa: BLE001 — sealing is durability, not
            # correctness: a failed put just means no warm pull later
            return False
        self._sealed[root_hex] = len(pages)
        self._neg.pop(root_hex, None)
        self.directory.publish(root_hex, {
            "root": root_hex, "oid": self.oid_for(root_hex,
                                                  len(pages)).hex(),
            "blocks": len(pages), "hits": int(hits), "page_size": ps})
        self.seals += 1
        return True

    # -- lookup / pull -----------------------------------------------------

    def lookup(self, root_hex: str) -> Optional[dict]:
        return self.directory.lookup(root_hex)

    def lookup_for_pull(self, root_hex: str) -> Optional[dict]:
        """Directory lookup with a short negative cache — the admission
        path probes every cold family."""
        now = time.monotonic()
        ts = self._neg.get(root_hex)
        if ts is not None and now - ts < _NEG_TTL_S:
            return None
        rec = self.directory.lookup(root_hex)
        if rec is None:
            if len(self._neg) > 4096:
                self._neg.clear()
            self._neg[root_hex] = now
        else:
            self._neg.pop(root_hex, None)
        return rec

    def pull(self, root_hex: str, rec: Optional[dict] = None,
             expect: Optional[dict] = None
             ) -> Tuple[List[int], torch.Tensor, torch.Tensor]:
        """Fetch + decode a family spine; raises KVPullError on any typed
        failure.  ``expect`` (page_size/layers/kv_heads/head_dim/dtype)
        guards against hydrating a blob sealed under another geometry."""
        if rec is None:
            rec = self.directory.lookup(root_hex)
        if rec is None:
            raise KVPullError("miss", f"family {root_hex} not in directory")
        try:
            oid = bytes.fromhex(rec["oid"])
        except Exception:  # noqa: BLE001
            raise KVPullError("corrupt", f"bad directory record for "
                                         f"{root_hex}")
        t0 = time.monotonic()
        try:
            got = self.store.get_bytes(oid, timeout_ms=500)
        except KVPullError:
            raise
        except Exception as e:  # noqa: BLE001 — store death / eviction
            raise KVPullError(_exc_reason(e), str(e))
        if got is None:
            raise KVPullError("miss", f"store has no bytes for {root_hex}")
        nbytes = len(got)
        tokens, kv_k, kv_v, hdr = decode_spine(got)
        for key in ("page_size", "layers", "kv_heads", "head_dim"):
            if expect and key in expect and hdr[key] != expect[key]:
                raise KVPullError(
                    "corrupt", f"{key} mismatch: blob {hdr[key]} != "
                    f"engine {expect[key]}")
        if expect and "dtype" in expect and hdr["dtype"] != expect["dtype"]:
            raise KVPullError("corrupt", f"dtype mismatch: blob "
                              f"{hdr['dtype']} != engine {expect['dtype']}")
        self.pulls += 1
        self.pull_bytes += nbytes
        self.last_pull_ms = round((time.monotonic() - t0) * 1e3, 3)
        return tokens, kv_k, kv_v

    def hottest(self, n: int = 8) -> List[str]:
        return self.directory.hottest(n)

    def stats(self) -> dict:
        return {"sealed_families": len(self._sealed),
                "seal_min_hits": self.seal_min_hits,
                "seals": self.seals, "pulls": self.pulls,
                "pull_bytes": self.pull_bytes,
                "last_pull_ms": self.last_pull_ms}


# ------------------------- process default -------------------------------

_default_lock = threading.Lock()
_default_tier: Optional[KVTier] = None
_default_set = False
_auto_tiers: Dict[int, KVTier] = {}  # id(worker) -> tier


def set_default_tier(tier: Optional[KVTier]) -> None:
    """Install (or, with None, disable) the process default explicitly;
    wins over the worker-derived automatic tier."""
    global _default_tier, _default_set
    with _default_lock:
        _default_tier, _default_set = tier, True


def default_tier() -> Optional[KVTier]:
    """The tier an engine in this process should use: the explicitly
    installed one if any; else, when ``RTPU_KV_TIER`` is on and a process
    of the port's runtime (a worker, such as a serve replica, or the
    process that called ``init()``) has a store client, a tier over that
    process's shm store + the GCS directory.  None outside the runtime
    (plain LLMEngine users opt in by passing a tier)."""
    with _default_lock:
        if _default_set:
            return _default_tier
    if os.environ.get("RTPU_KV_TIER", "1").strip().lower() in _FALSY:
        return None
    from ray_tpu_torch._private.worker import global_worker_or_none

    w = global_worker_or_none()
    if w is None or getattr(w, "store", None) is None:
        return None
    with _default_lock:
        if _default_set:
            return _default_tier
        tier = _auto_tiers.get(id(w))
        if tier is None:
            tier = KVTier(WorkerStoreBackend(w), GcsDirectory(w))
            _auto_tiers.clear()  # a fresh worker obsoletes old bindings
            _auto_tiers[id(w)] = tier
        return tier
