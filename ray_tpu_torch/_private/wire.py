"""Versioned binary codec for control-plane messages.

Counterpart of the reference's protobuf wire contracts
(Ray's src/ray/protobuf/common.proto and friends): every frame the
control plane exchanges is a tagged, length-delimited tree of plain values —
never a pickle.  Unpickling attacker-shaped bytes on a TCP listener is an RCE
the moment the cluster token leaks; this codec makes a malformed or malicious
frame decode to garbage values or a ``WireError``, not code execution (see
tests/test_wire.py for the fuzz proof).

User payloads (task args, actor state, objects) are opaque ``bytes`` at this
layer — serialization of user values stays in serialization.py (cloudpickle),
exactly like the reference pickles user data inside protobuf ``bytes`` fields.

The format is versioned: peers exchange a magic+version preamble frame before
the first message (``HELLO``/``HELLO_OK``), so version-mismatched nodes fail
with a clean error instead of a decode explosion.

Value model (tags are the cross-language contract — native/wire.h mirrors
them byte for byte):

    0x00 None        0x01 False          0x02 True
    0x03 int64       0x04 float64        0x05 str (u32 len + utf8)
    0x06 bytes       0x07 list           0x08 tuple
    0x09 dict        0x0A struct         0x0B error

A *struct* is a registered dataclass encoded as (u8 struct-id + field dict) —
field-tolerant in both directions, so adding a field is never a wire break.
An *error* is (type-name, message[, traceback]); decode reconstructs a real
exception instance from an allowlist of types, anything else becomes
``RemoteError``.
"""

from __future__ import annotations

import builtins
import struct
from typing import Any, Callable

# Protocol constants live in wire_constants (the single Python anchor the
# drift pass compares against native/wire.h); re-exported here for callers.
from ray_tpu_torch._private.wire_constants import (  # noqa: F401
    HELLO,
    HELLO_OK,
    MAX_DEPTH,
    MAX_ITEMS,
    WIRE_VERSION,
)


class WireError(Exception):
    """Malformed frame (bad tag, truncated, over-limit, unknown struct)."""


class RemoteError(Exception):
    """An exception type we don't reconstruct crossed the wire."""


_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")

# struct-id -> (class, from_fields); class -> struct-id
_STRUCTS_BY_ID: dict[int, tuple[type, Callable[[dict], Any]]] = {}
_STRUCT_IDS: dict[type, int] = {}


def register_struct(struct_id: int, cls: type | None = None):
    """Register a dataclass for struct encoding (id is the wire contract).

    Usable as ``@register_struct(id)`` above the dataclass decorator.
    Decoding is field-tolerant: unknown fields are dropped, missing fields
    take the dataclass defaults — so old and new peers interoperate.
    """
    if cls is None:
        return lambda c: register_struct(struct_id, c)
    import dataclasses

    names = {f.name for f in dataclasses.fields(cls)}
    required = {f.name for f in dataclasses.fields(cls)
                if f.default is dataclasses.MISSING
                and f.default_factory is dataclasses.MISSING}

    def from_fields(d: dict) -> Any:
        kw = {k: v for k, v in d.items() if k in names}
        for miss in required - kw.keys():
            kw[miss] = None
        return cls(**kw)

    _STRUCTS_BY_ID[struct_id] = (cls, from_fields)
    _STRUCT_IDS[cls] = struct_id
    return cls


# Exceptions reconstructed by type on decode.  Everything else arrives as
# RemoteError("TypeName: message") — the cluster never imports or executes
# anything on behalf of a peer's error.
_ERROR_ALLOWLIST = {
    n: getattr(builtins, n)
    for n in (
        "ValueError", "KeyError", "TypeError", "RuntimeError", "OSError",
        "TimeoutError", "ConnectionError", "FileNotFoundError",
        "NotImplementedError", "StopIteration", "MemoryError",
        "PermissionError",
    )
}


_framework_errors_loaded = False


def _register_framework_errors():
    # Lazy: exceptions.py has no import-time deps on this module.
    global _framework_errors_loaded
    _framework_errors_loaded = True
    try:
        from ray_tpu_torch import exceptions as _exc

        for name in dir(_exc):
            obj = getattr(_exc, name)
            if isinstance(obj, type) and issubclass(obj, BaseException):
                _ERROR_ALLOWLIST[name] = obj
    except ImportError:
        pass


def encode(value: Any) -> bytes:
    out = bytearray()
    _enc(out, value, 0)
    return bytes(out)


def _enc(out: bytearray, v: Any, depth: int):
    if depth > MAX_DEPTH:
        raise WireError("encode: nesting too deep")
    if v is None:
        out.append(0x00)
    elif v is False:
        out.append(0x01)
    elif v is True:
        out.append(0x02)
    elif type(v) is int:
        out.append(0x03)
        out += _I64.pack(v)
    elif type(v) is float:
        out.append(0x04)
        out += _F64.pack(v)
    elif type(v) is str:
        b = v.encode("utf-8")
        out.append(0x05)
        out += _U32.pack(len(b))
        out += b
    elif type(v) in (bytes, bytearray, memoryview):
        b = bytes(v)
        out.append(0x06)
        out += _U32.pack(len(b))
        out += b
    elif type(v) is list or type(v) is set or type(v) is frozenset:
        items = list(v)
        out.append(0x07)
        out += _U32.pack(len(items))
        for item in items:
            _enc(out, item, depth + 1)
    elif type(v) is tuple:
        out.append(0x08)
        out += _U32.pack(len(v))
        for item in v:
            _enc(out, item, depth + 1)
    elif type(v) is dict:
        out.append(0x09)
        out += _U32.pack(len(v))
        for k, val in v.items():
            _enc(out, k, depth + 1)
            _enc(out, val, depth + 1)
    elif type(v) in _STRUCT_IDS:
        out.append(0x0A)
        out.append(_STRUCT_IDS[type(v)])
        _enc(out, v.__dict__, depth + 1)
    elif isinstance(v, BaseException):
        out.append(0x0B)
        _enc(out, type(v).__name__, depth + 1)
        _enc(out, _exc_message(v), depth + 1)
    elif isinstance(v, int):  # bool subclass handled above; numpy-ish ints
        out.append(0x03)
        out += _I64.pack(int(v))
    elif isinstance(v, float):
        out.append(0x04)
        out += _F64.pack(float(v))
    else:
        raise WireError(
            f"type {type(v).__name__} is not wire-encodable (control frames "
            "carry plain values only; pickle user payloads into bytes first)")


def _exc_message(e: BaseException) -> str:
    # KeyError("x") str()s to "'x'"; args[0] keeps round-trips clean.
    if len(e.args) == 1 and isinstance(e.args[0], str):
        return e.args[0]
    return str(e)


def decode(data: bytes) -> Any:
    if not _framework_errors_loaded:
        _register_framework_errors()
    v, pos = _dec(memoryview(data), 0, 0)
    if pos != len(data):
        raise WireError(f"trailing bytes after value ({len(data) - pos})")
    return v


def _dec(buf: memoryview, pos: int, depth: int):
    if depth > MAX_DEPTH:
        raise WireError("decode: nesting too deep")
    if pos >= len(buf):
        raise WireError("truncated frame")
    tag = buf[pos]
    pos += 1
    if tag == 0x00:
        return None, pos
    if tag == 0x01:
        return False, pos
    if tag == 0x02:
        return True, pos
    if tag == 0x03:
        if pos + 8 > len(buf):
            raise WireError("truncated int64")
        return _I64.unpack_from(buf, pos)[0], pos + 8
    if tag == 0x04:
        if pos + 8 > len(buf):
            raise WireError("truncated float64")
        return _F64.unpack_from(buf, pos)[0], pos + 8
    if tag in (0x05, 0x06):
        n, pos = _dec_len(buf, pos)
        if pos + n > len(buf):
            raise WireError("truncated string/bytes")
        raw = bytes(buf[pos:pos + n])
        if tag == 0x05:
            try:
                return raw.decode("utf-8"), pos + n
            except UnicodeDecodeError as e:
                raise WireError("invalid utf-8 in str") from e
        return raw, pos + n
    if tag in (0x07, 0x08):
        n, pos = _dec_count(buf, pos)
        items = []
        for _ in range(n):
            v, pos = _dec(buf, pos, depth + 1)
            items.append(v)
        return (items if tag == 0x07 else tuple(items)), pos
    if tag == 0x09:
        n, pos = _dec_count(buf, pos)
        d = {}
        for _ in range(n):
            k, pos = _dec(buf, pos, depth + 1)
            try:
                hash(k)
            except TypeError as e:
                raise WireError("unhashable dict key") from e
            v, pos = _dec(buf, pos, depth + 1)
            d[k] = v
        return d, pos
    if tag == 0x0A:
        if pos >= len(buf):
            raise WireError("truncated struct id")
        sid = buf[pos]
        pos += 1
        fields, pos = _dec(buf, pos, depth + 1)
        if not isinstance(fields, dict):
            raise WireError("struct body must be a dict")
        entry = _STRUCTS_BY_ID.get(sid)
        if entry is None:
            raise WireError(f"unknown struct id {sid}")
        try:
            return entry[1](fields), pos
        except TypeError as e:
            raise WireError(f"bad struct fields for id {sid}") from e
    if tag == 0x0B:
        name, pos = _dec(buf, pos, depth + 1)
        msg, pos = _dec(buf, pos, depth + 1)
        if not isinstance(name, str) or not isinstance(msg, str):
            raise WireError("error frame fields must be strings")
        cls = _ERROR_ALLOWLIST.get(name)
        if cls is None or not isinstance(cls, type):
            return RemoteError(f"{name}: {msg}"), pos
        try:
            return cls(msg), pos
        except Exception:
            return RemoteError(f"{name}: {msg}"), pos
    raise WireError(f"unknown tag 0x{tag:02x}")


def _dec_len(buf: memoryview, pos: int) -> tuple[int, int]:
    if pos + 4 > len(buf):
        raise WireError("truncated length")
    n = _U32.unpack_from(buf, pos)[0]
    if n > len(buf):  # cannot possibly fit in the remaining frame
        raise WireError("length exceeds frame")
    return n, pos + 4


def _dec_count(buf: memoryview, pos: int) -> tuple[int, int]:
    if pos + 4 > len(buf):
        raise WireError("truncated count")
    n = _U32.unpack_from(buf, pos)[0]
    if n > MAX_ITEMS or n > len(buf) - pos:
        # each element needs >= 1 byte; a count beyond the remaining bytes
        # is a bomb, rejected before allocation
        raise WireError("collection count exceeds frame")
    return n, pos + 4


# ---------------------------------------------------------------------------
# Request/response envelopes (the GCS service protocol rides these).
# ---------------------------------------------------------------------------

def encode_request(method: str, args: tuple, kwargs: dict) -> bytes:
    return encode((method, tuple(args), kwargs))


def decode_request(data: bytes) -> tuple[str, tuple, dict]:
    v = decode(data)
    if (not isinstance(v, tuple) or len(v) != 3
            or not isinstance(v[0], str) or not isinstance(v[1], tuple)
            or not isinstance(v[2], dict)):
        raise WireError("malformed request envelope")
    return v


def encode_response(ok: bool, payload: Any) -> bytes:
    return encode((ok, payload))


def decode_response(data: bytes) -> tuple[bool, Any]:
    v = decode(data)
    if not isinstance(v, tuple) or len(v) != 2 or not isinstance(v[0], bool):
        raise WireError("malformed response envelope")
    return v
