"""Object serialization for the shared-memory store.

Counterpart of ``ray_tpu/_private/serialization.py``, with torch tensors
beside numpy arrays on the raw-buffer path.  The store is the host staging
tier for device memory: a tensor, on the CPU or on CUDA and of any dtype
(bfloat16 included), is written as a small header and its bytes, a CUDA
tensor copied from the device straight into the store slot (no second
host buffer).  ``get`` returns a zero-copy CPU view of shared memory; the
caller moves it onto the card (``.to("cuda")``), so no copy to the device
happens behind its back.  Numpy arrays keep the JAX package's format byte
for byte.  Everything else goes through cloudpickle.

Wire format: 1-byte tag, then payload.
  tag 0: cloudpickle payload
  tag 1: error payload — pickle of (exception, remote_traceback_str)
  tag 2: array payload — u32 meta_len | pickle((dtype_str, shape)) | raw data
  tag 3: tensor payload — u32 meta_len | pickle((torch dtype name, shape))
         | raw data.  The header names torch's dtype ("bfloat16"), never a
         numpy dtype string: numpy has no bfloat16.
"""

from __future__ import annotations

import pickle
import struct
import sys
import warnings
import weakref

import cloudpickle
import numpy as np

from ray_tpu_torch.exceptions import RayTpuError, TaskError

_task_error_types: dict[type, type] = {}


def _as_raisable(exc: BaseException, tb: str,
                 raised_by_task: bool = False) -> BaseException:
    """Convert a stored remote exception into the exception to raise locally.

    System errors (ActorDiedError, WorkerCrashedError, ...) raise as
    themselves — UNLESS they were raised by task code (e.g. user code did a
    ``get`` on a ref owned by a dead upstream actor and the error propagated
    through): those wrap in the TaskError dual so callers can tell "this
    actor died" from "this actor ran and re-raised a system error" (the
    Serve handle uses this to avoid failing over a healthy replica).  User
    exceptions raise as a dynamic subclass of both TaskError and the
    original type, so ``except ValueError`` catches a remote ValueError —
    same trick as the reference's RayTaskError
    (Ray's python/ray/exceptions.py make_dual_exception_type).
    """
    if isinstance(exc, TaskError):
        return exc  # already wrapped (e.g. relayed through another task)
    if isinstance(exc, RayTpuError) and not raised_by_task:
        return exc
    cause_t = type(exc)
    dual = _task_error_types.get(cause_t)
    if dual is None:
        try:
            dual = type(f"TaskError({cause_t.__name__})",
                        (TaskError, cause_t), {})
            _task_error_types[cause_t] = dual
        except TypeError:  # e.g. cause type with incompatible layout
            return TaskError(exc, tb)
    try:
        return dual(exc, tb)
    except Exception:
        return TaskError(exc, tb)

TAG_PICKLE = 0
TAG_ERROR = 1
TAG_ARRAY = 2
TAG_TENSOR = 3

_U32 = struct.Struct("<I")


def _as_host_array(value):
    """Return a C-contiguous numpy view/copy for numpy arrays, else None."""
    if not isinstance(value, np.ndarray):
        return None
    if value.dtype == object or value.dtype.hasobject:
        return None
    return np.ascontiguousarray(value)


def _as_tensor(value):
    """A dense, contiguous torch tensor for tensor values, else None.
    Looks torch up in ``sys.modules``: a value can only be a tensor in a
    process that has imported torch.  While another thread is importing
    it, the module is there without ``Tensor`` yet, and no tensor exists."""
    torch = sys.modules.get("torch")
    tensor_t = getattr(torch, "Tensor", None)
    if tensor_t is None or not isinstance(value, tensor_t):
        return None
    if value.layout != torch.strided or value.is_quantized:
        return None
    # plain Tensor (drops subclasses and Parameter), no autograd history
    return value.detach().contiguous().as_subclass(torch.Tensor)


def _tensor_dtype_name(t) -> str:
    return str(t.dtype).rsplit(".", 1)[-1]  # torch.bfloat16 -> "bfloat16"


def serialized_size(value) -> tuple[int, object]:
    """Compute the store allocation size and a prepared payload token."""
    arr = _as_host_array(value)
    if arr is not None:
        meta = pickle.dumps((arr.dtype.str, arr.shape))
        return 1 + _U32.size + len(meta) + arr.nbytes, ("array", meta, arr)
    t = _as_tensor(value)
    if t is not None:
        meta = pickle.dumps((_tensor_dtype_name(t), tuple(t.shape)))
        nbytes = t.numel() * t.element_size()
        return 1 + _U32.size + len(meta) + nbytes, ("tensor", meta, t)
    blob = cloudpickle.dumps(value)
    return 1 + len(blob), ("pickle", blob)


def is_device_token(token) -> bool:
    """True for a tensor that lives on an accelerator: its bytes must be
    copied from the device into the store slot by ``write_payload``, so a
    vectored send (``payload_parts``) does not apply."""
    return token[0] == "tensor" and token[2].device.type != "cpu"


def _tensor_bytes(t):
    """The tensor's bytes as a flat uint8 tensor (a view, no copy)."""
    import torch

    return t.reshape(-1).view(torch.uint8)


def payload_parts(token) -> list:
    """The payload as a list of buffers (header bytes + zero-copy views),
    for vectored sends that skip the scratch-buffer assembly a contiguous
    write_payload needs.  Concatenation of the parts == the write_payload
    image.  Host tensors only (see ``is_device_token``)."""
    kind = token[0]
    if kind == "array":
        _, meta, arr = token
        header = bytes([TAG_ARRAY]) + _U32.pack(len(meta)) + meta
        return [header, arr.reshape(-1).view(np.uint8).data]
    if kind == "tensor":
        _, meta, t = token
        if t.device.type != "cpu":
            raise ValueError("a device tensor has no host buffer to send; "
                             "write it into a store slot with write_payload")
        header = bytes([TAG_TENSOR]) + _U32.pack(len(meta)) + meta
        return [header, memoryview(_tensor_bytes(t).numpy())]
    _, blob = token
    return [bytes([TAG_PICKLE]), blob]


def write_payload(buf: memoryview, token) -> None:
    kind = token[0]
    if kind in ("array", "tensor"):
        _, meta, data = token
        buf[0] = TAG_ARRAY if kind == "array" else TAG_TENSOR
        off = 1
        buf[off : off + _U32.size] = _U32.pack(len(meta))
        off += _U32.size
        buf[off : off + len(meta)] = meta
        off += len(meta)
        if kind == "array":
            flat = data.reshape(-1).view(np.uint8)
            buf[off : off + data.nbytes] = flat.data
            return
        src = _tensor_bytes(data)
        n = src.numel()
        if n == 0:
            return
        import torch

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            dst = torch.frombuffer(buf[off : off + n], dtype=torch.uint8)
        # a CUDA tensor lands here by one device-to-host copy into the slot
        dst.copy_(src)
    else:
        _, blob = token
        buf[0] = TAG_PICKLE
        buf[1 : 1 + len(blob)] = blob


def serialize_error(exc: BaseException, tb: str,
                    raised_by_task: bool = False) -> bytes:
    # cloudpickle, not pickle: driver-defined exception classes (__main__)
    # must survive by-value so `except MyError` keeps matching at the caller.
    try:
        payload = cloudpickle.dumps((exc, tb, raised_by_task))
    except Exception:
        # Truly unpicklable exception: degrade to a RuntimeError with repr.
        payload = cloudpickle.dumps(
            (RuntimeError(repr(exc)), tb, raised_by_task))
    return bytes([TAG_ERROR]) + payload


def store_error_best_effort(store, oid: bytes, exc: BaseException, tb: str,
                            raised_by_task: bool = False) -> bool:
    """Write an error payload to the store, degrading rather than leaving the
    return object absent (an absent return hangs blocking ``get``s forever).
    """
    fallback = serialize_error(
        RuntimeError(f"original error unrecordable: {type(exc).__name__}: "
                     f"{str(exc)[:200]}"), "", raised_by_task)
    for payload in (serialize_error(exc, tb, raised_by_task), fallback):
        try:
            store.put(oid, payload)
            return True
        except FileExistsError:
            if store.contains(oid):  # sealed: a real result/error exists
                return True
            # Unsealed husk from a failed earlier write: clear and retry.
            try:
                store.abort(oid)
                store.put(oid, payload)
                return True
            except Exception:
                continue
        except Exception:
            continue
    return False


def deserialize(view: memoryview, release_cb=None):
    """Deserialize a stored object from a pinned shm view.

    ``release_cb`` is invoked when the object's pin can be dropped: immediately
    for copying formats, or when the returned zero-copy array is GC'd.
    Raises TaskError for stored errors.
    """
    tag = view[0]
    if tag == TAG_PICKLE:
        value = pickle.loads(view[1:])
        if release_cb:
            release_cb()
        return value
    if tag == TAG_ERROR:
        payload = pickle.loads(view[1:])
        exc, tb = payload[0], payload[1]
        raised_by_task = payload[2] if len(payload) > 2 else False
        if release_cb:
            release_cb()
        raise _as_raisable(exc, tb, raised_by_task)
    if tag == TAG_ARRAY:
        (meta_len,) = _U32.unpack(view[1 : 1 + _U32.size])
        off = 1 + _U32.size
        dtype_str, shape = pickle.loads(view[off : off + meta_len])
        off += meta_len
        arr = np.frombuffer(view[off:], dtype=np.dtype(dtype_str)).reshape(shape)
        arr.flags.writeable = False
        if release_cb:
            weakref.finalize(arr, release_cb)
        return arr
    if tag == TAG_TENSOR:
        (meta_len,) = _U32.unpack(view[1 : 1 + _U32.size])
        off = 1 + _U32.size
        dtype_name, shape = pickle.loads(view[off : off + meta_len])
        off += meta_len
        return _tensor_view(view[off:], dtype_name, shape, release_cb)
    raise ValueError(f"unknown object tag {tag}")


def _tensor_view(data: memoryview, dtype_name: str, shape, release_cb):
    """A CPU tensor over ``data`` (no copy).  The bytes sit in a read-only
    numpy array, which the tensor's storage keeps alive (``from_numpy``
    holds a reference to it), so ``release_cb`` runs when the last tensor
    viewing the store is gone, views and slices included.  Torch has no
    read-only flag: the store client hands out views of a read-only
    mapping, so an in-place write into a tensor over the store faults
    (the process dies) instead of changing the object for every reader.
    A small object comes inline as private bytes, which nobody else
    reads."""
    import torch

    dtype = getattr(torch, dtype_name)
    raw = np.frombuffer(data, dtype=np.uint8)
    raw.flags.writeable = False
    if release_cb:
        weakref.finalize(raw, release_cb)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "not writable"
        flat = torch.from_numpy(raw)
    if dtype != torch.uint8:
        if flat.numel() == 0:
            flat = torch.empty(0, dtype=dtype)
        else:
            flat = flat.view(dtype)
    return flat.reshape(shape)
