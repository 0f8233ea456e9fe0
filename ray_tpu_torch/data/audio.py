"""Audio datasource: WAV decoding with the stdlib, no client wheels.

Counterpart of ``ray_tpu/data/audio.py`` (Ray's audio datasource,
python/ray/data/_internal/datasource/audio_datasource.py, decodes with
``soundfile``).  PCM WAV — the dominant training-corpus container — is
decoded natively (stdlib ``wave`` + numpy: 8/16/24/32-bit int and IEEE
float frames); other containers use ``soundfile`` when present and fail
with the JAX package's error when not.

Rows: {"amplitude": float32[n_channels, n_samples], "sample_rate": int,
"path": str} — amplitude normalized to [-1, 1] as in Ray.  A file is a
numpy block ``{"amplitude": float32[1, ch, n], "sample_rate": int64[1],
"path": [path]}``, where the JAX package's is an Arrow table with a
fixed-size-list column.
"""

from __future__ import annotations

import struct
import wave
from typing import Callable, Iterator, List

import numpy as np

from ray_tpu_torch.data import block as block_mod
from ray_tpu_torch.data.datasource import Block, _file_tasks, expand_paths


def _decode_wav(path: str):
    with wave.open(path, "rb") as w:
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 1:  # unsigned 8-bit
        x = np.frombuffer(raw, np.uint8).astype(np.float32)
        x = (x - 128.0) / 128.0
    elif width == 2:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 3:  # packed 24-bit: widen to i4
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        widened = np.zeros((b.shape[0], 4), np.uint8)
        widened[:, 1:] = b
        x = widened.view("<i4").ravel().astype(np.float32) / 2147483648.0
    elif width == 4:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported WAV sample width {width} ({path})")
    return x.reshape(-1, n_ch).T, rate


def _walk_riff(data: bytes):
    """Yield (chunk_id, payload_offset, size) — encoders commonly prepend
    JUNK/LIST chunks, so fmt/data are found by walking, never by fixed
    offsets."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        return
    pos = 12
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size, = struct.unpack_from("<I", data, pos + 4)
        yield cid, pos + 8, size
        pos += 8 + size + (size & 1)


def _is_float_wav(path: str) -> bool:
    """IEEE-float WAVs (fmt tag 3) — stdlib wave rejects them, so sniff
    the fmt chunk (wherever it sits) and decode the frames directly."""
    try:
        with open(path, "rb") as f:
            data = f.read(1 << 16)
        for cid, off, _size in _walk_riff(data):
            if cid == b"fmt ":
                return struct.unpack_from("<H", data, off)[0] == 3
    except (OSError, struct.error):
        pass
    return False


def _decode_float_wav(path: str):
    with open(path, "rb") as f:
        data = f.read()
    n_ch = rate = width = None
    for cid, off, size in _walk_riff(data):
        if cid == b"fmt ":
            n_ch, = struct.unpack_from("<H", data, off + 2)
            rate, = struct.unpack_from("<I", data, off + 4)
            width, = struct.unpack_from("<H", data, off + 14)
        elif cid == b"data":
            if n_ch is None:
                break  # fmt must precede data per spec
            raw = data[off:off + size]
            dt = "<f4" if width == 32 else "<f8"
            x = np.frombuffer(raw, dt).astype(np.float32)
            return x.reshape(-1, n_ch).T, rate
    raise ValueError(f"malformed float WAV {path}")


def decode_audio(path: str):
    """(float32[channels, samples], sample_rate) for one audio file."""
    if path.lower().endswith(".wav"):
        if _is_float_wav(path):
            return _decode_float_wav(path)
        return _decode_wav(path)
    try:
        import soundfile
    except ImportError:
        raise ImportError(
            f"decoding {path!r} needs the `soundfile` wheel (not in the "
            f"TPU image); PCM/float WAV decodes natively") from None
    data, rate = soundfile.read(path, always_2d=True, dtype="float32")
    return data.T, rate


def audio_tasks(paths, parallelism: int) -> List[Callable]:
    files = expand_paths(paths)

    def read_file(f: str) -> Iterator[Block]:
        amp, rate = decode_audio(f)
        yield block_mod.from_batch({
            "amplitude": amp[None, ...],
            "sample_rate": np.array([rate], np.int64),
            "path": [f],
        })

    return _file_tasks(files, parallelism, read_file)
