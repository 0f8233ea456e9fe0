"""Native video frame reader (AVI containers).

Counterpart of ``ray_tpu/data/video.py`` (Ray's video datasource,
python/ray/data/_internal/datasource/video_datasource.py, calls
`opencv-python`).  The two codecs that matter for ML corpora shipped as
AVI are decoded directly:

  * MJPEG ('00dc' chunks that are whole JPEGs) — decoded with PIL,
    imported inside ``_decode_frame`` as ``read_images`` imports it
  * uncompressed BI_RGB DIB ('00db' chunks) — bottom-up BGR rows

Each video file is one read task emitting one row per frame
({"frame": HxWx3 uint8 RGB, "frame_index": i, "path": f}) — frames from
one file stay ordered, files fan out across the cluster.  Other codecs
(H.264 etc.) need a real decoder: if cv2 happens to be importable it is
used, otherwise the error names the codec and the wheel.
"""

from __future__ import annotations

import io
import struct
from typing import Callable, Iterator, List, Tuple

import numpy as np

from ray_tpu_torch.data import block as block_mod
from ray_tpu_torch.data import datasource as _ds
from ray_tpu_torch.data.block import Block


def _riff_chunks(buf: bytes, start: int, end: int):
    """Yield (fourcc, payload_start, payload_size) for a chunk run."""
    pos = start
    while pos + 8 <= end:
        fourcc = buf[pos:pos + 4]
        (size,) = struct.unpack_from("<I", buf, pos + 4)
        yield fourcc, pos + 8, size
        pos += 8 + size + (size & 1)  # chunks are word-aligned


def _parse_avi(buf: bytes) -> Tuple[List[bytes], dict]:
    """Return (video frame chunks in stream order, stream format info)."""
    if buf[:4] != b"RIFF" or buf[8:12] != b"AVI ":
        raise ValueError("not an AVI (RIFF/'AVI ') file")
    frames: List[bytes] = []
    fmt = {"compression": None, "width": 0, "height": 0, "bpp": 24}
    # strf binds to the PRECEDING strh's stream type: in a file whose
    # first stream is audio, the first strf is a WAVEFORMATEX, not the
    # video BITMAPINFOHEADER
    cur_stream = {"is_video": False}

    def walk(start: int, end: int):
        for fourcc, off, size in _riff_chunks(buf, start, end):
            if fourcc == b"LIST":
                ltype = buf[off:off + 4]
                if ltype in (b"hdrl", b"movi", b"strl", b"rec "):
                    walk(off + 4, off + size)
            elif fourcc == b"strh":
                cur_stream["is_video"] = buf[off:off + 4] == b"vids"
            elif fourcc == b"strf" and cur_stream["is_video"] \
                    and fmt["compression"] is None:
                # BITMAPINFOHEADER: width i32 @4, height i32 @8,
                # bitcount u16 @14, compression u32 @16
                if size >= 20:
                    fmt["width"] = struct.unpack_from("<i", buf, off + 4)[0]
                    fmt["height"] = struct.unpack_from("<i", buf, off + 8)[0]
                    fmt["bpp"] = struct.unpack_from("<H", buf, off + 14)[0]
                    fmt["compression"] = buf[off + 16:off + 20]
            elif fourcc[2:] in (b"dc", b"db") and size > 0:
                frames.append(buf[off:off + size])

    walk(12, len(buf))
    return frames, fmt


def _decode_frame(chunk: bytes, fmt: dict) -> np.ndarray:
    if chunk[:2] == b"\xff\xd8":  # JPEG SOI: MJPEG frame
        from PIL import Image

        return np.asarray(Image.open(io.BytesIO(chunk)).convert("RGB"))
    comp = fmt.get("compression") or b"\x00\x00\x00\x00"
    if comp == b"\x00\x00\x00\x00" and fmt["bpp"] == 24:
        w, h = fmt["width"], abs(fmt["height"])
        stride = (w * 3 + 3) & ~3  # DIB rows pad to 4 bytes
        rows = np.frombuffer(chunk[: stride * h], np.uint8)
        rows = rows.reshape(h, stride)[:, : w * 3].reshape(h, w, 3)
        if fmt["height"] > 0:  # positive height = bottom-up
            rows = rows[::-1]
        return rows[..., ::-1].copy()  # BGR -> RGB
    name = comp.decode("ascii", "replace")
    raise NotImplementedError(
        f"AVI codec {name!r} needs a real decoder: install "
        "`opencv-python` (used automatically when importable) or "
        "transcode to MJPEG")


def video_tasks(paths, parallelism: int) -> List[Callable]:
    files = _ds.expand_paths(paths, [".avi", ".mp4", ".mkv", ".mov"])

    def _emit(frames: List[np.ndarray], first_idx: int, f: str) -> Block:
        # frames of one clip share a shape: stack into a device-ready
        # tensor column (same layout as read_images)
        return block_mod.from_batch({
            "frame": np.stack(frames),
            "frame_index": np.arange(first_idx, first_idx + len(frames)),
            "path": np.array([f] * len(frames)),
        })

    def read_file(f: str) -> Iterator[Block]:
        if not f.lower().endswith(".avi"):
            yield from _cv2_frames(f)
            return
        with open(f, "rb") as fh:
            buf = fh.read()
        chunks, fmt = _parse_avi(buf)
        pend: List[np.ndarray] = []
        for i, chunk in enumerate(chunks):
            pend.append(_decode_frame(chunk, fmt))
            if len(pend) >= 64:  # bound block size for long clips
                yield _emit(pend, i + 1 - len(pend), f)
                pend = []
        if pend:
            yield _emit(pend, len(chunks) - len(pend), f)

    def _cv2_frames(f: str) -> Iterator[Block]:
        try:
            import cv2
        except ImportError as e:
            raise ImportError(
                f"{f}: non-AVI containers need `opencv-python` "
                "(not in the TPU image); AVI/MJPEG decodes natively"
            ) from e
        cap = cv2.VideoCapture(f)
        pend, i = [], 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            pend.append(frame[..., ::-1].copy())
            i += 1
            if len(pend) >= 64:
                yield _emit(pend, i - len(pend), f)
                pend = []
        cap.release()
        if pend:
            yield _emit(pend, i - len(pend), f)

    return _ds._file_tasks(files, parallelism, read_file)
