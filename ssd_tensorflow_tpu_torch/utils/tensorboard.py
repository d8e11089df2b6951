"""Minimal, dependency-free TensorBoard event writer, as in the JAX
package's ``utils/tensorboard.py``.

TensorBoard scalars, images and histograms without TensorFlow or torch's
writer: the tfevents wire format is hand-encoded (protobuf varints and
TFRecord framing with a masked CRC32C). ``add_image`` encodes PNG with
OpenCV, else PIL; where neither is installed it writes nothing. Files are
readable by stock TensorBoard.
"""

from __future__ import annotations

import os
import socket
import struct
import time

import numpy as np

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) — table-driven, pure python; event volume is tiny.
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    _CRC_TABLE = table
    return table


def _crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Protobuf wire-format encoding helpers
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _pb_bytes(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _pb_string(field: int, s: str) -> bytes:
    return _pb_bytes(field, s.encode())


def _pb_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _pb_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _pb_packed_doubles(field: int, values) -> bytes:
    data = b"".join(struct.pack("<d", float(v)) for v in values)
    return _pb_bytes(field, data)


# ---------------------------------------------------------------------------
# Summary / Event protos
# ---------------------------------------------------------------------------


def _scalar_value(tag: str, value: float) -> bytes:
    # Summary.Value: tag=1, simple_value=2
    return _pb_bytes(1, _pb_string(1, tag) + _pb_float(2, value))


def _image_value(tag: str, png: bytes, height: int, width: int) -> bytes:
    # Summary.Image: height=1, width=2, colorspace=3, encoded=4
    img = (
        _pb_int64(1, height)
        + _pb_int64(2, width)
        + _pb_int64(3, 3)
        + _pb_bytes(4, png)
    )
    # Summary.Value: tag=1, image=4
    return _pb_bytes(1, _pb_string(1, tag) + _pb_bytes(4, img))


def _histogram_value(tag: str, values: np.ndarray, bins: int = 30) -> bytes:
    values = np.asarray(values, dtype=np.float64).ravel()
    counts, edges = np.histogram(values, bins=bins)
    # HistogramProto: min=1 max=2 num=3 sum=4 sum_squares=5
    #                 bucket_limit=6 (packed) bucket=7 (packed)
    h = (
        _pb_double(1, float(values.min()) if values.size else 0.0)
        + _pb_double(2, float(values.max()) if values.size else 0.0)
        + _pb_double(3, float(values.size))
        + _pb_double(4, float(values.sum()))
        + _pb_double(5, float((values**2).sum()))
        + _pb_packed_doubles(6, edges[1:])
        + _pb_packed_doubles(7, counts)
    )
    # Summary.Value: tag=1, histo=5
    return _pb_bytes(1, _pb_string(1, tag) + _pb_bytes(5, h))


def _event(step: int, summary_values: bytes = b"", file_version: str = "") -> bytes:
    # Event: wall_time=1 (double), step=2 (int64),
    #        file_version=3 (string), summary=5 (Summary)
    out = _pb_double(1, time.time())
    if step is not None:
        out += _pb_int64(2, step)
    if file_version:
        out += _pb_string(3, file_version)
    if summary_values:
        out += _pb_bytes(5, summary_values)
    return out


class SummaryWriter:
    """Write tfevents files TensorBoard can read."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = "events.out.tfevents.{:.0f}.{}.{}".format(
            time.time(), socket.gethostname(), os.getpid()
        )
        self._f = open(os.path.join(logdir, fname), "ab")
        self._write_record(_event(None, file_version="brain.Event:2"))

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int):
        self._write_record(_event(step, _scalar_value(tag, float(value))))

    def add_image(self, tag: str, image: np.ndarray, step: int):
        """``image``: HWC uint8, RGB. Skipped without OpenCV and PIL."""
        png = _encode_png(image)
        if png is None:
            return
        self._write_record(
            _event(
                step, _image_value(tag, png, image.shape[0], image.shape[1])
            )
        )

    def add_histogram(self, tag: str, values, step: int):
        self._write_record(_event(step, _histogram_value(tag, values)))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def _encode_png(image: np.ndarray):
    """PNG bytes of an RGB image, or ``None`` without OpenCV and PIL."""
    image = np.ascontiguousarray(image.astype(np.uint8))
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        ok, buf = cv2.imencode(".png", image[..., ::-1])  # RGB -> BGR
        if not ok:
            raise RuntimeError("cv2.imencode failed")
        return buf.tobytes()
    try:
        from PIL import Image
    except ImportError:
        return None
    import io

    bio = io.BytesIO()
    Image.fromarray(image).save(bio, format="PNG")
    return bio.getvalue()
