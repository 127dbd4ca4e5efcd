"""First-party TensorBoard event-file writer with no dependency beyond the
standard library and NumPy (a copy of the JAX package's
``utils/tb_native.py``; the port imports nothing of that package).

TensorBoard's on-disk format (consumed by ``tensorboard --logdir``) is a
TFRecord stream of serialized ``Event`` protos:

    uint64 length | uint32 masked_crc32c(length) | bytes data |
    uint32 masked_crc32c(data)

with CRC32-C (Castagnoli) and TensorFlow's rotate+add masking. The Event
proto subset needed for scalar/image logging is tiny, so both the framing
and the protobuf encoding are done by hand here: the TensorBoard writer of
``utils/observability.py`` (the reference's yolov6/utils/events.py:37-60
write_tblog) needs neither the ``tensorboard`` package nor torch's
``SummaryWriter``. ``tests/test_torch_port_writers.py`` holds the files it
writes byte for byte against the JAX package's writer and reads them back
with the ``tensorboard`` reader.
"""
from __future__ import annotations

import pathlib
import socket
import struct
import time
import zlib
from typing import Dict, Sequence

import numpy as np

# ---------------------------------------------------------------- crc32c --

_POLY = 0x82F63B78  # reflected Castagnoli
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)


def crc32c(data: bytes) -> int:
    # pure-Python table loop: ~100 ms for a 640^2 RGB PNG payload — fine for
    # the rare plot/image calls this writer serves; route through a C crc32c
    # (google-crc32c et al.) before making image logging hot
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    """TensorFlow's CRC mask: rotate right 15, add magic."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- proto encoding --


def _varint(n: int) -> bytes:
    if n < 0:  # proto int64: negatives encode as 64-bit two's complement
        n &= (1 << 64) - 1
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
    return _varint((field << 3) | wire)


def _f_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _f_double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _f_float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _f_bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _summary_value_scalar(tag: str, value: float) -> bytes:
    # Summary.Value: tag = field 1, simple_value = field 2
    return _f_bytes(1, tag.encode()) + _f_float(2, float(value))


def _summary_value_image(tag: str, png: bytes, h: int, w: int, c: int) -> bytes:
    # Summary.Image: height 1, width 2, colorspace 3, encoded_image_string 4
    img = (_f_varint(1, h) + _f_varint(2, w) + _f_varint(3, c)
           + _f_bytes(4, png))
    return _f_bytes(1, tag.encode()) + _f_bytes(4, img)


def _event(step: int, summary_values: Sequence[bytes] = (),
           file_version: str = "") -> bytes:
    # Event: wall_time 1 (double), step 2, file_version 3, summary 5
    out = _f_double(1, time.time())
    if file_version:
        return out + _f_bytes(3, file_version.encode())
    out += _f_varint(2, int(step))
    summary = b"".join(_f_bytes(1, v) for v in summary_values)
    return out + _f_bytes(5, summary)


# ------------------------------------------------------------------ png --


def encode_png(img) -> bytes:
    """Minimal PNG encoder: uint8 (H, W), (H, W, 1), (H, W, 3) or (H, W, 4)."""
    import numpy as np

    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = np.clip(a, 0, 255).astype(np.uint8)
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + a[row].tobytes() for row in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


# --------------------------------------------------------------- writer --


class NativeTBWriter:
    """Drop-in scalar/image event writer (the write_tblog role) with no
    torch/tensorboard dependency. One events file per instance."""

    _instance_counter = 0

    def __init__(self, log_dir):
        log_dir = pathlib.Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        # pid + per-process counter uniquify writers created within the
        # same second (torch's SummaryWriter does the same) — two writers
        # appending to one file would interleave streams
        NativeTBWriter._instance_counter += 1
        import os

        name = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}.{os.getpid()}."
            f"{NativeTBWriter._instance_counter}"
        )
        self._f = open(log_dir / name, "wb")
        self._write(_event(0, file_version="brain.Event:2"))

    def _write(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header + struct.pack("<I", masked_crc(header))
                      + payload + struct.pack("<I", masked_crc(payload)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        self._write(_event(step, [_summary_value_scalar(tag, value)]))

    def add_image(self, tag: str, img, step: int, dataformats: str = "HWC"):
        import numpy as np

        a = np.asarray(img)
        if dataformats == "CHW" and a.ndim == 3:
            a = np.transpose(a, (1, 2, 0))
        png = encode_png(a)
        h, w = a.shape[:2]
        c = 1 if a.ndim == 2 else a.shape[2]
        self._write(_event(step, [_summary_value_image(tag, png, h, w, c)]))

    # MetricWriter protocol (observability.MultiWriter backends)
    def log(self, metrics: Dict, step: int):
        # np.number included: the torch SummaryWriter this replaces accepts
        # numpy scalars, so silently dropping them would lose metrics
        values = [_summary_value_scalar(k, float(v))
                  for k, v in metrics.items()
                  if isinstance(v, (int, float, np.number))]
        if values:
            self._write(_event(step, values))

    def log_images(self, tag: str, images, step: int):
        for i, im in enumerate(images):
            self.add_image(f"{tag}/{i}", im, step)

    def close(self):
        self._f.close()
