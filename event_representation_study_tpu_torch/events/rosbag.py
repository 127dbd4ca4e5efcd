"""Pure-Python ROS1 bag (v2.0) event I/O — no ``rosbag``/``rospy`` needed (a
copy of the JAX package's ``events/rosbag.py``; its window queries use the
port's ``events/windows.py``).

The reference's ``RosbagEventHandle`` (ev-licious/src/evlicious/io/
rosbag_event_handle.py) reads ``dvs_msgs/EventArray`` messages through the
ROS ``rosbag`` API: it scans every message once to build per-message event
counts/timestamps, then answers ``get_between_idx``/``get_between_time``
queries in µs with polarity in {-1,+1} (:16-107). ``utils/rosbag.py`` plus
``scripts/processing/write_events_to_rosbag.py`` cover the writing side.

This module implements the on-disk *format* from the public bag-2.0 spec
instead of wrapping the ROS stack:

- record framing ``<u32 hlen><header><u32 dlen><data>`` where the header is
  ``<u32 flen>name=value`` fields; ``op`` selects the record kind
  (0x03 bag header, 0x05 chunk, 0x07 connection, 0x02 message data,
  0x04 index, 0x06 chunk info);
- chunks hold compressed streams of connection/message-data records
  (``none`` and ``bz2`` supported here; ``lz4`` raises: it needs a library
  outside the standard one);
- ``dvs_msgs/EventArray`` wire format: std_msgs/Header (u32 seq, u32 sec,
  u32 nsec, u32-length frame_id), u32 height, u32 width, u32 count, then
  packed 13-byte events ``<u2 x><u2 y><u4 sec><u4 nsec><u1 polarity>`` —
  decoded vectorized with one structured ``np.frombuffer`` per message.

The reader scans records sequentially and ignores bag indexes entirely, so
unindexed/"rosbag reindex"-pending files load fine. The writer emits a
spec-conformant indexed bag (bag header, one chunk, connection + message
records, index-data + chunk-info + trailing connection copies) that
round-trips through this reader and follows the layout ``rosbag`` itself
writes.
"""
from __future__ import annotations

import bz2
import pathlib
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

_MAGIC = b"#ROSBAG V2.0\n"
_EVENT_DTYPE = np.dtype(
    [("x", "<u2"), ("y", "<u2"), ("sec", "<u4"), ("nsec", "<u4"), ("p", "u1")]
)
assert _EVENT_DTYPE.itemsize == 13  # packed, no padding

_OP_MSG = 0x02
_OP_BAG_HEADER = 0x03
_OP_INDEX = 0x04
_OP_CHUNK = 0x05
_OP_CHUNK_INFO = 0x06
_OP_CONNECTION = 0x07

EVENT_ARRAY_TYPE = "dvs_msgs/EventArray"
# md5sum/definition of the public dvs_msgs definition (checked by real ROS
# readers; our reader matches on the type string)
EVENT_ARRAY_MD5 = "5e8beee5a6c107e504c2e78903c224b8"
EVENT_ARRAY_DEF = (
    "Header header\nuint32 height\nuint32 width\ndvs_msgs/Event[] events\n"
)


def _parse_header(buf: bytes) -> Dict[str, bytes]:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off : off + flen]
        off += flen
        name, _, value = field.partition(b"=")
        fields[name.decode()] = value
    return fields


def _build_header(fields: Dict[str, bytes]) -> bytes:
    out = b""
    for name, value in fields.items():
        body = name.encode() + b"=" + value
        out += struct.pack("<I", len(body)) + body
    return out


def _iter_records(buf: bytes, off: int = 0) -> Iterator[Tuple[Dict[str, bytes], bytes]]:
    n = len(buf)
    while off + 4 <= n:
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        header = _parse_header(buf[off : off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        data = buf[off : off + dlen]
        off += dlen
        yield header, data


def _decode_event_array(data: bytes) -> Tuple[int, int, np.ndarray]:
    """dvs_msgs/EventArray payload -> (height, width, packed event array)."""
    off = 4 + 8  # Header.seq + Header.stamp
    (flen,) = struct.unpack_from("<I", data, off)
    off += 4 + flen  # frame_id
    height, width, count = struct.unpack_from("<III", data, off)
    off += 12
    ev = np.frombuffer(data, dtype=_EVENT_DTYPE, count=count, offset=off)
    return height, width, ev


class RosbagEventHandle:
    """Event handle over a ROS1 bag of dvs_msgs/EventArray messages.

    Same query surface as H5EventHandle (and the reference handle,
    rosbag_event_handle.py:48-107): len, index_from_time,
    get_between_idx/time, compute_*_windows. The whole event stream is
    decoded once at open (bags are chunk-compressed; random access would
    re-decompress the same chunks per query — the reference likewise
    re-reads messages per query through the rosbag index)."""

    def __init__(self, path):
        raw = pathlib.Path(path).read_bytes()
        if not raw.startswith(_MAGIC):
            raise ValueError(f"{path}: not a ROS bag v2.0 file")
        conn_types: Dict[int, str] = {}
        xs: List[np.ndarray] = []
        self.height = self.width = 0

        def consume(stream: bytes):
            for header, data in _iter_records(stream):
                op = header.get("op", b"\x00")[0]
                if op == _OP_CONNECTION:
                    conn_id = struct.unpack("<I", header["conn"])[0]
                    conn_fields = _parse_header(data)
                    conn_types[conn_id] = conn_fields.get("type", b"").decode()
                elif op == _OP_MSG:
                    conn_id = struct.unpack("<I", header["conn"])[0]
                    if conn_types.get(conn_id) != EVENT_ARRAY_TYPE:
                        continue
                    h, w, ev = _decode_event_array(data)
                    self.height = max(self.height, h)
                    self.width = max(self.width, w)
                    if len(ev):
                        xs.append(ev)
                elif op == _OP_CHUNK:
                    compression = header.get("compression", b"none").decode()
                    if compression == "none":
                        payload = data
                    elif compression == "bz2":
                        payload = bz2.decompress(data)
                    else:  # pragma: no cover - lz4
                        raise NotImplementedError(
                            f"bag chunk compression {compression!r} unsupported"
                        )
                    consume(payload)
                # 0x03/0x04/0x06 (bag header / index / chunk info) skipped:
                # sequential scan needs no index

        consume(raw[len(_MAGIC):])
        ev = np.concatenate(xs) if xs else np.zeros(0, _EVENT_DTYPE)
        self._t = ev["sec"].astype(np.int64) * 1_000_000 + ev["nsec"] // 1_000
        self._x = ev["x"].astype(np.int32)
        self._y = ev["y"].astype(np.int32)
        # bool polarity -> {-1,+1} (rosbag_event_handle.py:79)
        self._p = np.where(ev["p"] > 0, 1, -1).astype(np.int32)
        if self.height == 0 and len(ev):
            self.height = int(self._y.max()) + 1
            self.width = int(self._x.max()) + 1

    @classmethod
    def from_path(cls, path, height=None, width=None):
        h = cls(path)
        if height is not None:
            h.height = height
        if width is not None:
            h.width = width
        return h

    def __len__(self):
        return len(self._t)

    def index_from_time(self, t_us: int) -> int:
        from .windows import find_index_from_timestamps

        return int(find_index_from_timestamps(t_us, self._t))

    def get_between_idx(self, i0: int, i1: int) -> np.ndarray:
        out = np.zeros(
            i1 - i0, dtype=[("x", "<i4"), ("y", "<i4"), ("t", "<i8"), ("p", "<i4")]
        )
        out["x"] = self._x[i0:i1]
        out["y"] = self._y[i0:i1]
        out["t"] = self._t[i0:i1]
        out["p"] = self._p[i0:i1]
        return out

    def get_between_time(self, t0_us: int, t1_us: int) -> np.ndarray:
        return self.get_between_idx(
            self.index_from_time(t0_us), self.index_from_time(t1_us)
        )

    def compute_index_windows(self, window: int, stride: Optional[int] = None):
        from .windows import index_windows

        return index_windows(len(self._t), window, stride)

    def compute_time_windows(self, window_us: int, stride_us: Optional[int] = None):
        from .windows import time_windows

        return time_windows(self._t, window_us, stride_us)

    def close(self):  # parity with the other handles
        pass


def _record(header: Dict[str, bytes], data: bytes) -> bytes:
    h = _build_header(header)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def _time_bytes(t_us: int) -> bytes:
    return struct.pack("<II", t_us // 1_000_000, (t_us % 1_000_000) * 1_000)


def write_events_to_rosbag(
    path,
    events: np.ndarray,
    height: int,
    width: int,
    topic: str = "/dvs/events",
    events_per_msg: int = 30_000,
    compression: str = "none",
):
    """Write events (structured x/y/t[µs]/p array, p in {-1,+1} or {0,1})
    as dvs_msgs/EventArray messages, one chunk, indexed
    (write_events_to_rosbag.py + utils/rosbag.py:14-23 semantics: message
    stamp = last event time of the slice)."""
    assert compression in ("none", "bz2")
    conn_header = {
        "op": bytes([_OP_CONNECTION]),
        "conn": struct.pack("<I", 0),
        "topic": topic.encode(),
    }
    conn_data = _build_header(
        {
            "topic": topic.encode(),
            "type": EVENT_ARRAY_TYPE.encode(),
            "md5sum": EVENT_ARRAY_MD5.encode(),
            "message_definition": EVENT_ARRAY_DEF.encode(),
        }
    )
    conn_rec = _record(conn_header, conn_data)

    msgs: List[Tuple[int, bytes]] = []  # (stamp_us, record)
    t = np.asarray(events["t"], np.int64)
    for seq, i0 in enumerate(range(0, len(events), events_per_msg)):
        sl = events[i0 : i0 + events_per_msg]
        packed = np.zeros(len(sl), _EVENT_DTYPE)
        packed["x"] = sl["x"]
        packed["y"] = sl["y"]
        packed["sec"] = sl["t"] // 1_000_000
        packed["nsec"] = (sl["t"] % 1_000_000) * 1_000
        packed["p"] = (np.asarray(sl["p"]) > 0).astype(np.uint8)
        stamp_us = int(t[min(i0 + events_per_msg, len(t)) - 1])
        payload = (
            struct.pack("<I", seq)
            + _time_bytes(stamp_us)
            + struct.pack("<I", 0)  # empty frame_id
            + struct.pack("<III", height, width, len(sl))
            + packed.tobytes()
        )
        rec = _record(
            {
                "op": bytes([_OP_MSG]),
                "conn": struct.pack("<I", 0),
                "time": _time_bytes(stamp_us),
            },
            payload,
        )
        msgs.append((stamp_us, rec))

    # IndexData v1 entries point at each message record's byte offset
    # WITHIN the uncompressed chunk payload (rosbag seeks via these);
    # record them while assembling the payload
    msg_offsets: List[int] = []
    off = len(conn_rec)
    for _, rec in msgs:
        msg_offsets.append(off)
        off += len(rec)
    chunk_payload = conn_rec + b"".join(r for _, r in msgs)
    chunk_data = (
        bz2.compress(chunk_payload) if compression == "bz2" else chunk_payload
    )
    chunk_rec = _record(
        {
            "op": bytes([_OP_CHUNK]),
            "compression": compression.encode(),
            "size": struct.pack("<I", len(chunk_payload)),
        },
        chunk_data,
    )

    start_us = int(t[0]) if len(t) else 0
    end_us = int(t[-1]) if len(t) else 0
    with open(path, "wb") as f:
        f.write(_MAGIC)
        # spec: the bag-header record is padded with 0x20 to 4096 bytes
        bag_header_fields = {
            "op": bytes([_OP_BAG_HEADER]),
            "chunk_count": struct.pack("<I", 1),
            "conn_count": struct.pack("<I", 1),
            "index_pos": struct.pack("<Q", 0),  # patched below
        }
        # spec/rosbag: total bag-header record is 4096 bytes (space padding)
        def _bag_header_record():
            h = _build_header(bag_header_fields)
            pad = 4096 - 4 - len(h) - 4
            return (
                struct.pack("<I", len(h)) + h
                + struct.pack("<I", pad) + b" " * pad
            )

        header_record_pos = f.tell()
        f.write(_bag_header_record())
        chunk_pos = f.tell()
        f.write(chunk_rec)
        # per-connection index-data record for the chunk
        idx_entries = b"".join(
            _time_bytes(stamp) + struct.pack("<I", o)
            for (stamp, _), o in zip(msgs, msg_offsets)
        )
        f.write(
            _record(
                {
                    "op": bytes([_OP_INDEX]),
                    "ver": struct.pack("<I", 1),
                    "conn": struct.pack("<I", 0),
                    "count": struct.pack("<I", len(msgs)),
                },
                idx_entries,
            )
        )
        index_pos = f.tell()
        f.write(conn_rec)
        f.write(
            _record(
                {
                    "op": bytes([_OP_CHUNK_INFO]),
                    "ver": struct.pack("<I", 1),
                    "chunk_pos": struct.pack("<Q", chunk_pos),
                    "start_time": _time_bytes(start_us),
                    "end_time": _time_bytes(end_us),
                    "count": struct.pack("<I", 1),
                },
                struct.pack("<II", 0, len(msgs)),
            )
        )
        # patch index_pos now that it is known
        bag_header_fields["index_pos"] = struct.pack("<Q", index_pos)
        f.seek(header_record_pos)
        f.write(_bag_header_record())
    return path
