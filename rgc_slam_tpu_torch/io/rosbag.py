"""Pure-Python rosbag v2.0 ingestion — the reference's front door.

A copy of ``rgc_slam_tpu/io/rosbag.py``, kept in the port so that it imports
nothing of the JAX package: its relative imports reach the port's own
``io/convert.py``, ``io/lz4.py`` and ``runtime/loader.py``.
``tests/test_torch_io.py`` holds it to the original's bytes and arrays.

The reference is driven by `rosbag play` of recorded sequences
(the reference's `README.md:40-52`, `launch/run.launch:38-44`) feeding
`sensor_msgs/PointCloud2` on /velodyne_points and `sensor_msgs/Imu`
(RGC_odometer.cpp:365-372).  This module reads those bags without any ROS
installation: the bag container format (http://wiki.ros.org/Bags/Format/2.0)
and the ROS1 message serialization are both simple length-prefixed binary.

Provides:
  * ``BagReader``   — sequential record scan; yields (topic, time, raw bytes)
  * message decoders for PointCloud2 / Imu / NavSatFix (numpy, zero-copy
    where alignment allows)
  * ``BagWriter`` + encoders — used by tests to author real-format bags and
    by users to repackage data
  * ``bag_to_sweeplog`` — converter into the native sweeplog format so the
    C++ prefetch ring (runtime/sweeplog.cc) owns the hot replay path
  * ``scan_stream``   — (scan dict, imu interval) iterator for run.py --bag

Compression: 'none' and 'bz2' chunks via stdlib; 'lz4' (the default of many
recorders) via the pure-Python frame decoder in ``io/lz4.py``.
"""
from __future__ import annotations

import bz2
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# record op codes
OP_MSG = 0x02
OP_BAGHDR = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNKINFO = 0x06
OP_CONN = 0x07

MAGIC = b"#ROSBAG V2.0\n"

# PointField datatypes (sensor_msgs/PointField)
_PF_NP = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64,
}


# ---------------------------------------------------------------------------
# low-level record plumbing
# ---------------------------------------------------------------------------


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    """Bag record header: sequence of <len u32><name>=<value>."""
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        entry = buf[off:off + flen]
        off += flen
        eq = entry.index(b"=")
        fields[entry[:eq]] = entry[eq + 1:]
    return fields


def _encode_header(fields: Dict[bytes, bytes]) -> bytes:
    out = b""
    for k, v in fields.items():
        entry = k + b"=" + v
        out += struct.pack("<I", len(entry)) + entry
    return out


def _read_record(f) -> Optional[Tuple[Dict[bytes, bytes], bytes]]:
    head = f.read(4)
    if len(head) < 4:
        return None
    (hlen,) = struct.unpack("<I", head)
    hbuf = f.read(hlen)
    if len(hbuf) < hlen:
        return None                     # truncated mid-header
    header = _parse_header(hbuf)
    dl = f.read(4)
    if len(dl) < 4:
        return None
    (dlen,) = struct.unpack("<I", dl)
    data = f.read(dlen)
    if len(data) < dlen:
        # file.read short-reads at EOF without raising — a half-written
        # trailing record must not masquerade as a complete one
        return None
    return header, data


def _u32(v: int) -> bytes:
    return struct.pack("<I", v)


def _u64(v: int) -> bytes:
    return struct.pack("<Q", v)


def _time(sec: float) -> bytes:
    s = int(sec)
    ns = int(round((sec - s) * 1e9))
    return struct.pack("<II", s, ns)


class Connection:
    def __init__(self, conn_id: int, topic: str, fields: Dict[bytes, bytes]):
        self.id = conn_id
        self.topic = topic
        self.type = fields.get(b"type", b"").decode()
        self.md5sum = fields.get(b"md5sum", b"").decode()


class BagReader:
    """Sequential top-level scan: connections + chunk-embedded messages in
    file order (works on indexed and unindexed bags alike)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        magic = self._f.read(len(MAGIC))
        if magic != MAGIC:
            raise IOError(f"{path}: not a rosbag v2.0 file (magic {magic!r})")
        self.connections: Dict[int, Connection] = {}

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def _handle_conn(self, header: Dict[bytes, bytes], data: bytes):
        conn_id = struct.unpack("<I", header[b"conn"])[0]
        topic = header[b"topic"].decode()
        self.connections[conn_id] = Connection(conn_id, topic, _parse_header(data))

    def read_messages(
        self, topics: Optional[List[str]] = None
    ) -> Iterator[Tuple[str, float, bytes, Connection]]:
        """Yields (topic, unix_time_sec, serialized message, connection)."""
        import io as _io

        f = self._f
        f.seek(len(MAGIC))
        while True:
            try:
                rec = _read_record(f)
            except (struct.error, ValueError, IndexError):
                # truncated trailing record (crashed recorder): like
                # `rosbag play` on an unindexed bag, replay what was readable
                print(f"[rosbag] {self.path}: truncated record at EOF; "
                      "stopping replay")
                return
            if rec is None:
                return
            try:
                yield from self._process_record(rec, topics)
            except (struct.error, ValueError, KeyError, IndexError) as e:
                # corrupt record body (bit rot / fuzzed bytes): corrupt
                # compressed chunks, missing header keys, non-UTF8 topic
                # strings (UnicodeDecodeError is a ValueError), short
                # structs — stop replay gracefully, never leak the raw
                # exception (seeded fuzz sweep: test_rosbag.py)
                msg = str(e) or type(e).__name__
                print(f"[rosbag] {self.path}: corrupt record ({msg}); "
                      "stopping replay")
                return

    def _process_record(self, rec, topics):
        """Yield the messages of one top-level record; raises ValueError
        (and friends) on corruption — read_messages turns that into a
        graceful stop."""
        import io as _io

        header, data = rec
        op = header.get(b"op", b"\x00")[0]
        if op == OP_CONN:
            self._handle_conn(header, data)
        elif op == OP_CHUNK:
            comp = header.get(b"compression", b"none").decode()
            if comp == "bz2":
                try:
                    data = bz2.decompress(data)
                except (OSError, EOFError) as e:
                    raise ValueError(f"corrupt bz2 chunk ({e})")
            elif comp == "lz4":
                # the default chunk compression of many recorders — pure
                # Python frame/block decoder (io/lz4.py); ValueError and
                # IndexError (malformed length-extension runs) propagate to
                # read_messages' graceful stop
                from . import lz4 as _lz4

                data = _lz4.decompress(data)
            elif comp != "none":
                raise IOError(
                    f"{self.path}: unsupported chunk compression "
                    f"{comp!r} (supported: none, bz2, lz4)"
                )
            sub = _io.BytesIO(data)
            while True:
                r = _read_record(sub)
                if r is None:
                    break
                h2, d2 = r
                op2 = h2.get(b"op", b"\x00")[0]
                if op2 == OP_CONN:
                    self._handle_conn(h2, d2)
                elif op2 == OP_MSG:
                    conn_id = struct.unpack("<I", h2[b"conn"])[0]
                    s, ns = struct.unpack("<II", h2[b"time"])
                    conn = self.connections.get(conn_id)
                    if conn is None:
                        continue
                    if topics is None or conn.topic in topics:
                        yield conn.topic, s + ns * 1e-9, d2, conn
        elif op == OP_MSG:
            # unchunked message (rare; some tools write them top-level)
            conn_id = struct.unpack("<I", header[b"conn"])[0]
            s, ns = struct.unpack("<II", header[b"time"])
            conn = self.connections.get(conn_id)
            if conn is not None and (topics is None or conn.topic in topics):
                yield conn.topic, s + ns * 1e-9, data, conn
        # OP_BAGHDR / OP_INDEX / OP_CHUNKINFO: skipped (scan is sequential)


# ---------------------------------------------------------------------------
# ROS1 message decoding (little-endian length-prefixed primitives)
# ---------------------------------------------------------------------------


class _Cursor:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u8(self):
        v = self.buf[self.off]
        self.off += 1
        return v

    def u16(self):
        (v,) = struct.unpack_from("<H", self.buf, self.off)
        self.off += 2
        return v

    def i8(self):
        (v,) = struct.unpack_from("<b", self.buf, self.off)
        self.off += 1
        return v

    def u32(self):
        (v,) = struct.unpack_from("<I", self.buf, self.off)
        self.off += 4
        return v

    def f64(self):
        (v,) = struct.unpack_from("<d", self.buf, self.off)
        self.off += 8
        return v

    def f64s(self, n):
        v = np.frombuffer(self.buf, np.float64, n, self.off)
        self.off += 8 * n
        return v

    def string(self):
        n = self.u32()
        v = self.buf[self.off:self.off + n]
        self.off += n
        return v

    def bytes_(self, n):
        v = self.buf[self.off:self.off + n]
        self.off += n
        return v

    def header(self):
        """std_msgs/Header -> stamp seconds."""
        self.u32()                      # seq
        s = self.u32()
        ns = self.u32()
        self.string()                   # frame_id
        return s + ns * 1e-9


def read_pointcloud2(raw: bytes) -> dict:
    """sensor_msgs/PointCloud2 -> dict(stamp, xyz, intensity, ring, time).

    ring/time come from the named PointFields when present (Velodyne drivers
    emit 'ring' and 't'/'time'/'timestamp'); absent channels return None and
    the caller falls back to the reference's vertical-angle / azimuth
    formulas (io/convert.py, scanRegistration.cpp:115-231)."""
    c = _Cursor(raw)
    stamp = c.header()
    height = c.u32()
    width = c.u32()
    nf = c.u32()
    fields = []
    for _ in range(nf):
        name = c.string().decode()
        offset = c.u32()
        datatype = c.u8()
        count = c.u32()
        fields.append((name, offset, datatype, count))
    if c.u8():                          # is_bigendian
        # every ROS1 driver in the wild writes little-endian; silently
        # byte-swapping risks masking recorder corruption — reject loudly
        raise IOError(
            "PointCloud2 declares is_bigendian=1; big-endian point data is "
            "unsupported (re-record on a little-endian host)"
        )
    point_step = c.u32()
    c.u32()                             # row_step
    nbytes = c.u32()
    data = c.bytes_(nbytes)
    c.u8()                              # is_dense

    n = height * width
    if n == 0 or point_step == 0:
        return {"stamp": stamp, "xyz": np.zeros((0, 3), np.float32),
                "intensity": None, "ring": None, "time": None}

    by_name = {f[0]: f for f in fields}

    def channel(names):
        for nm in names:
            if nm in by_name:
                _, off, dt, _ = by_name[nm]
                npdt = _PF_NP[dt]
                # strided slice over the packed point records (handles any
                # field alignment, unlike a structured-dtype view)
                arr = np.frombuffer(data[: n * point_step], dtype=np.uint8)
                arr = arr.reshape(n, point_step)
                width_b = np.dtype(npdt).itemsize
                return arr[:, off:off + width_b].copy().view(npdt).reshape(n)
        return None

    x = channel(["x"])
    y = channel(["y"])
    z = channel(["z"])
    xyz = np.stack([x, y, z], axis=1).astype(np.float32)
    inten = channel(["intensity", "i"])
    ring = channel(["ring"])
    # per-point time: drivers disagree on name and meaning (absolute vs
    # offset); normalized to sweep-relative [0,1) by the caller
    ptime = channel(["time", "t", "timestamp", "time_offset"])
    return {
        "stamp": stamp,
        "xyz": xyz,
        "intensity": None if inten is None else inten.astype(np.float32),
        "ring": None if ring is None else ring.astype(np.int32),
        "time": None if ptime is None else ptime.astype(np.float64),
    }


def read_imu(raw: bytes) -> dict:
    """sensor_msgs/Imu -> dict(stamp, acc [3], gyr [3], quat [4 xyzw])."""
    c = _Cursor(raw)
    stamp = c.header()
    quat = c.f64s(4).copy()
    c.f64s(9)
    gyr = c.f64s(3).copy()
    c.f64s(9)
    acc = c.f64s(3).copy()
    c.f64s(9)
    return {"stamp": stamp, "acc": acc, "gyr": gyr, "quat": quat}


def read_navsatfix(raw: bytes) -> dict:
    """sensor_msgs/NavSatFix -> dict(stamp, lat, lon, alt) (A7 GNSS path).
    status is a nested NavSatStatus (int8 + uint16) WITHOUT its own header."""
    c = _Cursor(raw)
    stamp = c.header()
    c.i8()                              # status.status
    c.u16()                             # status.service
    lat = c.f64()
    lon = c.f64()
    alt = c.f64()
    return {"stamp": stamp, "lat": lat, "lon": lon, "alt": alt}


# ---------------------------------------------------------------------------
# writing (tests author real-format bags; users repackage data)
# ---------------------------------------------------------------------------


def encode_pointcloud2(
    stamp: float,
    xyz: np.ndarray,
    intensity: Optional[np.ndarray] = None,
    ring: Optional[np.ndarray] = None,
    rel_time: Optional[np.ndarray] = None,
    frame_id: bytes = b"velodyne",
    bigendian: bool = False,
) -> bytes:
    """Serialize a sensor_msgs/PointCloud2 (x,y,z,intensity[,ring][,time]).

    ``bigendian=True`` only SETS the flag (the payload stays little-endian):
    a fixture hook for testing the reader's loud rejection of such bags."""
    n = len(xyz)
    fields = [(b"x", 0, 7, 1), (b"y", 4, 7, 1), (b"z", 8, 7, 1)]
    step = 12
    cols = [np.ascontiguousarray(xyz, np.float32)]
    if intensity is not None:
        fields.append((b"intensity", step, 7, 1))
        cols.append(np.ascontiguousarray(intensity, np.float32)[:, None])
        step += 4
    if ring is not None:
        fields.append((b"ring", step, 4, 1))
        step += 2
    if rel_time is not None:
        # 2-byte ring leaves 'time' unaligned — rosbag layouts do this too
        fields.append((b"time", step, 7, 1))
        step += 4
    buf = np.zeros((n, step), np.uint8)
    off = 0
    for col in cols:
        b = col.view(np.uint8).reshape(n, -1)
        buf[:, off:off + b.shape[1]] = b
        off += b.shape[1]
    if ring is not None:
        b = np.ascontiguousarray(ring, np.uint16)[:, None].view(np.uint8).reshape(n, -1)
        buf[:, off:off + 2] = b
        off += 2
    if rel_time is not None:
        b = np.ascontiguousarray(rel_time, np.float32)[:, None].view(np.uint8).reshape(n, -1)
        buf[:, off:off + 4] = b
        off += 4

    s = int(stamp)
    ns = int(round((stamp - s) * 1e9))
    out = struct.pack("<IIII", 0, s, ns, len(frame_id)) + frame_id
    out += _u32(1) + _u32(n)            # height=1, width=n
    out += _u32(len(fields))
    for name, foff, dt, cnt in fields:
        out += _u32(len(name)) + name + _u32(foff) + bytes([dt]) + _u32(cnt)
    out += b"\x01" if bigendian else b"\x00"    # is_bigendian
    out += _u32(step) + _u32(step * n)
    out += _u32(step * n) + buf.tobytes()
    out += b"\x01"                      # is_dense
    return out


def encode_imu(stamp: float, acc, gyr, quat=None, frame_id: bytes = b"imu") -> bytes:
    s = int(stamp)
    ns = int(round((stamp - s) * 1e9))
    out = struct.pack("<IIII", 0, s, ns, len(frame_id)) + frame_id
    q = np.asarray(quat if quat is not None else [0, 0, 0, 1], np.float64)
    cov = np.zeros(9, np.float64)
    out += q.tobytes() + cov.tobytes()
    out += np.asarray(gyr, np.float64).tobytes() + cov.tobytes()
    out += np.asarray(acc, np.float64).tobytes() + cov.tobytes()
    return out


_MD5 = {
    "sensor_msgs/PointCloud2": "1158d486dd51d683ce2f1be655c3c181",
    "sensor_msgs/Imu": "6a62c6daae103f4ff57a132d6f95cec2",
    "sensor_msgs/NavSatFix": "2d3a8cd499b9b4a0249fb98fd05cfa48",
}


class BagWriter:
    """Minimal well-formed rosbag v2.0 writer: one uncompressed chunk per
    ``chunk_size`` messages, with index/chunk-info records and a back-patched
    bag header, so standard ROS tooling can also open the output."""

    def __init__(self, path: str, chunk_size: int = 200, compression: str = "none"):
        assert compression in ("none", "bz2", "lz4")
        self._compression = compression
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        # bag header placeholder (op=3), padded to 4096 total data bytes
        hdr = _encode_header({
            b"op": bytes([OP_BAGHDR]),
            b"index_pos": _u64(0),
            b"conn_count": _u32(0),
            b"chunk_count": _u32(0),
        })
        pad = 4096 - len(hdr)
        self._f.write(_u32(len(hdr)) + hdr + _u32(pad) + b" " * pad)
        self._conns: Dict[str, int] = {}
        self._conn_records: List[bytes] = []
        self._chunk: List[Tuple[int, float, bytes]] = []
        self._chunk_size = chunk_size
        self._chunk_infos: List[bytes] = []
        self._n_chunks = 0

    def _connection(self, topic: str, msg_type: str) -> int:
        if topic in self._conns:
            return self._conns[topic]
        cid = len(self._conns)
        self._conns[topic] = cid
        conn_hdr = _encode_header({
            b"op": bytes([OP_CONN]), b"conn": _u32(cid),
            b"topic": topic.encode(),
        })
        conn_data = _encode_header({
            b"topic": topic.encode(),
            b"type": msg_type.encode(),
            b"md5sum": _MD5.get(msg_type, "*").encode(),
            b"message_definition": b"",
        })
        rec = _u32(len(conn_hdr)) + conn_hdr + _u32(len(conn_data)) + conn_data
        self._conn_records.append(rec)
        # connections must also appear inside a chunk before their messages
        self._chunk.append((-1, 0.0, rec))
        return cid

    def write(self, topic: str, msg_type: str, stamp: float, raw: bytes):
        cid = self._connection(topic, msg_type)
        hdr = _encode_header({
            b"op": bytes([OP_MSG]), b"conn": _u32(cid), b"time": _time(stamp),
        })
        rec = _u32(len(hdr)) + hdr + _u32(len(raw)) + raw
        self._chunk.append((cid, stamp, rec))
        if sum(1 for c, _, _ in self._chunk if c >= 0) >= self._chunk_size:
            self._flush_chunk()

    def _flush_chunk(self):
        if not self._chunk:
            return
        payload = b"".join(rec for _, _, rec in self._chunk)
        chunk_pos = self._f.tell()
        if self._compression == "bz2":
            wire = bz2.compress(payload)
        elif self._compression == "lz4":
            from . import lz4 as _lz4

            wire = _lz4.compress_frame(payload)
        else:
            wire = payload
        hdr = _encode_header({
            b"op": bytes([OP_CHUNK]),
            b"compression": self._compression.encode(),
            b"size": _u32(len(payload)),
        })
        self._f.write(_u32(len(hdr)) + hdr + _u32(len(wire)) + wire)
        # per-connection index records (ver 1): each entry carries the
        # message's byte offset within the UNCOMPRESSED chunk payload —
        # standard rosbag readers seek by it, so 0 would make them re-read
        # the chunk's first record for every message
        by_conn: Dict[int, List] = {}
        times = []
        off = 0
        for c, t, rec in self._chunk:
            if c >= 0:
                by_conn.setdefault(c, []).append((t, off))
                times.append(t)
            off += len(rec)
        for c, entries in by_conn.items():
            ih = _encode_header({
                b"op": bytes([OP_INDEX]), b"ver": _u32(1),
                b"conn": _u32(c), b"count": _u32(len(entries)),
            })
            idata = b"".join(_time(t) + _u32(o) for t, o in entries)
            self._f.write(_u32(len(ih)) + ih + _u32(len(idata)) + idata)
        ci_hdr_fields = {
            b"op": bytes([OP_CHUNKINFO]), b"ver": _u32(1),
            b"chunk_pos": _u64(chunk_pos),
            b"start_time": _time(min(times) if times else 0.0),
            b"end_time": _time(max(times) if times else 0.0),
            b"count": _u32(len(by_conn)),
        }
        ci_data = b"".join(_u32(c) + _u32(len(ts)) for c, ts in by_conn.items())
        ci = _encode_header(ci_hdr_fields)
        self._chunk_infos.append(_u32(len(ci)) + ci + _u32(len(ci_data)) + ci_data)
        self._n_chunks += 1
        self._chunk = []

    def close(self):
        self._flush_chunk()
        index_pos = self._f.tell()
        for rec in self._conn_records:
            self._f.write(rec)
        for rec in self._chunk_infos:
            self._f.write(rec)
        # back-patch the bag header
        self._f.seek(len(MAGIC))
        hdr = _encode_header({
            b"op": bytes([OP_BAGHDR]),
            b"index_pos": _u64(index_pos),
            b"conn_count": _u32(len(self._conns)),
            b"chunk_count": _u32(self._n_chunks),
        })
        pad = 4096 - len(hdr)
        self._f.write(_u32(len(hdr)) + hdr + _u32(pad) + b" " * pad)
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# ---------------------------------------------------------------------------
# scan assembly (the run.py --bag feed and the sweeplog converter)
# ---------------------------------------------------------------------------

CLOUD_TOPIC = "/velodyne_points"        # run.launch remap target
IMU_TOPIC = "/mynteye/imu/data_raw"     # RGC_odometer.cpp:365


def scan_stream(
    path: str,
    cloud_topic: str = CLOUD_TOPIC,
    imu_topic: str = IMU_TOPIC,
    n_scans_sensor: int = 16,
    scan_period: float = 0.1,
) -> Iterator[dict]:
    """Iterate (scan + its IMU interval) from a bag, in time order.

    Mirrors the reference's queue sync: each PointCloud2 is paired with the
    IMU samples in (prev_stamp, stamp] (getIMUInterval,
    RGC_odometer.cpp:883-931).  Missing ring/time channels fall back to the
    vertical-angle / azimuth formulas like scanRegistration.cpp:115-231."""
    from .convert import rel_time_from_azimuth, ring_from_vertical_angle

    reader = BagReader(path)
    imu_buf: List[dict] = []
    prev_stamp: Optional[float] = None
    for topic, t, raw, conn in reader.read_messages([cloud_topic, imu_topic]):
        if topic == imu_topic:
            imu_buf.append(read_imu(raw))
            continue
        pc = read_pointcloud2(raw)
        stamp = pc["stamp"] or t
        xyz = pc["xyz"]
        valid = np.isfinite(xyz).all(axis=1)
        if pc["ring"] is not None:
            ring = pc["ring"]
            # a ring channel wider than the configured sensor silently
            # corrupts the organize step's per-ring bookkeeping (clipped
            # gathers) — fail loudly with the config fix instead
            if valid.any() and int(ring[valid].max()) >= n_scans_sensor:
                raise ValueError(
                    f"bag ring channel has rings up to "
                    f"{int(ring[valid].max())} but the config expects "
                    f"{n_scans_sensor} — pass --n-scans-sensor "
                    f"{int(ring[valid].max()) + 1} on the CLI (or set "
                    f"SlamConfig.n_scans) to match the sensor"
                )
        else:
            ring, rv = ring_from_vertical_angle(xyz, n_scans_sensor)
            valid &= rv
        if pc["time"] is not None:
            ptime = pc["time"].astype(np.float64)
            # normalize absolute / offset stamps to sweep fraction [0, 1)
            lo = ptime[valid].min() if valid.any() else 0.0
            span = (ptime[valid].max() - lo) if valid.any() else 0.0
            rel = (ptime - lo) / span if span > 1e-9 else np.zeros_like(ptime)
        else:
            rel = rel_time_from_azimuth(xyz)
        inten = pc["intensity"]
        if inten is None:
            inten = np.zeros(len(xyz), np.float32)
        lo_t = prev_stamp if prev_stamp is not None else stamp - scan_period
        seg = [m for m in imu_buf if lo_t < m["stamp"] <= stamp]
        imu_buf = [m for m in imu_buf if m["stamp"] > stamp]
        seg.sort(key=lambda m: m["stamp"])
        prev_stamp = stamp
        yield {
            "stamp": stamp,
            "xyz": xyz[valid],
            "intensity": np.asarray(inten, np.float32)[valid],
            "ring": np.asarray(ring, np.int32)[valid],
            "rel_time": np.asarray(rel, np.float32)[valid],
            "imu_t": np.asarray([m["stamp"] for m in seg], np.float64),
            "imu_acc": np.stack([m["acc"] for m in seg]) if seg else np.zeros((0, 3)),
            "imu_gyr": np.stack([m["gyr"] for m in seg]) if seg else np.zeros((0, 3)),
        }
    reader.close()


def bag_to_sweeplog(
    bag_path: str,
    out_path: str,
    cloud_topic: str = CLOUD_TOPIC,
    imu_topic: str = IMU_TOPIC,
    n_rings: int = 16,
) -> int:
    """Convert a rosbag into the native sweeplog; returns scan count."""
    from ..runtime.loader import SweepLogWriter

    n = 0
    with SweepLogWriter(out_path, n_rings) as w:
        for s in scan_stream(bag_path, cloud_topic, imu_topic, n_rings):
            w.add_scan(
                s["stamp"], s["xyz"], s["intensity"], s["rel_time"], s["ring"],
                s["imu_t"], s["imu_acc"], s["imu_gyr"],
            )
            n += 1
    return n


def _main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="rosbag -> sweeplog converter (no ROS needed)"
    )
    ap.add_argument("bag")
    ap.add_argument("out", help="output .slog path")
    ap.add_argument("--cloud-topic", default=CLOUD_TOPIC)
    ap.add_argument("--imu-topic", default=IMU_TOPIC)
    ap.add_argument("--rings", type=int, default=16)
    args = ap.parse_args(argv)
    n = bag_to_sweeplog(args.bag, args.out, args.cloud_topic, args.imu_topic,
                        args.rings)
    print(f"converted {n} scans -> {args.out}")


if __name__ == "__main__":
    _main()
