"""tests/test_rosbag.py's malformed and unusual inputs through both
packages' ``io/rosbag`` and ``io/lz4``.

Each case builds its input once (tests/test_rosbag.py's writer and seeds,
through the JAX package's ``BagWriter``; the port's writer gives the same
bytes, tests/test_torch_io.py) and hands the same bytes to both readers.
The outcome must be the same in both: the same scans, field for field and
bit for bit, or an exception of the same type.  The fuzz cases compare
every cut or flipped byte this way.  The cases are tests/test_rosbag.py's
lines 141 (a ring channel past the config), 280 (a truncated legacy lz4
block), 294 (a cut length run), 311 (a corrupt lz4 chunk), 331 (a
truncated tail), 402 (a big-endian cloud), 410 (misaligned fields), 424
(the truncation fuzz, for each compression) and 454 (the byte-flip fuzz);
and the unusual but valid inputs of lines 109 (a bag to a sweep log: the
same log bytes), 125 (a NavSatFix), 194 (32 rings against a 32-ring
config), 212 (hand-made lz4 blocks and frames), 348 (messages at the top
level, outside any chunk) and 381 (repeated latched connections).
"""
import struct

import numpy as np
import pytest

from rgc_slam_tpu.io import lz4 as j_lz4
from rgc_slam_tpu.io import rosbag as j_rosbag
from rgc_slam_tpu_torch.io import lz4 as t_lz4
from rgc_slam_tpu_torch.io import rosbag as t_rosbag
from test_rosbag import _make_scan, _write_bag

PACKAGES = {"jax": (j_rosbag, j_lz4), "port": (t_rosbag, t_lz4)}


def _outcome(fn):
    """("ok", value) or ("raised", exception type)."""
    try:
        return "ok", fn()
    except Exception as exc:          # the outcome under test
        return "raised", type(exc)


def _same(a, b, where=""):
    """The same value: dicts and lists element-wise, arrays bit for bit."""
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def _both(run, what):
    """``run(rosbag, lz4)`` in each package; the outcomes must agree."""
    (kind_j, jv), (kind_t, tv) = (_outcome(lambda m=m: run(*m)) for m in PACKAGES.values())
    assert kind_t == kind_j, (what, kind_t, tv, kind_j, jv)
    if kind_t == "raised":
        assert tv is jv, (what, tv, jv)
    else:
        _same(tv, jv, what)
    return kind_t, tv


def _stream(path, **kw):
    return lambda rb, _: list(rb.scan_stream(path, **kw))


def _bag(tmp_path, name, seed, **kw) -> bytes:
    path = str(tmp_path / name)
    _write_bag(path, np.random.default_rng(seed), **kw)
    with open(path, "rb") as f:
        return f.read()


def _put(tmp_path, name, data: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def ring_exceeding_config(tmp_path):
    rng = np.random.default_rng(42)
    path = str(tmp_path / "r32.bag")
    with j_rosbag.BagWriter(path) as w:
        xyz = rng.uniform(-10, 10, (100, 3)).astype(np.float32)
        ring = rng.integers(0, 32, 100).astype(np.uint16)
        ring[0] = 31
        w.write("/velodyne_points", "sensor_msgs/PointCloud2", 1.0,
                j_rosbag.encode_pointcloud2(1.0, xyz, None, ring, None))
    assert _both(_stream(path, n_scans_sensor=16), "r32")[0] == "raised"


def lz4_legacy_truncated_block(tmp_path):
    raw = b"hello corridor" * 100
    blk = j_lz4._encode_block_naive(raw)
    legacy = struct.pack("<I", j_lz4.LEGACY_MAGIC) + struct.pack("<I", len(blk)) + blk
    assert _both(lambda _, lz4: lz4.decompress(legacy), "whole") == ("ok", raw)
    cut = legacy[: len(legacy) // 2]
    assert _both(lambda _, lz4: lz4.decompress(cut), "cut")[0] == "raised"


def lz4_malformed_length_run(tmp_path):
    frame = (struct.pack("<I", j_lz4.FRAME_MAGIC) + bytes([0x40, 0x70, 0x00])
             + struct.pack("<I", 1) + b"\xf0" + struct.pack("<I", 0))
    assert _both(lambda _, lz4: lz4.decompress(frame), "frame")[0] == "raised"


def corrupt_lz4_chunk(tmp_path):
    raw = bytearray(_bag(tmp_path, "c.bag", 9, compression="lz4"))
    pos = raw.find(struct.pack("<I", j_lz4.FRAME_MAGIC))
    assert pos > 0
    raw[pos + 7: pos + 15] = b"\xf0" * 8
    kind, scans = _both(_stream(_put(tmp_path, "bad.bag", bytes(raw))), "corrupt")
    assert kind == "ok" and len(scans) < 4


def truncated_tail(tmp_path):
    full = _bag(tmp_path, "t.bag", 6, n_scans=4)
    kind, scans = _both(_stream(_put(tmp_path, "trunc.bag", full[:len(full) - len(full) // 5])),
                        "tail")
    assert kind == "ok" and 1 <= len(scans) < 4


def bigendian_cloud(tmp_path):
    raw = j_rosbag.encode_pointcloud2(1.0, np.zeros((10, 3), np.float32), bigendian=True)
    assert _both(lambda rb, _: rb.read_pointcloud2(raw), "bigendian")[0] == "raised"


def misaligned_fields(tmp_path):
    xyz, inten, ring, rel = _make_scan(np.random.default_rng(8), n=64)
    raw = j_rosbag.encode_pointcloud2(2.0, xyz, inten, ring, rel)
    kind, out = _both(lambda rb, _: rb.read_pointcloud2(raw), "misaligned")
    assert kind == "ok"
    np.testing.assert_array_equal(out["ring"], ring)


def truncation_fuzz(compression):
    def case(tmp_path):
        full = _bag(tmp_path, f"fz_{compression}.bag", 11, compression=compression)
        fuzz = np.random.default_rng(1234)
        for cut in sorted(set(int(c) for c in fuzz.integers(1, len(full), size=25))):
            _both(_stream(_put(tmp_path, "cut.bag", full[:cut])), f"cut at {cut}")
    return case


def byteflip_fuzz(tmp_path):
    full = _bag(tmp_path, "flip.bag", 12, compression="lz4")
    fuzz = np.random.default_rng(99)
    for off in sorted(set(int(c) for c in fuzz.integers(13, len(full), size=20))):
        flipped = bytearray(full)
        flipped[off] ^= 0xA5
        _both(_stream(_put(tmp_path, "flip_cut.bag", bytes(flipped))), f"flip at {off}")


def bag_to_sweeplog(tmp_path):
    bag = _put(tmp_path, "s.bag", _bag(tmp_path, "src.bag", 5))
    logs = {}
    for name, (rb, _) in PACKAGES.items():
        out = str(tmp_path / f"{name}.slog")
        assert rb.bag_to_sweeplog(bag, out) == 4
        with open(out, "rb") as f:
            logs[name] = f.read()
    assert logs["port"] == logs["jax"]


def navsatfix(tmp_path):
    frame = b"gps"
    msg = struct.pack("<IIII", 0, 5, 500000000, len(frame)) + frame
    msg += struct.pack("<bH", 0, 1) + struct.pack("<ddd", 31.5, 120.25, 12.0)
    msg += np.zeros(9, np.float64).tobytes() + b"\x00"
    kind, fix = _both(lambda rb, _: rb.read_navsatfix(msg), "navsatfix")
    assert kind == "ok" and abs(fix["stamp"] - 5.5) < 1e-9 and fix["lat"] == 31.5


def ring32_with_matching_config(tmp_path):
    rng = np.random.default_rng(42)
    path = str(tmp_path / "ok32.bag")
    with j_rosbag.BagWriter(path) as w:
        xyz = rng.uniform(-10, 10, (100, 3)).astype(np.float32)
        ring = rng.integers(0, 32, 100).astype(np.uint16)
        w.write("/velodyne_points", "sensor_msgs/PointCloud2", 1.0,
                j_rosbag.encode_pointcloud2(1.0, xyz, None, ring, None))
    kind, scans = _both(_stream(path, n_scans_sensor=32), "ok32")
    assert kind == "ok" and len(scans) == 1 and scans[0]["ring"].max() < 32


def lz4_blocks_and_frames(tmp_path):
    def block(data):
        def run(_, lz4):
            out = bytearray()
            lz4._decode_block(data, out)
            return bytes(out)
        return run

    overlap = bytes([0x36]) + b"abc" + struct.pack("<H", 3)
    assert _both(block(overlap), "overlap") == ("ok", b"abcabcabcabca")
    raw = bytes(range(256)) * 3
    assert _both(block(j_lz4._encode_block_naive(raw)), "literals") == ("ok", raw)
    data = b"The quick brown fox jumps over the lazy dog. " * 100
    legacy = (struct.pack("<I", j_lz4.LEGACY_MAGIC)
              + struct.pack("<I", len(j_lz4._encode_block_naive(data)))
              + j_lz4._encode_block_naive(data))
    for what, frame in (("linked", j_lz4.compress_frame(data, block_size=512)),
                        ("stored", j_lz4.compress_frame(data, stored=True)),
                        ("legacy", legacy)):
        assert _both(lambda _, lz4: lz4.decompress(frame), what) == ("ok", data)
    garbage = b"\x00\x01\x02\x03\x04\x05\x06\x07"
    assert _both(lambda _, lz4: lz4.decompress(garbage), "garbage")[0] == "raised"


def unchunked_toplevel_messages(tmp_path):
    from rgc_slam_tpu.io.rosbag import (
        MAGIC, OP_BAGHDR, OP_CONN, OP_MSG, _encode_header, _time, _u32, _u64,
    )

    msg = j_rosbag.encode_imu(10.0, [0, 0, 9.81], [0, 0, 0])
    hdr = _encode_header({b"op": bytes([OP_BAGHDR]), b"index_pos": _u64(0),
                          b"conn_count": _u32(1), b"chunk_count": _u32(0)})
    ch = _encode_header({b"op": bytes([OP_CONN]), b"conn": _u32(0), b"topic": b"/imu"})
    cd = _encode_header({b"topic": b"/imu", b"type": b"sensor_msgs/Imu", b"md5sum": b"*",
                         b"message_definition": b""})
    mh = _encode_header({b"op": bytes([OP_MSG]), b"conn": _u32(0), b"time": _time(10.0)})
    path = _put(tmp_path, "flat.bag", MAGIC + _u32(len(hdr)) + hdr + _u32(4) + b"    "
                + _u32(len(ch)) + ch + _u32(len(cd)) + cd + _u32(len(mh)) + mh
                + _u32(len(msg)) + msg)

    def read(rb, _):
        with rb.BagReader(path) as r:
            return [(topic, t, raw) for topic, t, raw, _ in r.read_messages()]

    kind, out = _both(read, "flat")
    assert kind == "ok" and len(out) == 1 and out[0][0] == "/imu"


def duplicate_latched_connections(tmp_path):
    from rgc_slam_tpu.io.rosbag import OP_CONN, _encode_header, _u32

    dup = _encode_header({b"op": bytes([OP_CONN]), b"conn": _u32(0),
                          b"topic": b"/mynteye/imu/data_raw"})
    dupd = _encode_header({b"topic": b"/mynteye/imu/data_raw", b"type": b"sensor_msgs/Imu",
                           b"md5sum": b"*", b"message_definition": b""})
    data = _bag(tmp_path, "d.bag", 7, n_scans=3) + _u32(len(dup)) + dup + _u32(len(dupd)) + dupd
    kind, scans = _both(_stream(_put(tmp_path, "dup.bag", data)), "latched")
    assert kind == "ok" and len(scans) == 3 and len(scans[0]["imu_t"]) == 10


CASES = {
    "ring exceeding config (test_rosbag.py:141)": ring_exceeding_config,
    "lz4 legacy truncated block (:280)": lz4_legacy_truncated_block,
    "lz4 malformed length run (:294)": lz4_malformed_length_run,
    "corrupt lz4 chunk (:311)": corrupt_lz4_chunk,
    "truncated tail (:331)": truncated_tail,
    "big-endian cloud (:402)": bigendian_cloud,
    "misaligned fields (:410)": misaligned_fields,
    **{f"truncation fuzz, {c} (:424)": truncation_fuzz(c) for c in ("none", "lz4", "bz2")},
    "byte-flip fuzz (:454)": byteflip_fuzz,
    "bag to sweep log (:109)": bag_to_sweeplog,
    "NavSatFix (:125)": navsatfix,
    "32 rings, 32-ring config (:194)": ring32_with_matching_config,
    "lz4 blocks and frames (:212)": lz4_blocks_and_frames,
    "top-level messages (:348)": unchunked_toplevel_messages,
    "duplicate latched connections (:381)": duplicate_latched_connections,
}


@pytest.mark.parametrize("case", list(CASES))
def test_same_outcome_in_both_packages(tmp_path, case):
    CASES[case](tmp_path)
