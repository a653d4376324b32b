"""Python bindings for the native sweep-log runtime (ctypes).

A copy of ``rgc_slam_tpu/runtime/loader.py`` with its own build: the
library is compiled with ``g++`` from the port's copy of the source
(``runtime/sweeplog.cc``) at first use, into ``rgc_slam_tpu_torch/_build/``
(rebuilt when the source is newer), and never beside the source; the port
never loads the JAX package's library.  A failed build raises.
``SweepLogWriter`` / ``SweepLogReader`` wrap the C API; the reader runs the
native background-prefetch thread so host decode overlaps device compute
(the role of the reference's topic queues + polling threads, SURVEY §5.8).
``tests/test_torch_io.py`` holds the files and arrays to the original's.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Iterator, Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "runtime", "sweeplog.cc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libsweeplog.so")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def build() -> str:
    """Compile ``runtime/sweeplog.cc`` unless the library is newer than the
    source; returns the library path.  The library is written under a
    temporary name and renamed, so concurrent builds never load a partial
    file."""
    if os.path.exists(LIBRARY) and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE):
        return LIBRARY
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", SOURCE, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.slog_writer_open.restype = ctypes.c_void_p
            lib.slog_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
            lib.slog_writer_add_scan.restype = ctypes.c_int
            lib.slog_writer_add_scan.argtypes = [
                ctypes.c_void_p, ctypes.c_double, ctypes.c_uint32,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint16),
                ctypes.c_uint32, ctypes.POINTER(ctypes.c_float),
            ]
            lib.slog_writer_close.restype = ctypes.c_int
            lib.slog_writer_close.argtypes = [ctypes.c_void_p]
            lib.slog_open.restype = ctypes.c_void_p
            lib.slog_open.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32),
            ]
            lib.slog_start_prefetch.restype = ctypes.c_int
            lib.slog_start_prefetch.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
            lib.slog_next.restype = ctypes.c_int
            lib.slog_next.argtypes = [
                ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.slog_close.restype = ctypes.c_int
            lib.slog_close.argtypes = [ctypes.c_void_p]
            lib.pcd_sink_open.restype = ctypes.c_void_p
            lib.pcd_sink_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
            lib.pcd_sink_push.restype = ctypes.c_int
            lib.pcd_sink_push.argtypes = [
                ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
                ctypes.POINTER(ctypes.c_float),
            ]
            lib.pcd_sink_close.restype = ctypes.c_int
            lib.pcd_sink_close.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def _fp(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class SweepLogWriter:
    def __init__(self, path: str, n_rings: int = 16):
        self._lib = get_lib()
        self._h = self._lib.slog_writer_open(path.encode(), n_rings)
        if not self._h:
            raise IOError(f"cannot open {path} for writing")

    def add_scan(self, stamp: float, xyz: np.ndarray, intensity: np.ndarray,
                 rel_time: np.ndarray, ring: np.ndarray,
                 imu_t: np.ndarray, imu_acc: np.ndarray, imu_gyr: np.ndarray):
        xyz = np.ascontiguousarray(xyz, np.float32)
        inten = np.ascontiguousarray(intensity, np.float32)
        rt = np.ascontiguousarray(rel_time, np.float32)
        rg = np.ascontiguousarray(ring, np.uint16)
        imu = np.ascontiguousarray(
            np.concatenate([imu_t[:, None], imu_acc, imu_gyr], axis=1), np.float32,
        ) if len(imu_t) else np.zeros((0, 7), np.float32)
        rc = self._lib.slog_writer_add_scan(
            self._h, float(stamp), len(xyz),
            _fp(xyz, ctypes.c_float), _fp(inten, ctypes.c_float),
            _fp(rt, ctypes.c_float), _fp(rg, ctypes.c_uint16),
            len(imu), _fp(imu, ctypes.c_float),
        )
        if rc != 0:
            raise IOError("slog_writer_add_scan failed")

    def close(self):
        if self._h:
            self._lib.slog_writer_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class SweepLogReader:
    """Reads padded scans; with ``prefetch`` the decode runs in a native
    background thread with a bounded ring buffer."""

    def __init__(self, path: str, pad_points: int, pad_imu: int, prefetch: int = 4):
        self._lib = get_lib()
        ns = ctypes.c_uint32()
        nr = ctypes.c_uint32()
        self._h = self._lib.slog_open(path.encode(), ctypes.byref(ns), ctypes.byref(nr))
        if not self._h:
            raise IOError(f"cannot open {path}")
        self.n_scans = ns.value
        self.n_rings = nr.value
        self.pad_points = pad_points
        self.pad_imu = pad_imu
        if prefetch:
            self._lib.slog_start_prefetch(self._h, prefetch)

    def __iter__(self) -> Iterator[dict]:
        while True:
            s = self.next()
            if s is None:
                return
            yield s

    def next(self) -> Optional[dict]:
        pp, pi = self.pad_points, self.pad_imu
        xyz = np.empty((pp, 3), np.float32)
        inten = np.empty(pp, np.float32)
        rt = np.empty(pp, np.float32)
        ring = np.empty(pp, np.int32)
        mask = np.empty(pp, np.uint8)
        imu = np.empty((pi, 7), np.float32)
        imu_mask = np.empty(pi, np.uint8)
        stamp = ctypes.c_double()
        npo = ctypes.c_uint32()
        nio = ctypes.c_uint32()
        rc = self._lib.slog_next(
            self._h, pp, pi, ctypes.byref(stamp), ctypes.byref(npo), ctypes.byref(nio),
            _fp(xyz, ctypes.c_float), _fp(inten, ctypes.c_float),
            _fp(rt, ctypes.c_float), _fp(ring, ctypes.c_int32),
            _fp(mask, ctypes.c_uint8), _fp(imu, ctypes.c_float),
            _fp(imu_mask, ctypes.c_uint8),
        )
        if rc == 1:
            return None
        if rc != 0:
            raise IOError(f"slog_next failed rc={rc}")
        return {
            "stamp": stamp.value,
            "xyz": xyz,
            "intensity": inten,
            "rel_time": rt,
            "ring": ring,
            "mask": mask.astype(bool),
            "imu_t": imu[:, 0],
            "imu_acc": imu[:, 1:4],
            "imu_gyr": imu[:, 4:7],
            "imu_mask": imu_mask.astype(bool),
        }

    def close(self):
        if self._h:
            self._lib.slog_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def write_sequence(path: str, seq: dict, n_rings: int = 16):
    """Serialize a synthetic sequence dict (io/synthetic.generate_sequence)
    into a sweep log."""
    with SweepLogWriter(path, n_rings) as w:
        for k, scan in enumerate(seq["scans"]):
            t_imu, acc, gyr = seq["imu"][k]
            m = scan["mask"]
            w.add_scan(
                seq["stamps"][k], scan["xyz"][m], scan["intensity"][m],
                scan["rel_time"][m], scan["ring"][m], t_imu, acc, gyr,
            )


class PcdSink:
    """Async per-frame PCD writer: frames go into a native bounded queue and
    a background thread writes them, so the replay loop never stalls on disk
    (the reference writes per-frame PCDs inline on its odometry thread,
    RGC_odometer.cpp:1353-1354).  push blocks only when the queue is full
    (backpressure — bounded memory, lossless)."""

    def __init__(self, out_dir: str, ring_slots: int = 8):
        os.makedirs(out_dir, exist_ok=True)
        self._lib = get_lib()
        self._h = self._lib.pcd_sink_open(out_dir.encode(), ring_slots)
        if not self._h:
            raise IOError(f"cannot open PCD sink at {out_dir}")

    def push(self, index: int, xyz: np.ndarray):
        xyz = np.ascontiguousarray(xyz, np.float32)
        rc = self._lib.pcd_sink_push(self._h, index, len(xyz), _fp(xyz, ctypes.c_float))
        if rc != 0:
            raise IOError("PCD sink closed")

    def close(self) -> int:
        """Drains and joins; returns the number of write errors."""
        if self._h:
            err = self._lib.pcd_sink_close(self._h)
            self._h = None
            return err
        return 0

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
