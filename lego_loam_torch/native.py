"""ctypes bindings for the native host runtime (`native/lego_native.cpp`):
scan prep, PointCloud2 payload decode, KITTI reads and the double-buffered
background scan feeder (≙ the reference's Channel<T> + worker threads).
Port of `lego_loam_tpu/native.py`.

The library is built here from the repository's source with `g++ -O3` into
the gitignored `_build/` at first use, and rebuilt when the source is newer
(`native/Makefile` adds `-march=native`, so a library built on one host can
stop with an illegal instruction on another; the tracked
`native/liblego_native.so` is never loaded). When the build or the load
fails, every native call raises with the compiler's output: nothing falls
back to numpy quietly. The numpy versions stay beside them as the plain
twins (`prep_cloud_plain`, `read_kitti_bin_plain`,
`decode_pointcloud2_plain`, `ScanFeederPlain`), with the library's exact
semantics, and the tests hold each native call against its twin.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

_ROOT = Path(__file__).resolve().parent
SOURCE = _ROOT.parent / "native" / "lego_native.cpp"
LIBRARY = _ROOT / "_build" / "liblego_native.so"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_P = ctypes.POINTER
_F, _U8 = _P(ctypes.c_float), _P(ctypes.c_uint8)
_SIGNATURES = {
    "lego_prep_cloud": (ctypes.c_int, [_F, ctypes.c_int, ctypes.c_int, _F, _U8]),
    "lego_read_kitti_bin": (ctypes.c_int, [ctypes.c_char_p, _F, ctypes.c_int]),
    "lego_decode_pointcloud2": (ctypes.c_int, [_U8] + [ctypes.c_int] * 5 + [_F]),
    "lego_feeder_create": (ctypes.c_void_p, [_P(ctypes.c_char_p)] + [ctypes.c_int] * 4),
    "lego_feeder_next": (ctypes.c_long, [ctypes.c_void_p, _F, _U8, _P(ctypes.c_double)]),
    "lego_feeder_destroy": (None, [ctypes.c_void_p]),
}
_lib = None
_lock = threading.Lock()


def build(force: bool = False) -> str:
    """Compile `native/lego_native.cpp` into `_build/liblego_native.so`
    when the library is missing or older than the source (or `force`).
    Returns the compiler's output ('' when nothing was built); raises
    RuntimeError with that output when g++ fails."""
    if not force and LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return ""
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename: a concurrent build never loads a half-written file
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.{threading.get_ident()}")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {cmd[0]} to build {SOURCE}: {e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE} failed (rc {r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, LIBRARY)
    return r.stdout + r.stderr


def library():
    """The loaded native library, built first if needed; raises on a failed
    build or load."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIBRARY))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def _fptr(a):
    return a.ctypes.data_as(_F)


def _u8ptr(a):
    return a.ctypes.data_as(_U8)


def _points(pts) -> np.ndarray:
    pts = np.asarray(pts)
    if pts.ndim != 2 or pts.shape[1] < 3:
        raise ValueError(f"points must be (N, >=3), got {pts.shape}")
    return np.ascontiguousarray(pts[:, :3], np.float32)


def prep_cloud(pts: np.ndarray, cap: int):
    """NaN-filter + pad: (cap, 3) float32, rows with a non-finite
    coordinate zeroed, and the (cap,) bool mask of finite rows."""
    pts = _points(pts)
    buf = np.empty((cap, 3), np.float32)
    mask = np.empty((cap,), np.uint8)
    library().lego_prep_cloud(_fptr(pts), len(pts), cap, _fptr(buf), _u8ptr(mask))
    return buf, mask.astype(bool)


def prep_cloud_plain(pts: np.ndarray, cap: int):
    """The plain twin of `prep_cloud`."""
    pts = _points(pts)[:cap]
    k = len(pts)
    mask = np.zeros((cap,), bool)
    mask[:k] = np.isfinite(pts).all(axis=1)
    buf = np.zeros((cap, 3), np.float32)
    buf[:k] = np.where(mask[:k, None], pts, np.float32(0))
    return buf, mask


def read_kitti_bin(path: str, cap: int = 1 << 18) -> np.ndarray:
    """(n, 3) float32 x, y, z of a KITTI .bin's whole (x, y, z,
    reflectance) records, at most cap."""
    out = np.empty((cap, 3), np.float32)
    n = library().lego_read_kitti_bin(os.fsencode(path), _fptr(out), cap)
    if n < 0:
        raise FileNotFoundError(path)
    return out[:n]


def read_kitti_bin_plain(path: str, cap: int = 1 << 18) -> np.ndarray:
    """The plain twin of `read_kitti_bin`."""
    raw = np.fromfile(path, dtype=np.float32)
    return raw[: len(raw) // 4 * 4].reshape(-1, 4)[:cap, :3].copy()


def _payload(data, n_points: int, point_step: int, offsets) -> np.ndarray:
    buf = np.frombuffer(data, np.uint8)
    need = (n_points - 1) * point_step + max(offsets) + 4 if n_points else 0
    if len(buf) < need or min(offsets) < 0:
        raise ValueError(f"payload of {len(buf)} bytes holds no {n_points} records of {point_step} bytes")
    return buf


def decode_pointcloud2(data, n_points: int, point_step: int, x_off: int, y_off: int, z_off: int):
    """(n_points, 3) float32 x, y, z gathered from a PointCloud2 payload at
    the given byte offsets within each point_step-byte record."""
    buf = _payload(data, n_points, point_step, (x_off, y_off, z_off))
    out = np.empty((n_points, 3), np.float32)
    library().lego_decode_pointcloud2(_u8ptr(buf), n_points, point_step, x_off, y_off, z_off, _fptr(out))
    return out


def decode_pointcloud2_plain(data, n_points: int, point_step: int, x_off: int, y_off: int, z_off: int):
    """The plain twin of `decode_pointcloud2`."""
    buf = _payload(data, n_points, point_step, (x_off, y_off, z_off))
    cols = [np.lib.stride_tricks.as_strided(buf[o:], (n_points, 4), (point_step, 1)) for o in (x_off, y_off, z_off)]
    return np.stack([np.ascontiguousarray(c).view(np.float32)[:, 0] for c in cols], axis=1)


class ScanFeeder:
    """Background-thread KITTI scan feeder with Channel semantics.

    `latest_wins=False` blocks the producer when the queue is full (the
    projection->FA channel, main.cpp:10); `latest_wins=True` drops the oldest
    (the FA->MO channel, main.cpp:11). Scan k of the readable files carries
    timestamp 0.1 k (the library's; a sequence's times.txt is not read)."""

    def __init__(self, files: Sequence[str], cap: int, latest_wins: bool = False, depth: int = 2):
        self.cap = cap
        self._lib = library()
        self._files = (ctypes.c_char_p * len(files))(*[os.fsencode(f) for f in files])
        self._handle = self._lib.lego_feeder_create(self._files, len(files), cap, int(latest_wins), depth)

    def next(self):
        """Returns (index, buf (cap, 3), mask (cap,), timestamp), or None at
        the end of the stream."""
        if self._handle is None:
            raise RuntimeError("ScanFeeder is closed")
        buf = np.empty((self.cap, 3), np.float32)
        mask = np.empty((self.cap,), np.uint8)
        ts = ctypes.c_double()
        idx = self._lib.lego_feeder_next(self._handle, _fptr(buf), _u8ptr(mask), ctypes.byref(ts))
        if idx < 0:
            return None
        return idx, buf, mask.astype(bool), ts.value

    def close(self):
        """Stops the worker thread and frees the queue."""
        if self._handle is not None:
            self._lib.lego_feeder_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self.close()


class ScanFeederPlain:
    """The plain twin of `ScanFeeder`: the same scans, indices and
    timestamps, read in the caller's thread (nothing is dropped)."""

    def __init__(self, files: Sequence[str], cap: int):
        self.cap = cap
        self._files = iter(list(files))
        self._idx = 0

    def next(self):
        for path in self._files:
            if not os.path.isfile(path):
                continue  # the library skips a file it cannot open
            buf, mask = prep_cloud_plain(read_kitti_bin_plain(path, self.cap), self.cap)
            idx, self._idx = self._idx, self._idx + 1
            return idx, buf, mask, 0.1 * idx
        return None

    def close(self):
        self._files = iter(())
