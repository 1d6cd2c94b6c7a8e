"""Build, load and count the hand-written CUDA kernels.

Each kernel is one source in `csrc/` with a plain C launcher. `nvcc` compiles
it for `sm_90a` into a shared library under `_build/` (kept out of git) on
first use, and `ctypes` loads it: no PyTorch headers, so a build takes
seconds. `build()` starts one `nvcc` per source, all at once.

`LAUNCHES` counts, per kernel, the launches its wrapper made; `SITES` splits
them by caller. A wrapper adds one where it launches its kernel and nowhere
else, so a run can show that its path went through the kernels. While a
CUDA graph is captured (`capturing`), the wrapper's count goes to the
graph's own record instead, and every replay of the graph adds that record
(`add`): a launch is counted each time the card runs it.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import os
import shutil
import subprocess
from pathlib import Path

_ROOT = Path(__file__).resolve().parent
CSRC = _ROOT / "csrc"
BUILD = _ROOT / "_build"
SOURCES = ("cc", "knn")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

LAUNCHES: collections.Counter = collections.Counter()
SITES: collections.Counter = collections.Counter()
_CAPTURES: list = []  # (launches, sites) of the captures in progress, innermost last

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of each launcher (all return a cudaError_t as int).
_SIGNATURES = {
    "cc": {
        "cc_label_prop_setup": [_I, _I],
        "cc_label_prop_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "knn": {
        "knn_top5_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    },
}
_LIBS: dict = {}


def reset_counts():
    LAUNCHES.clear()
    SITES.clear()


def count(kernel: str, site: str = ""):
    launches, sites = _CAPTURES[-1] if _CAPTURES else (LAUNCHES, SITES)
    launches[kernel] += 1
    if site:
        sites[f"{kernel}@{site}"] += 1


@contextlib.contextmanager
def capturing():
    """While a CUDA graph is captured: the launches recorded into it, as a
    (launches, sites) pair of Counters, which `add` counts per replay."""
    record = (collections.Counter(), collections.Counter())
    _CAPTURES.append(record)
    try:
        yield record
    finally:
        _CAPTURES.pop()


def add(record):
    """Count the launches of one replay of a captured graph."""
    LAUNCHES.update(record[0])
    SITES.update(record[1])


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def _lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    return not lib.exists() or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime


def build(names=SOURCES, force: bool = False) -> dict:
    """Compile the named sources in parallel (one nvcc each). Returns each
    source's ptxas report; raises RuntimeError if any build fails. Each
    library is written to a file of this process's own and renamed into
    place, so processes that build at once never load a half-written one."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if not force and not _stale(name):
            continue
        tmp = _lib_path(name).with_suffix(f".so.{os.getpid()}.tmp")
        cmd = [
            _nvcc(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu"),
        ]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    reports, failed = {}, []
    for name, (tmp, p) in procs.items():
        out, _ = p.communicate()
        reports[name] = out
        if p.returncode == 0:
            os.replace(tmp, _lib_path(name))
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}.cu (rc {p.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def library(name: str):
    """The loaded launcher library for csrc/<name>.cu, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            build((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, args in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require(t, name, dtype, device, shape=None):
    """Device, dtype, shape and contiguity checks of a wrapper's input."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
