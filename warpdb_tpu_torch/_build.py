"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with :mod:`ctypes`.  The
build runs at first use, into ``build/torch_kernels/`` at the repository
root (listed in ``.gitignore``), and is keyed by a hash of the source and
the flags, so an edited source rebuilds and an unchanged one loads the
library already built.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from .errors import ExecutionError

__all__ = ["KERNELS", "build_all", "load", "build_dir", "source_path"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

# kernel name -> (C entry point, argtypes).  Every pointer and the stream
# are c_void_p; ints that carry sizes are c_int / c_longlong.
KERNELS = {
    "topk": ("warpdb_topk_candidates", [_P, _LL, _I, _P, _I, _P]),
    "group_hist": (
        "warpdb_group_hist",
        [_P, _LL, _I, _P, _P, _P, _P, _I, _P, _P, _I, _P],
    ),
    "windowed_expand": (
        "warpdb_windowed_expand",
        [_P, _LL, _LL, _P, _I, _P, _LL, _P, _P, _P, _LL, _P],
    ),
    "uniform_expand": (
        "warpdb_uniform_expand", [_P, _I, _LL, _LL, _LL, _P, _LL, _P],
    ),
    "sorted_take": (
        "warpdb_sorted_take", [_P, _I, _P, _P, _LL, _P, _LL, _I, _P],
    ),
}

_lock = threading.Lock()
_loaded: dict = {}


def build_dir() -> Path:
    return _PKG.parent / "build" / "torch_kernels"


def source_path(name: str) -> Path:
    return _CSRC / f"{name}.cu"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise ExecutionError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of warpdb_tpu_torch build from source at first use"
    )


def _library_path(name: str) -> Path:
    src = source_path(name).read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}_{tag}.so"


def _compile(name: str) -> Path:
    out = _library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise ExecutionError(
            f"nvcc failed for {source_path(name).name} "
            f"(rc {proc.returncode}):\n{proc.stderr}{proc.stdout}"
        )
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        path = _compile(name)
        lib = ctypes.CDLL(str(path))
        symbol, argtypes = KERNELS[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = lib
        return lib


def build_all() -> dict:
    """Build (or find) and load every kernel, the nvcc processes running
    in parallel; returns ``{name: library path}``."""
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        paths = dict(zip(KERNELS, pool.map(_compile, KERNELS)))
    for name in KERNELS:
        load(name)
    return {name: str(p) for name, p in paths.items()}
