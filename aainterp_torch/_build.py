"""Build the CUDA kernel with nvcc at first use and load it with ctypes.

The source under ``csrc/`` has a plain C interface (no PyTorch headers),
so one ``nvcc`` call builds it in seconds.  The shared library lands in
``aainterp_torch/_build/`` under a name that carries a hash of the source
and flags: a changed source rebuilds, an unchanged one loads the library
already there.  Nothing is built when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "separable_apply.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
_P, _I = ctypes.c_void_p, ctypes.c_int
# aainterp_separable_apply(src, out, ys, wy, xs, wx, col_base,
#     F, H, W, Hd, Wd, ky, kx, TY, TX, S, in_code, out_code, stream)
ARGTYPES = [_P] * 7 + [_I] * 12 + [_P]

_LOADED: list = []   # the loaded CDLL, once per process


def nvcc_path() -> str:
    """The nvcc to build with: CUDA_HOME's, else the one on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernel of aainterp_torch is built from source at first use")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libseparable_apply_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if its hashed .so is missing; return its path.

    The compiler writes to a temporary file that is renamed into place, so
    concurrent processes never load a half-written library.
    """
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                f"{res.stdout}{res.stderr}")
        if res.stderr.strip():
            print(res.stderr.strip())
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library, with its argtypes set.

    Loaded once per process: the source is hashed at the first call only
    (re-reading it on every launch cost ~100 µs of host time).
    """
    if _LOADED:
        return _LOADED[0]
    lib = ctypes.CDLL(str(build()))
    lib.aainterp_separable_apply.argtypes = ARGTYPES
    lib.aainterp_separable_apply.restype = ctypes.c_int
    _LOADED.append(lib)
    return lib


def timed_build() -> float:
    """Seconds to build the library from scratch (removes its old .so)."""
    library_path().unlink(missing_ok=True)
    t0 = time.perf_counter()
    build()
    return time.perf_counter() - t0
