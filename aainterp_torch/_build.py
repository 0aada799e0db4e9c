"""Build the port's native libraries at first use and load them with ctypes.

Ten libraries, each from one source with a plain C interface (no
PyTorch headers), so each builds in seconds:

* ``separable_apply`` — ``csrc/separable_apply.cu`` through nvcc;
* ``separable_apply_2d`` — ``csrc/separable_apply_2d.cu`` (the 2-D
  banded-tile apply of the band-operator family) through nvcc; both
  separable kernels include the shared device code of
  ``csrc/band_apply.cuh``;
* ``ell_shear`` — ``csrc/ell_shear.cu`` (the rotated apply's shear
  kernel, in three forms, and its contraction) through nvcc;
* ``shear3_stage`` — ``csrc/shear3_stage.cu`` (the two stage kernels of
  ``mode='shear'``) through nvcc;
* ``probes`` — ``csrc/probes.cu`` (the row-tiled copy of the copy
  ceiling, a ring of 1-D bulk copies on ``csrc/hopper.cuh``, and the
  rotated contraction's probe modes) through nvcc;
* ``band_probes`` — ``csrc/band_probes.cu`` (kernel 1's probe modes:
  the instances of ``csrc/band_apply.cuh`` under its probe modes, and
  the walk probe's launch geometry) through
  nvcc, a library of its own so that it builds beside the others;
* ``aligned_fused`` — ``csrc/aligned_fused.cu`` (the fused aligned
  regrid probe: both passes of an aligned integer-ratio apply in one
  kernel) through nvcc;
* ``watchlist`` — ``csrc/watchlist.cu`` (the Mosaic watchlist's six
  probes on TMA, 1-D bulk copies with mbarriers and wgmma, from the
  Hopper primitives of ``csrc/hopper.cuh``) through nvcc;
* ``dense_x`` — ``csrc/dense_x.cu`` (kernel 1's dense-x probe: the y
  pass, then a dense x operator as a wgmma product on a bf16 split, on
  ``csrc/hopper.cuh``) through nvcc;
* ``aainterp_native`` — the repository's host weight-gen and CSV engine,
  ``native/aainterp_native.cpp``, through g++ with the flags of
  ``native/Makefile``.

The four CUDA sources of the production kernels include
``csrc/stage_common.cuh``, the staging helpers of their staged kernels;
``ell_shear.cu`` and ``probes.cu`` include ``csrc/contract.cuh``, the
contraction's tiled form and its direct form under its probe modes
(``probes.cu`` also ``csrc/hopper.cuh`` and ``csrc/stage_common.cuh``
for the copy's bulk copies and shared-memory opt-in); ``separable_apply.cu``,
``separable_apply_2d.cu`` and ``band_probes.cu`` include
``csrc/band_apply.cuh``, the separable kernels' body under its probe
modes (it includes ``csrc/hopper.cuh`` for the walk probe's ring);
``watchlist.cu`` and ``dense_x.cu`` include ``csrc/hopper.cuh``
and, for the shared-memory opt-in, ``csrc/stage_common.cuh``.

Each shared library lands in ``aainterp_torch/_build/`` under a name that
carries a hash of its source, the headers it includes, its compiler and
flags: a changed source
rebuilds, an unchanged one loads the library already there.  The
compiler writes a temporary file that is renamed into place, so
concurrent processes (parallel test workers) never load a half-written
library.  Nothing is built when the package is imported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# native/Makefile's CXXFLAGS; -ffp-contract=off keeps the double results
# equal to the numpy weight-gen's (no fused multiply-adds)
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall",
             "-ffp-contract=off")

_P, _I = ctypes.c_void_p, ctypes.c_int
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


@dataclasses.dataclass(frozen=True)
class Library:
    """One shared library: its source, compiler and C symbols."""

    name: str
    source: Path
    compiler: str                       # "nvcc" or "g++"
    flags: Tuple[str, ...]
    # symbol -> (argtypes, restype)
    symbols: Tuple[Tuple[str, tuple, object], ...]
    headers: Tuple[Path, ...] = ()     # files the source includes


_STAGE_HEADER = _PKG / "csrc" / "stage_common.cuh"
_CONTRACT_HEADER = _PKG / "csrc" / "contract.cuh"
_BAND_HEADERS = (_PKG / "csrc" / "band_apply.cuh",
                 _PKG / "csrc" / "hopper.cuh", _STAGE_HEADER)

SEPARABLE = Library(
    "separable_apply", _PKG / "csrc" / "separable_apply.cu", "nvcc",
    NVCC_FLAGS,
    # aainterp_separable_apply(src, out, ys, wy, xs, wx, row_base,
    #     col_base, F, H, W, Hd, Wd, ky, kx, TY, TX, SY, SX, in_code,
    #     out_code, stream)
    (("aainterp_separable_apply", (_P,) * 8 + (_I,) * 13 + (_P,),
      ctypes.c_int),),
    headers=_BAND_HEADERS)

SEPARABLE_2D = Library(
    "separable_apply_2d", _PKG / "csrc" / "separable_apply_2d.cu", "nvcc",
    NVCC_FLAGS,
    # aainterp_separable_apply_2d(src, out, ys, wy, xs, wx, row_base,
    #     col_base, F, H, W, Hd, Wd, ky, kx, TY, TX, SY, SX, mode,
    #     in_code, out_code, stream)
    (("aainterp_separable_apply_2d", (_P,) * 8 + (_I,) * 14 + (_P,),
      ctypes.c_int),
     # aainterp_separable_apply_2d_direct(src, out, T, ys, wy, xs, wx, F,
     #     H, W, Hd, Wd, ky, kx, c0, span, vec, mode, in_code, out_code,
     #     stream)
     ("aainterp_separable_apply_2d_direct", (_P,) * 7 + (_I,) * 13 + (_P,),
      ctypes.c_int)),
    headers=_BAND_HEADERS)

ELL_SHEAR = Library(
    "ell_shear", _PKG / "csrc" / "ell_shear.cu", "nvcc", NVCC_FLAGS,
    (
        # aainterp_vshear(q, S, gy, win, F, qH, qW, TH, TY, TX, win_rows,
        #     win_cols, elem_bytes, stream)
        ("aainterp_vshear", (_P,) * 4 + (_I,) * 9 + (_P,), ctypes.c_int),
        # aainterp_hshear(S, T, hx, win, F, TH, qW, TW, TY, TX, win_rows,
        #     win_cols, elem_bytes, stream)
        ("aainterp_hshear", (_P,) * 4 + (_I,) * 9 + (_P,), ctypes.c_int),
        # aainterp_vhshear(q, T, gy, hx, win, F, qH, qW, TH, TW, TY, TX,
        #     win_rows, win_cols, elem_bytes, stream)
        ("aainterp_vhshear", (_P,) * 5 + (_I,) * 10 + (_P,), ctypes.c_int),
        # aainterp_contract(T, out, ry0, cx0, w2, span, tiles, F, TH, TW,
        #     Hd, Wd, Ka, Kb, TYd, TXd, smem, dtype_code, stream)
        ("aainterp_contract", (_P,) * 7 + (_I,) * 11 + (_P,), ctypes.c_int),
        # aainterp_contract_direct(T, out, ry0, cx0, w2, span, F, TH, TW,
        #     Hd, Wd, Ka, Kb, dtype_code, stream)
        ("aainterp_contract_direct", (_P,) * 6 + (_I,) * 8 + (_P,),
         ctypes.c_int),
        # aainterp_contract_unmasked(T, out, ry0, cx0, w2, F, TH, TW, Hd,
        #     Wd, Ka, Kb, dtype_code, stream)
        ("aainterp_contract_unmasked", (_P,) * 5 + (_I,) * 8 + (_P,),
         ctypes.c_int),
    ),
    headers=(_CONTRACT_HEADER, _STAGE_HEADER))

SHEAR3_STAGE = Library(
    "shear3_stage", _PKG / "csrc" / "shear3_stage.cu", "nvcc", NVCC_FLAGS,
    # aainterp_shear3_{y,x}stage(x, out, d, f, start, w, inv_cov, win, F,
    #     n_lines, n_in, n_mid, n_t, crop, n_out, K, form, TL, TU, max_win,
    #     max_mid, in_code, out_code, stream)
    tuple((f"aainterp_shear3_{axis}stage", (_P,) * 8 + (_I,) * 15 + (_P,),
           ctypes.c_int) for axis in ("y", "x")),
    headers=(_STAGE_HEADER,))

PROBES = Library(
    "probes", _PKG / "csrc" / "probes.cu", "nvcc", NVCC_FLAGS,
    (
        # aainterp_copy_rows(src, dst, F, H, W, TY, elem_bytes, stream)
        ("aainterp_copy_rows", (_P,) * 2 + (_I,) * 5 + (_P,), ctypes.c_int),
        # aainterp_contract_probe(T, out, ry0, cx0, w2, span, tiles, order,
        #     F, TH, TW, Hd, Wd, Ka, Kb, TYd, TXd, smem, wtile, n_live, mode,
        #     dtype_code, stream)
        ("aainterp_contract_probe", (_P,) * 8 + (_I,) * 14 + (_P,),
         ctypes.c_int),
    ),
    headers=(_CONTRACT_HEADER, _PKG / "csrc" / "hopper.cuh", _STAGE_HEADER))

BAND_PROBES = Library(
    "band_probes", _PKG / "csrc" / "band_probes.cu", "nvcc", NVCC_FLAGS,
    (
        # aainterp_band_probe(src, out, ys, wy, xs, wx, row_base, col_base,
        #     F, H, W, Hd, Wd, ky, kx, TY, TX, SY, SX, mode, dtype_code,
        #     stream)
        ("aainterp_band_probe", (_P,) * 8 + (_I,) * 13 + (_P,), ctypes.c_int),
        # aainterp_band_walk_grid(H, W, Hd, Wd, ky, kx, TY, TX, SY, SX,
        #     mode, dtype_code, out[4])
        ("aainterp_band_walk_grid", (_I,) * 12 + (_P,), ctypes.c_int),
        # aainterp_band_stage(src, out, ys, wy, xs, wx, row_base, col_base,
        #     F, H, W, Hd, Wd, ky, kx, TY, TX, SY, SX, mode, dtype_code,
        #     stream)
        ("aainterp_band_stage", (_P,) * 8 + (_I,) * 13 + (_P,),
         ctypes.c_int),
        # aainterp_band_stage_grid(H, W, Hd, Wd, ky, kx, TY, TX, SY, SX,
        #     mode, dtype_code, out[4])
        ("aainterp_band_stage_grid", (_I,) * 12 + (_P,), ctypes.c_int),
    ),
    headers=_BAND_HEADERS)

ALIGNED_FUSED = Library(
    "aligned_fused", _PKG / "csrc" / "aligned_fused.cu", "nvcc", NVCC_FLAGS,
    # aainterp_aligned_fused(src, out, wky, wkx, F, H, W, Hd, Wd, my, mx,
    #     c0y, c0x, TXc, stream)
    (("aainterp_aligned_fused", (_P,) * 4 + (_I,) * 10 + (_P,),
      ctypes.c_int),))

WATCHLIST = Library(
    "watchlist", _PKG / "csrc" / "watchlist.cu", "nvcc", NVCC_FLAGS,
    (
        # aainterp_strided_y_bf16(x, out, frames, rows, m, C, frame, parity,
        #     R, stream)
        ("aainterp_strided_y_bf16", (_P,) * 2 + (_I,) * 7 + (_P,),
         ctypes.c_int),
        # aainterp_strided_load(x, out, R, W, stream)
        ("aainterp_strided_load", (_P,) * 2 + (_I,) * 2 + (_P,), ctypes.c_int),
        # aainterp_value_slice(x, out, R, W, stream)
        ("aainterp_value_slice", (_P,) * 2 + (_I,) * 2 + (_P,), ctypes.c_int),
        # aainterp_unaligned_dma(x, out, H, W, r0, n, stream)
        ("aainterp_unaligned_dma", (_P,) * 2 + (_I,) * 4 + (_P,),
         ctypes.c_int),
        # aainterp_high_dot(a, b, out, M, N, K, stream)
        ("aainterp_high_dot", (_P,) * 3 + (_I,) * 3 + (_P,), ctypes.c_int),
        # aainterp_vpu_dyn_rows(x, off, out, rows, C, R, stream)
        ("aainterp_vpu_dyn_rows", (_P,) * 3 + (_I,) * 3 + (_P,),
         ctypes.c_int),
    ),
    headers=(_PKG / "csrc" / "hopper.cuh", _STAGE_HEADER))

DENSE_X = Library(
    "dense_x", _PKG / "csrc" / "dense_x.cu", "nvcc", NVCC_FLAGS,
    # aainterp_dense_x(frames, out, ys, wy, row_base, ops, F, H, W, Hd, Wd,
    #     ky, SY, warpgroups, window_budget, dtype_code, stream)
    (("aainterp_dense_x", (_P,) * 6 + (_I,) * 10 + (_P,), ctypes.c_int),),
    headers=(_PKG / "csrc" / "hopper.cuh", _STAGE_HEADER))

NATIVE = Library(
    "aainterp_native", _PKG.parent / "native" / "aainterp_native.cpp", "g++",
    GXX_FLAGS,
    # aai_ell_weights(Hd, Wd, K, qH, qW, p00x, p00y, exx, exy, eyx, eyy,
    #     L, cos, sin, scale, mode, normalise, n_threads, base, w, sums)
    (("aai_ell_weights", (ctypes.c_int,) * 5 + (ctypes.c_double,) * 10
      + (ctypes.c_int,) * 3 + (_I32P, _F64P, _F64P), None),
     # aai_compat_cell_areas(n_pix, Km, modH, modW, qvx, qvy, mx0, my0,
     #     n_threads, areas)
     ("aai_compat_cell_areas", (ctypes.c_int64,) + (ctypes.c_int,) * 3
      + (_F64P, _F64P, _I64P, _I64P, ctypes.c_int, _F64P), None),
     # aai_csv_read(path, buf, cap_rows, cap_cols, &h, &w) -> rc
     ("aai_csv_read", (ctypes.c_char_p, _F64P, ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int)), ctypes.c_int),
     # aai_csv_write(path, data, h, w, sig_digits) -> rc
     ("aai_csv_write", (ctypes.c_char_p, _F64P) + (ctypes.c_int,) * 3,
      ctypes.c_int)))

_LOADED: Dict[str, ctypes.CDLL] = {}   # library name -> CDLL, once per process


def _which(names: Sequence[str], env_homes: Sequence[str], default: str,
           what: str) -> str:
    for var in env_homes:
        home = os.environ.get(var)
        if home and (Path(home) / "bin" / names[0]).exists():
            return str(Path(home) / "bin" / names[0])
    for n in names:
        found = shutil.which(n)
        if found:
            return found
    if default and Path(default).exists():
        return default
    raise RuntimeError(
        f"{what} not found; aainterp_torch builds its native libraries "
        "from source at first use")


def compiler_path(compiler: str) -> str:
    """The executable for ``compiler``: nvcc from CUDA_HOME / CUDA_PATH /
    PATH / /usr/local/cuda, g++ from CXX / PATH."""
    if compiler == "nvcc":
        return _which(["nvcc"], ["CUDA_HOME", "CUDA_PATH"],
                      "/usr/local/cuda/bin/nvcc",
                      "nvcc (set CUDA_HOME or put nvcc on PATH)")
    cxx = os.environ.get("CXX")
    if cxx and shutil.which(cxx):
        return shutil.which(cxx)
    return _which(["g++", "c++"], [], "", "g++ (set CXX or put g++ on PATH)")


def library_path(lib: Library) -> Path:
    """Where ``lib`` built from its current source and flags lives."""
    h = hashlib.sha256(lib.source.read_bytes())
    for header in lib.headers:
        h.update(header.read_bytes())
    h.update(" ".join((lib.compiler,) + lib.flags).encode())
    return BUILD_DIR / f"lib{lib.name}_{h.hexdigest()[:16]}.so"


def build_many(libs: Sequence[Library]) -> Dict[str, Path]:
    """Compile every library whose hashed .so is missing, all compilers
    running at once; return {name: path}.  Raises on any failure."""
    jobs, paths = [], {}
    for lib in libs:
        so = library_path(lib)
        paths[lib.name] = so
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [compiler_path(lib.compiler), *lib.flags, "-o", tmp,
               str(lib.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((lib, so, tmp, cmd, proc))
    errors = []
    for lib, so, tmp, cmd, proc in jobs:
        try:
            out, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{lib.compiler} failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{out}{err}")
                continue
            if err.strip():
                print(err.strip())
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def build(lib: Library) -> Path:
    """Compile ``lib`` if its hashed .so is missing; return its path."""
    return build_many([lib])[lib.name]


def load(lib: Library) -> ctypes.CDLL:
    """Build (if needed) and load ``lib``, with its argtypes set.

    Loaded once per process: the source is hashed at the first call only
    (re-reading it on every launch cost ~100 µs of host time).
    """
    hit = _LOADED.get(lib.name)
    if hit is not None:
        return hit
    cdll = ctypes.CDLL(str(build(lib)))
    for sym, argtypes, restype in lib.symbols:
        fn = getattr(cdll, sym)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    _LOADED[lib.name] = cdll
    return cdll


def timed_build(libs: Sequence[Library] = (SEPARABLE,)) -> float:
    """Seconds to build ``libs`` from scratch, in parallel (removes their
    old .so files first)."""
    for lib in libs:
        library_path(lib).unlink(missing_ok=True)
    t0 = time.perf_counter()
    build_many(libs)
    return time.perf_counter() - t0
