"""ctypes binding of the native C++ ELL weight-gen and CSV engine.

Counterpart of ``ell_weights_native``, ``compat_cell_areas_native``,
``csv_read_native`` and ``csv_write_native`` in ``aainterp/native.py``.  The library is the repository's own
``native/aainterp_native.cpp``, built unchanged by ``_build`` with g++
and the flags of ``native/Makefile`` into ``aainterp_torch/_build/`` at
first use (a temporary file renamed into place, so parallel processes
never load a half-written library).  The engine is a host-side
accelerator — multithreaded weight-gen, about 10-50x the vectorised numpy
path on large grids — and not a correctness dependency:
``ops.weights.ell_operator`` and ``ops.compat.compat_ell_weights`` fall
back to numpy with a RuntimeWarning when it cannot be built or loaded,
and ``utils.io`` to its Python reader and writer (``available()``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from . import _build

_AVAILABLE: Optional[bool] = None


def available() -> bool:
    """Whether the engine builds and loads here (decided once per
    process; a failed build is not retried)."""
    global _AVAILABLE
    if _AVAILABLE is None:
        try:
            _build.load(_build.NATIVE)
            _AVAILABLE = True
        except (RuntimeError, OSError):
            _AVAILABLE = False
    return _AVAILABLE


def ell_weights_native(spec, mode: str = "exact", n_threads: int = 0):
    """Native multithreaded counterpart of ops.weights.ell_weights (full
    grid).  Returns (base (Hd,Wd,2) i32, w (Hd,Wd,K,K) f64, sums (Hd,Wd)).

    ``n_threads=0`` lets the engine use every hardware thread.
    """
    if mode not in ("exact", "fast"):
        raise ValueError(f"native weight-gen has modes exact/fast, got "
                         f"{mode!r}")
    lib = _build.load(_build.NATIVE)
    Hd, Wd = spec.dst_shape
    K = spec.window_cells
    qH, qW = spec.qrot_shape
    p00, ex, ey = spec.linear_map
    base = np.empty((Hd, Wd, 2), dtype=np.int32)
    w = np.empty((Hd, Wd, K, K), dtype=np.float64)
    sums = np.empty((Hd, Wd), dtype=np.float64)
    lib.aai_ell_weights(
        Hd, Wd, K, qH, qW,
        p00[0], p00[1], ex[0], ex[1], ey[0], ey[1],
        spec.dst_side, spec.cos, spec.sin, float(spec.scale),
        0 if mode == "exact" else 1,
        1,                                   # normalise the rows
        int(n_threads),
        base, w, sums,
    )
    return base, w, sums


def compat_cell_areas_native(qvx, qvy, mx0, my0, Km: int, modH: int,
                             modW: int, n_threads: int = 0) -> np.ndarray:
    """Native counterpart of the compat per-cell state machine
    (``ops.compat.compat_cell_state`` + ``compat_get_area``).

    qvx/qvy: (..., 4) reference-constructed dst quad corners; mx0/my0:
    (...,) clamped mod-window bases.  Returns areas (..., Km, Km), zero
    outside [0, modW-1] x [0, modH-1], equal to the numpy replica bit for
    bit (the build disables floating-point contraction).
    """
    lib = _build.load(_build.NATIVE)
    shape = np.asarray(mx0).shape
    n_pix = int(np.prod(shape)) if shape else 1
    qvx = np.ascontiguousarray(np.asarray(qvx, np.float64).reshape(n_pix, 4))
    qvy = np.ascontiguousarray(np.asarray(qvy, np.float64).reshape(n_pix, 4))
    mx0 = np.ascontiguousarray(np.asarray(mx0, np.int64).reshape(n_pix))
    my0 = np.ascontiguousarray(np.asarray(my0, np.int64).reshape(n_pix))
    areas = np.empty((n_pix, Km, Km), dtype=np.float64)
    lib.aai_compat_cell_areas(n_pix, int(Km), int(modH), int(modW), qvx, qvy,
                              mx0, my0, int(n_threads), areas)
    return areas.reshape(shape + (Km, Km))


def csv_read_native(path: str, cap_rows: int = 32768,
                    cap_cols: int = 4096) -> np.ndarray:
    """The reference's CSV reader (Source.cpp:1450-1495: invalid tokens
    skipped, blank lines skipped, short rows padded with 0) in C++; the
    call drops the GIL, so threaded readers overlap.  Reads into a
    ``cap_rows`` x ``cap_cols`` buffer and once more at the exact size
    where the file is larger.  Raises OSError where the file cannot be
    read."""
    lib = _build.load(_build.NATIVE)
    buf = np.zeros((cap_rows, cap_cols), dtype=np.float64)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.aai_csv_read(path.encode(), buf, buf.shape[0], buf.shape[1],
                          ctypes.byref(h), ctypes.byref(w))
    if rc == 1:     # the buffer was too small: h, w hold the file's size
        buf = np.zeros((h.value, w.value), dtype=np.float64)
        rc = lib.aai_csv_read(path.encode(), buf, h.value, w.value,
                              ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise OSError(f"aai_csv_read failed rc={rc} for {path}")
    return np.ascontiguousarray(buf[: h.value, : w.value])


def csv_write_native(path: str, data: np.ndarray, sig_digits: int = 0) -> None:
    """Write a 2-D array as CSV with ``%.{sig_digits}g`` (0: ``%.17g``),
    byte for byte what ``np.savetxt`` writes with that format."""
    lib = _build.load(_build.NATIVE)
    arr = np.ascontiguousarray(np.asarray(data, dtype=np.float64))
    rc = lib.aai_csv_write(path.encode(), arr, arr.shape[0], arr.shape[1],
                           int(sig_digits))
    if rc != 0:
        raise OSError(f"aai_csv_write failed rc={rc} for {path}")
