"""ctypes binding of the native C++ ELL weight-gen engine.

Counterpart of ``ell_weights_native`` in ``aainterp/native.py``.  The
library is the repository's own ``native/aainterp_native.cpp``, built
unchanged by ``_build`` with g++ and the flags of ``native/Makefile``
into ``aainterp_torch/_build/`` at first use (a temporary file renamed
into place, so parallel processes never load a half-written library).
The engine is a host-side accelerator — multithreaded weight-gen, about
10-50x the vectorised numpy path on large grids — and not a correctness
dependency: ``ops.weights.ell_operator`` falls back to numpy with a
RuntimeWarning when it cannot be built or loaded.
"""

from __future__ import annotations

import numpy as np

from . import _build


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
