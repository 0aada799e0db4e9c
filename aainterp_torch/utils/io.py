"""CSV image I/O and path handling (reference L4 layer, Source.cpp:1437-1515).

Counterpart of ``aainterp/utils/io.py``, carried over (it has no JAX in
it); the native dispatch goes to this package's own engine
(``aainterp_torch.native``).  Semantics replicated:

  * csvRead (Source.cpp:1471-1492): rows of comma-separated doubles,
    non-numeric tokens silently skipped (Source.cpp:1457-1459), blank lines
    skipped.  The reference's ragged-row handling is buggy (it indexes
    vec[i] up to the running max width, Source.cpp:1484-1488, reading out of
    range for short rows) — short rows are padded with 0.0 instead
    (SURVEY.md §7 hard part 5: a bug to NOT replicate).
  * csvWrite (Source.cpp:1493-1515): the reference writes with default
    C++ stream precision (6 significant digits); the default here is full
    precision, with ``sig_digits=6`` for bit-compatible diffs.
  * split_path (Source.cpp:1437-1448): path -> (dir, base, extension), with
    both '/' and '\\' delimiters.

Pillow is imported only by the raster functions, at their call.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def split_path(full_path: str) -> Tuple[str, str, str]:
    """path -> (directory-with-trailing-sep, base, extension-with-dot)."""
    dot = full_path.rfind(".")
    delim = full_path.rfind("\\")
    if delim == -1:
        delim = full_path.rfind("/")
    delim += 1
    ext = "" if dot == -1 else full_path[dot:]
    end = dot if dot != -1 else len(full_path)
    base = full_path[delim:end]
    path = full_path[:delim]
    return path, base, ext


def csv_read(path: str) -> np.ndarray:
    """Read a CSV image; invalid tokens skipped, rows padded to max width.

    Dispatches to the buffered native C++ decoder when it builds (same
    token-skip/pad semantics; the call drops the GIL, so threaded loaders
    overlap device work), else to the Python reader ``_csv_read_py``
    (Source.cpp:1450-1495 semantics).  A missing file raises the Python
    ``open()`` error (the CLI prints its message); an empty one raises
    ValueError("There is no data in src array.")."""
    from .. import native

    if native.available():
        try:
            out = native.csv_read_native(path)
        except OSError:
            if os.path.exists(path):
                raise  # a real decode failure on an existing file
        else:
            if out.size == 0:
                raise ValueError("There is no data in src array.")
            return out
    return _csv_read_py(path)


def _csv_read_py(path: str) -> np.ndarray:
    rows = []
    width = 0
    with open(path, "r") as f:
        for line in f:
            vals = []
            for tok in line.strip().split(","):
                try:
                    vals.append(float(tok))
                except ValueError:
                    continue  # Source.cpp:1457-1459: silently skip
            if not vals:
                continue
            width = max(width, len(vals))
            rows.append(vals)
    if not rows:
        raise ValueError("There is no data in src array.")
    out = np.zeros((len(rows), width), dtype=np.float64)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def csv_write(path: str, data, sig_digits: int = 0) -> None:
    """Write a 2-D image as CSV.

    sig_digits=6 reproduces the reference's default stream precision
    (Source.cpp:1508); 0 means full float64 repr (``%.17g``).  ``data`` is
    a numpy array or a tensor (copied to the host).  Dispatches to the
    native C++ writer when it builds: byte-identical to ``np.savetxt``
    with the same format, and GIL-free so pooled writers overlap device
    work.
    """
    if hasattr(data, "detach"):           # a torch.Tensor on any device
        data = data.detach().cpu().double().numpy()
    arr = np.asarray(data, dtype=np.float64)
    if arr.ndim != 2 or arr.size == 0:
        raise ValueError("There is no data in src array.")
    from .. import native

    if native.available():
        native.csv_write_native(path, arr, sig_digits=sig_digits)
        return
    fmt = f"%.{sig_digits}g" if sig_digits > 0 else "%.17g"
    np.savetxt(path, arr, delimiter=",", fmt=fmt)


def image_read(path: str, as_gray: bool = False) -> np.ndarray:
    """Read a raster image (PNG/JPEG/TIFF/...) as float64 in [0, 1].

    Returns (H, W) for single-channel or as_gray, else (H, W, C).  The CSV
    path remains the reference-parity surface; this is the general loader
    for the library API.  Needs Pillow (ImportError without it)."""
    from PIL import Image

    img = Image.open(path)
    if as_gray:
        img = img.convert("F")
        return np.asarray(img, dtype=np.float64) / 255.0
    arr = np.asarray(img, dtype=np.float64)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    return arr / 255.0


def image_write(path: str, data) -> None:
    """Write a float image in [0, 1] as an 8-bit raster file (Pillow)."""
    from PIL import Image

    if hasattr(data, "detach"):
        data = data.detach().cpu().double().numpy()
    arr = np.asarray(data, dtype=np.float64)
    arr = np.clip(arr, 0.0, 1.0)
    Image.fromarray((arr * 255.0 + 0.5).astype(np.uint8)).save(path)


def default_output_path(input_path: str) -> str:
    """`<dir>/<base>_mod<ext>` — the reference's output naming
    (Source.cpp:1591)."""
    path, base, ext = split_path(input_path)
    return f"{path}{base}_mod{ext}"
