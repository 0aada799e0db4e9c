"""Command-line interface (reference L5 layer, Source.cpp:1434-1599).

Counterpart of ``aainterp/cli.py``.  The reference has no argv parsing —
users edit source constants (Source.cpp:1528-1534, README.md:18-19) and
recompile.  This CLI exposes exactly those knobs as flags, with the same
defaults, the same .csv-only gate (Source.cpp:1537-1544), the same
``<base>_mod.csv`` output naming (Source.cpp:1591) and the same
"Calculation time : X [ms]" timing line (Source.cpp:1581), plus the
multi-input stream and the ``resize`` / ``rotate`` / ``regrid``
subcommands; stdout is the JAX package's, byte for byte, apart from the
timing numbers.

``--device {cuda,cpu}`` (default ``cuda``) picks where the command
computes, as ``JAX_PLATFORMS`` does for the JAX package.  With no CUDA
device and no ``--device cpu`` the command prints the device error and
"Run terminated abnormally." and exits 255: it never computes on the CPU
unasked.  The timing line waits for the card's work first.  Pixels are
computed in float32, as the JAX package does without x64.

Usage:
    python -m aainterp_torch input.csv --src-resolution 150 \\
        --dst-resolution 25.4 --isocenter 455 455 --angle 1.5 --mode 2
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from . import api
from .grids import ValidationError
from .utils import io as iom
from .utils import log
from .utils.device import target

DEVICES = ("cuda", "cpu")


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=DEVICES, default="cuda",
                   help="where to compute (default cuda: the GPU; the "
                        "command stops where there is none)")


def _device_or_fail(name: str):
    """The torch device of ``--device``, or None after printing the
    device error and the reference's abnormal-end line."""
    try:
        return target(name)
    except RuntimeError as e:
        print(str(e))
        print("Run terminated abnormally.")
        return None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="aainterp_torch",
        description="area-average (conservative) image resampling on the "
                    "GPU (PyTorch + CUDA)",
    )
    p.add_argument("input", nargs="+",
                   help="source image path(s) (*.csv only).  With several "
                        "paths the files stream through ONE pipelined "
                        "operator (pipeline.stream_apply_files): threaded "
                        "reads/writes overlapped with device compute; all "
                        "files must share the first file's shape")
    p.add_argument("--src-resolution", type=float, default=150.0,
                   help="source resolution [pixel/mm or dpi] (x == y)")
    p.add_argument("--dst-resolution", type=float, default=25.4,
                   help="destination resolution [pixel/mm or dpi] (x == y)")
    p.add_argument("--isocenter", type=float, nargs=2, default=[455.0, 455.0],
                   metavar=("X", "Y"), help="rotation center [pixels]")
    p.add_argument("--angle", type=float, default=1.5,
                   help="rotation angle [degrees], clockwise positive")
    p.add_argument("--mode", type=int, choices=(1, 2), default=2,
                   help="1: exact area average, 2: fast area average")
    p.add_argument("--compat", action="store_true",
                   help="with --mode 1: reproduce the C++ reference's exact "
                        "mode bug-for-bug under rotation (see PARITY.md)")
    p.add_argument("--output", default=None,
                   help="output path (default: <base>_mod.csv)")
    p.add_argument("--sig-digits", type=int, default=6,
                   help="CSV output significant digits (default 6 = the "
                        "reference's stream precision, Source.cpp:1508; "
                        "0 = full %%.17g)")
    p.add_argument("--no-banner", action="store_true",
                   help="suppress the reference's parameter banner")
    p.add_argument("--cache-dir", default=None, metavar="DIR",
                   help="persist/reuse the geometry-keyed operator on disk "
                        "(repeat runs skip weight-gen; see utils/cache.py)")
    p.add_argument("--verbose", action="store_true",
                   help="also print dstIsocenter (extra over the reference's "
                        "stdout)")
    p.add_argument("--batch", type=int, default=8,
                   help="frames per device batch when streaming several "
                        "inputs (multi-input only)")
    p.add_argument("--depth", type=int, default=2,
                   help="device batches kept in flight when streaming "
                        "several inputs (multi-input only)")
    _add_device(p)
    return p


def _read_csv_or_fail(path):
    """Shared csv gate + read with the reference's error strings."""
    _, _, ext = iom.split_path(path)
    if ext not in (".csv", ".CSV"):
        print("As for the image format, only csv format can be used.")
        print("Run terminated abnormally.")
        return None
    try:
        return iom.csv_read(path)
    except (OSError, ValueError) as e:
        print(f"Failed to read csv file. ({e})")
        print("Run terminated abnormally.")
        return None


# raster formats accepted by the resize/rotate subcommands (the legacy
# reference-parity command keeps the csv-only gate, Source.cpp:1537-1544).
# uint8 pixels ride the u8 serving path end to end where the route
# supports it.
_RASTER_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def _is_raster(path) -> bool:
    return iom.split_path(path)[2].lower() in _RASTER_EXTS


def _read_any_or_fail(path):
    """CSV (float64) or raster (uint8, channels-first for C > 1).  Without
    Pillow a raster prints a message and fails (the JAX package lets the
    ImportError escape)."""
    if not _is_raster(path):
        return _read_csv_or_fail(path)
    try:
        from PIL import Image

        arr = np.asarray(Image.open(path))
    except (OSError, ValueError, ImportError) as e:
        print(f"Failed to read image file. ({e})")
        print("Run terminated abnormally.")
        return None
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    if arr.ndim == 3:
        arr = np.moveaxis(arr, -1, 0)        # (C, H, W) for the applies
    return arr


def _on(arr: np.ndarray, device) -> torch.Tensor:
    """A host image as a tensor on ``device``: float64 (CSV) becomes
    float32, the JAX package's working type without x64; uint8 stays."""
    if arr.dtype != np.uint8:
        arr = arr.astype(np.float32)
    elif not arr.flags.writeable:          # a decoded raster's buffer
        arr = arr.copy()
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _host(dst) -> np.ndarray:
    """The result on the host, after the device's work has finished."""
    if isinstance(dst, torch.Tensor):
        return dst.detach().cpu().numpy()
    return np.asarray(dst)


def _finish(dst, input_path, output, sig_digits, start) -> int:
    log.synchronize()
    elapsed_ms = (time.perf_counter() - start) * 1000.0
    print(f"Calculation time : {elapsed_ms:g} [ms]")
    out_path = output or iom.default_output_path(input_path)
    dst = _host(dst)
    if _is_raster(out_path):
        try:
            from PIL import Image
        except ImportError as e:
            print(f"Failed to write image file. ({e})")
            print("Run terminated abnormally.")
            return -1
        if dst.dtype != np.uint8:
            dst = np.clip(np.round(dst.astype(np.float64)), 0,
                          255).astype(np.uint8)
        if dst.ndim == 3:
            dst = np.moveaxis(dst, 0, -1)    # back to (H, W, C)
        Image.fromarray(dst).save(out_path)
    else:
        if dst.dtype == np.uint8:
            dst = dst.astype(np.float64)
        if dst.ndim == 3:
            print("csv output is single-channel; writing channel 0 "
                  "(use a raster --output for color).")
            dst = dst[0]
        iom.csv_write(out_path, dst, sig_digits=sig_digits)
    print("Run terminated correctly.")
    return 0


def _cmd_resize(argv) -> int:
    """`aainterp_torch resize in.csv --shape H W`: conservative resize to
    ANY target shape (anisotropic ratios allowed — the reference program
    rejects them, Source.cpp:111-117), or the bilinear/bicubic baselines
    via --method."""
    p = argparse.ArgumentParser(
        prog="aainterp_torch resize",
        description="conservative (area-average) resize to any shape")
    p.add_argument("input",
                   help="source image (*.csv or PNG/JPEG/TIFF/BMP; "
                        "uint8 rasters ride the u8 serving path)")
    p.add_argument("--shape", type=int, nargs=2, required=True,
                   metavar=("H", "W"), help="destination shape [pixels]")
    p.add_argument("--method", choices=("area", "bilinear", "bicubic"),
                   default="area",
                   help="area = exact flux-conserving overlap weights "
                        "(default); bilinear/bicubic = the "
                        "F.interpolate baselines")
    p.add_argument("--mask", default=None, metavar="MASK_CSV",
                   help="validity mask csv (nonzero = valid): valid-cell-"
                        "renormalised mean, area method only")
    p.add_argument("--fill", type=float, default=float("nan"),
                   help="fill value for uncovered masked pixels")
    p.add_argument("--output", default=None,
                   help="output path (default: <base>_mod.csv)")
    p.add_argument("--sig-digits", type=int, default=6)
    _add_device(p)
    args = p.parse_args(argv)

    device = _device_or_fail(args.device)
    if device is None:
        return -1
    src = _read_any_or_fail(args.input)
    if src is None:
        return -1
    if src.dtype == np.uint8 and args.method != "area":
        src = src.astype(np.float32)  # the baselines are float
    kw = {}
    if args.mask is not None:
        if args.method != "area":
            print("--mask is area-method only.")
            print("Run terminated abnormally.")
            return -1
        mask = _read_csv_or_fail(args.mask)
        if mask is None:
            return -1
        kw = dict(mask=torch.from_numpy(mask).to(device),
                  fill_value=args.fill)
    start = time.perf_counter()
    try:
        dst = api.resize(_on(src, device), tuple(args.shape),
                         method=args.method, **kw)
    except (ValidationError, ValueError) as e:
        print(str(e))
        print("Run terminated abnormally.")
        return -1
    return _finish(dst, args.input, args.output, args.sig_digits, start)


def _cmd_rotate(argv) -> int:
    """`aainterp_torch rotate in.csv --angle DEG`: flux-conserving
    rotation about the isocenter (default: image center) at equal
    resolutions.  ``--mode shear`` is not offered: the JAX package's
    command lacks it too."""
    p = argparse.ArgumentParser(
        prog="aainterp_torch rotate",
        description="flux-conserving (area-average) rotation")
    p.add_argument("input",
                   help="source image (*.csv or PNG/JPEG/TIFF/BMP; "
                        "uint8 rasters ride the u8 serving path)")
    p.add_argument("--angle", type=float, required=True,
                   help="rotation angle [degrees], clockwise positive")
    p.add_argument("--isocenter", type=float, nargs=2, default=None,
                   metavar=("X", "Y"),
                   help="rotation center [pixels] (default: image center)")
    p.add_argument("--mode", choices=("exact", "fast", "compat"),
                   default="exact")
    p.add_argument("--output", default=None,
                   help="output path (default: <base>_mod.csv)")
    p.add_argument("--sig-digits", type=int, default=6)
    _add_device(p)
    args = p.parse_args(argv)

    device = _device_or_fail(args.device)
    if device is None:
        return -1
    src = _read_any_or_fail(args.input)
    if src is None:
        return -1
    start = time.perf_counter()
    try:
        iso = tuple(args.isocenter) if args.isocenter else None
        dst = api.area_rotate(_on(src, device), args.angle, isocenter=iso,
                              mode=args.mode)
    except (ValidationError, ValueError) as e:
        print(str(e))
        print("Run terminated abnormally.")
        return -1
    return _finish(dst, args.input, args.output, args.sig_digits, start)


def _cmd_regrid(argv) -> int:
    """`aainterp_torch regrid in.csv --dst-grid NLAT NLON`: conservative
    lat-lon regrid with spherical cell areas (sin-lat overlap weights).
    The source grid defaults to the field's shape."""
    p = argparse.ArgumentParser(
        prog="aainterp_torch regrid",
        description="conservative lat-lon regrid (spherical areas)")
    p.add_argument("input", help="source field (*.csv), (n_lat, n_lon)")
    p.add_argument("--dst-grid", type=int, nargs=2, required=True,
                   metavar=("NLAT", "NLON"), help="destination grid")
    p.add_argument("--src-grid", type=int, nargs=2, default=None,
                   metavar=("NLAT", "NLON"),
                   help="source grid (default: the field's shape)")
    p.add_argument("--mask", default=None, metavar="MASK_CSV",
                   help="validity mask csv (nonzero = valid), e.g. an "
                        "ocean mask: valid-cell-renormalised mean")
    p.add_argument("--fill", type=float, default=float("nan"))
    p.add_argument("--conserve-check", action="store_true",
                   help="also print the global flux pair (area-weighted "
                        "means must match)")
    p.add_argument("--output", default=None,
                   help="output path (default: <base>_mod.csv)")
    p.add_argument("--sig-digits", type=int, default=6)
    _add_device(p)
    args = p.parse_args(argv)

    from .regrid import LatLonGrid, conservative_regrid

    device = _device_or_fail(args.device)
    if device is None:
        return -1
    field = _read_csv_or_fail(args.input)
    if field is None:
        return -1
    src_grid = (LatLonGrid(*args.src_grid) if args.src_grid
                else LatLonGrid(field.shape[-2], field.shape[-1]))
    if (field.shape[-2], field.shape[-1]) != (src_grid.n_lat,
                                              src_grid.n_lon):
        print(f"field shape {field.shape[-2:]} does not match --src-grid "
              f"({src_grid.n_lat}, {src_grid.n_lon}).")
        print("Run terminated abnormally.")
        return -1
    dst_grid = LatLonGrid(*args.dst_grid)
    kw = {}
    if args.mask is not None:
        mask = _read_csv_or_fail(args.mask)
        if mask is None:
            return -1
        kw = dict(src_mask=torch.from_numpy(mask).to(device),
                  fill_value=args.fill)
    start = time.perf_counter()
    try:
        dst = conservative_regrid(_on(field, device), src_grid, dst_grid,
                                  **kw)
    except (ValidationError, ValueError) as e:
        print(str(e))
        print("Run terminated abnormally.")
        return -1
    if args.conserve_check:
        # the conserved quantity on a lat-lon grid is the SPHERICAL
        # area-weighted mean (cell area ~ d(sin lat) * d lon), not the
        # plain pixel mean
        def sph_mean(arr, grid):
            w_lat = -np.diff(np.sin(np.radians(grid.lat_edges)))
            a = np.asarray(arr, np.float64)
            return float((a * w_lat[:, None]).sum() / (w_lat.sum()
                                                       * grid.n_lon))

        ms = sph_mean(field, src_grid)
        md = sph_mean(np.nan_to_num(_host(dst)), dst_grid)
        err = abs(md - ms) / max(abs(ms), 1e-12)
        print(f"Flux check : src mean {ms:.9g}, dst mean {md:.9g}, "
              f"relative error {err:.3e}")
    return _finish(dst, args.input, args.output, args.sig_digits, start)


_SUBCOMMANDS = {
    "resize": _cmd_resize,
    "rotate": _cmd_rotate,
    "regrid": _cmd_regrid,
}


def _fn_name(mode: int) -> str:
    # the reference prints its banner from inside each driver
    # (Source.cpp:59-75 exact, 588-604 fast)
    return ("AreaAverageInterpolation::areaAverageInterpolation"
            if mode == 1 else
            "AreaAverageInterpolation::fastAreaAverageInterpolation")


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    # subcommand front doors for the beyond-reference capabilities; the
    # bare legacy invocation keeps stdout byte-parity with the reference
    if argv and argv[0] in _SUBCOMMANDS:
        return _SUBCOMMANDS[argv[0]](list(argv[1:]))
    args = build_parser().parse_args(argv)

    device = _device_or_fail(args.device)
    if device is None:
        return -1
    for path in args.input:
        _, _, ext = iom.split_path(path)
        if ext not in (".csv", ".CSV"):
            print("As for the image format, only csv format can be used.")
            print("Run terminated abnormally.")
            return -1

    multi = len(args.input) > 1
    try:
        # multi-input: the stream re-reads every file with the (native,
        # GIL-free) default reader — probe only file 0 here, same reader
        if multi:
            from .pipeline import _default_reader

            src = _default_reader(args.input[0])
        else:
            src = iom.csv_read(args.input[0])
    except (OSError, ValueError) as e:
        print(f"Failed to read csv file. ({e})")
        print("Run terminated abnormally.")
        return -1

    mode = "exact" if args.mode == 1 else "fast"
    if args.compat and args.mode == 1:
        mode = "compat"
    if multi:
        return _main_stream(args, src, mode, device)
    if not args.no_banner:
        print(log.banner(_fn_name(args.mode), args.src_resolution,
                         args.dst_resolution, tuple(args.isocenter),
                         args.angle))
    start = time.perf_counter()
    try:
        operator = None
        if args.cache_dir:
            from .grids import make_grid_spec
            from .utils.cache import build_operator_cached

            spec = make_grid_spec(
                (src.shape[-2], src.shape[-1]), args.src_resolution,
                args.dst_resolution, tuple(args.isocenter), args.angle,
            )
            operator = build_operator_cached(
                spec, mode=mode, cache_dir=args.cache_dir
            )
        result = api.area_average_interpolate(
            _on(src, device), args.src_resolution, args.dst_resolution,
            tuple(args.isocenter), args.angle, mode=mode,
            operator=operator,
        )
        dst = _host(result.dst)
    except ValidationError as e:
        print(str(e))
        print("Run terminated abnormally.")
        return -1
    elapsed_ms = (time.perf_counter() - start) * 1000.0
    print(f"Calculation time : {elapsed_ms:g} [ms]")
    if args.verbose:
        # extra over the reference (it returns dstIsocenter via an out-param
        # and never prints it, Source.cpp:181-186)
        print(f"dstIsocenter : {result.dst_isocenter[0]}, "
              f"{result.dst_isocenter[1]}")

    out_path = args.output or iom.default_output_path(args.input[0])
    iom.csv_write(out_path, dst, sig_digits=args.sig_digits)
    print("Run terminated correctly.")
    return 0


def _main_stream(args, src0: np.ndarray, mode: str, device) -> int:
    """Multi-input path: one operator, pipelined file serving
    (pipeline.stream_apply_files).  New capability over the reference —
    its main() handles exactly one hard-coded file per run
    (Source.cpp:1528-1534) — so stdout here is not parity-constrained
    beyond the shared banner."""
    from .grids import make_grid_spec
    from .pipeline import stream_apply_files

    if args.output:
        print("--output is single-input only; streamed outputs use "
              "<base>_mod.csv naming.")
        print("Run terminated abnormally.")
        return -1
    if not args.no_banner:
        print(log.banner(_fn_name(args.mode), args.src_resolution,
                         args.dst_resolution, tuple(args.isocenter),
                         args.angle))
    start = time.perf_counter()
    try:
        spec = make_grid_spec(
            (src0.shape[-2], src0.shape[-1]), args.src_resolution,
            args.dst_resolution, tuple(args.isocenter), args.angle,
        )
        if args.cache_dir:
            from .utils.cache import build_operator_cached

            op = build_operator_cached(spec, mode=mode,
                                       cache_dir=args.cache_dir)
        else:
            op = api.build_operator(spec, mode=mode)
        outs = stream_apply_files(op, args.input, batch=args.batch,
                                  depth=args.depth,
                                  sig_digits=args.sig_digits, device=device)
    except (ValidationError, ValueError, OSError) as e:
        print(str(e))
        print("Run terminated abnormally.")
        return -1
    elapsed_ms = (time.perf_counter() - start) * 1000.0
    print(f"Calculation time : {elapsed_ms:g} [ms]")
    print(f"Streamed {len(outs)} files "
          f"({elapsed_ms / len(outs):.3g} ms/file).")
    print("Run terminated correctly.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
