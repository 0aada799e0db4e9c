"""End-to-end demo of the PyTorch port's API (``aainterp_torch``), the
counterpart of examples/demo.py.

Run:  python examples/torch_demo.py                 (an NVIDIA GPU)
      python examples/torch_demo.py --device cpu    (plain PyTorch)

Covers the reference program's capabilities and what the port adds:
exact/fast/compat modes, rotation about an isocenter, batching, operator
reuse and its disk cache, quality against bilinear/bicubic, conservative
lat-lon regridding, composition, masking, streaming, variance,
volumetric resize, uint8 serving and the resize front door.  Every input
is made on ``--device`` and every call computes there.
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import aainterp_torch as at  # noqa: E402
from aainterp_torch.baselines import (  # noqa: E402
    compare_downscale, compare_rotation_roundtrip,
)
from aainterp_torch.regrid import (  # noqa: E402
    LatLonGrid, area_weighted_mean, conservative_regrid,
)
from aainterp_torch.utils.cache import build_operator_cached  # noqa: E402


def device_of(name: str) -> torch.device:
    """The torch device ``--device`` names; exits plainly where CUDA is
    asked for and absent."""
    if name == "cuda" and not torch.cuda.is_available():
        sys.exit("--device cuda: torch.cuda.is_available() is False; pass "
                 "--device cpu to run on the CPU")
    return torch.device(name)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--cache-dir", default=None,
                    help="the operator disk cache (default: a temporary "
                         "directory, removed at the end)")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, device=dev)
    film = t(rng.uniform(0.0, 2.0, (256, 256)).astype(np.float32))

    # 1. The reference's shipped configuration: 150 dpi film scan to 25.4
    #    dpi (1 px/mm), rotated 1.5 degrees about the isocenter.
    result = at.area_average_interpolate(
        film, 150.0, 25.4, src_isocenter=(128.0, 128.0), rotation_angle=1.5,
        mode="fast")    # the reference's default mode 2
    print(f"film {tuple(film.shape)} -> {tuple(result.dst.shape)}, "
          f"dst isocenter {result.dst_isocenter}")

    # 2. Exact mode (true overlap areas) and reference-compat mode
    #    (bug-for-bug with the C++ exact mode under rotation):
    exact = at.area_average_interpolate(film, 150.0, 25.4, (128, 128), 1.5)
    compat = at.area_average_interpolate(film, 150.0, 25.4, (128, 128), 1.5,
                                         mode="compat")
    diff = float((exact.dst - compat.dst).abs().max())
    print(f"exact vs reference-compat max diff: {diff:.2e} "
          "(the reference's type-2 area defect)")

    # 3. Batched frames (leading dims) with a cached operator:
    with tempfile.TemporaryDirectory() as tmp:
        spec = at.make_grid_spec((256, 256), 2.0, 1.0, (128, 128), 0.0)
        op = build_operator_cached(spec, cache_dir=args.cache_dir or tmp)
        frames = t(rng.uniform(0, 1, (8, 256, 256)).astype(np.float32))
        batch_out = at.apply_operator(op, frames)
        print(f"batched apply: {tuple(frames.shape)} -> "
              f"{tuple(batch_out.shape)} (operator cached on disk)")

    # 4. Information preservation vs bilinear/bicubic:
    y, x = np.mgrid[0:96, 0:96].astype(np.float32)
    img = (np.sin(x * 1.3) * np.cos(y * 0.7) + 1.0) / 2.0
    flux = compare_downscale(t(img), 2.0, 1.0, src_isocenter=(0.5, 0.5))
    print("mean-flux error  :",
          {k: f"{v['mean_flux_error']:.2e}" for k, v in flux.items()})
    rt = compare_rotation_roundtrip(img.astype(np.float64), 30.0, device=dev)
    print("rotate +/-30 PSNR:", {k: f"{v:.1f} dB" for k, v in rt.items()})

    # 5. Conservative lat-lon regrid (spherical cell areas):
    src_g, dst_g = LatLonGrid(180, 360), LatLonGrid(45, 90)
    field = t(rng.uniform(250.0, 300.0, (180, 360)).astype(np.float32))
    coarse = conservative_regrid(field, src_g, dst_g)
    print(f"regrid 1deg -> 4deg: global mean "
          f"{float(area_weighted_mean(field, src_g)):.4f} -> "
          f"{float(area_weighted_mean(coarse, dst_g)):.4f} (conserved)")

    # 6. Operator composition: chained stages fused into ONE exact
    #    operator, one pass over the pixels.
    op1 = at.build_operator(at.make_grid_spec((256, 256), 4.0, 2.0,
                                              (0.0, 0.0), 0.0))
    op2 = at.build_operator(at.make_grid_spec((128, 128), 150.0, 60.0,
                                              (0.0, 0.0), 0.0))
    fused = at.compose_separable(op2, op1)
    two = at.apply_operator(op2, at.apply_operator(op1, frames))
    one = at.apply_operator(fused, frames)
    print(f"fused 2-stage pipeline {tuple(frames.shape)} -> "
          f"{tuple(one.shape)}, max diff vs chained "
          f"{float((one - two).abs().max()):.2e}")

    # 7. Conservative resize to any (even anisotropic) shape:
    wide = at.area_resize(frames, (100, 180))
    print(f"area_resize {tuple(frames.shape)} -> {tuple(wide.shape)}: mean "
          f"{float(frames.mean()):.6f} -> {float(wide.mean()):.6f} "
          "(flux conserved)")

    # 8. Masked conservative regrid: dst cells average valid source cells
    #    only; values under the mask never leak into the output.
    ocean = t(rng.uniform(0, 1, (180, 360)) > 0.3)
    sst = conservative_regrid(field, src_g, dst_g, src_mask=ocean)
    print(f"masked regrid: {int((~ocean).sum())} land cells ignored, "
          f"{int(sst.isnan().sum())} dst cells fully masked")

    # 9. Streaming executor: host -> device -> host with depth-k batches
    #    in flight.
    op = at.build_operator(at.make_grid_spec((256, 256), 4.0, 2.0,
                                             (0.0, 0.0), 0.0))
    outs = list(at.stream_apply(
        op, (rng.uniform(0, 1, (256, 256)).astype(np.float32)
             for _ in range(10)), batch=4, depth=2, device=dev))
    print(f"stream_apply: 10 frames -> {len(outs)} outputs of shape "
          f"{tuple(outs[0].shape)} (pipelined)")

    # 10. Uncertainty propagation: the squared-weight operator gives the
    #     exact output variance for independent input noise.
    sigma2 = t(rng.uniform(0.5, 1.5, (256, 256)).astype(np.float32))
    var_out = at.propagate_variance(op, sigma2)
    print(f"propagate_variance: {tuple(sigma2.shape)} -> "
          f"{tuple(var_out.shape)}, max var ratio "
          f"{float(var_out.max() / sigma2.max()):.3f} (averaging never "
          "amplifies noise)")

    # 11. Volumetric: conservative N-D resize, with a validity mask; and a
    #     flux-conserving pyramid.
    ct = t(rng.uniform(0, 1, (40, 96, 96)).astype(np.float32))
    small = at.area_resize_nd(ct, (10, 48, 48))
    print(f"area_resize_nd {tuple(ct.shape)} -> {tuple(small.shape)}: mean "
          f"{float(ct.mean()):.6f} -> {float(small.mean()):.6f}")
    body = torch.ones_like(ct)
    body[:, :10, :] = 0.0     # couch rows excluded from the average
    masked = at.area_resize_nd(ct, (10, 48, 48), mask=body)
    print(f"masked volumetric resize: {int(masked.isnan().sum())} "
          "fully-outside cells")
    levels = at.area_pyramid(frames, 4)
    print("area_pyramid levels:", [tuple(lv.shape[-2:]) for lv in levels],
          f"means all {float(levels[-1].mean()):.6f}")

    # 12. uint8 serving: u8 frames stream u8 in -> u8 out end to end.
    u8_frames = (rng.integers(0, 256, (256, 256), dtype=np.uint8)
                 for _ in range(6))
    u8_out = list(at.stream_apply(op, u8_frames, batch=2, depth=2,
                                  device=dev))
    print(f"u8 serving: 6 u8 frames -> {len(u8_out)} outputs, dtype "
          f"{u8_out[0].dtype}, shape {tuple(u8_out[0].shape)}")

    # 13. One resize front door, the method switchable per call:
    area = at.resize(frames[0], (128, 96))
    cubic = at.resize(frames[0], (128, 96), method="bicubic")
    print(f"resize(method=): area mean {float(area.mean()):.6f} "
          f"(== source {float(frames[0].mean()):.6f}), bicubic mean "
          f"{float(cubic.mean()):.6f} (not conservative)")


if __name__ == "__main__":
    main()
