"""Host planning of the PyTorch port against the JAX package, bit for bit.

Geometry, weight-gen, band transposes/flips, the quadrant fold, the
operator sanitizer, the numpy carry-over (convert.py), the caches, and
that importing the port pulls in neither jax nor aainterp.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import aainterp as aa
from aainterp import autodiff as j_autodiff
from aainterp.ops import overlap1d as j_overlap1d
from aainterp.ops import weights as j_weights

import aainterp_torch as at
from aainterp_torch import autodiff as t_autodiff
from aainterp_torch import convert
from aainterp_torch.ops import overlap1d as t_overlap1d
from aainterp_torch.ops import weights as t_weights
from aainterp_torch.utils.digest import array_digest
from aainterp_torch.utils.lru import LruDict, value_nbytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the four geometries of tests/test_pallas.py:25-30
GEOMS = [
    (256, 512, 2.0, 1.0),          # integer 2x downscale
    (512, 768, 150.0, 60.0),       # non-integer ratio
    (384, 640, 4.0, 1.0),          # 4x downscale (wider band)
    (128, 256, 1.0, 2.0),          # 2x upscale
]
ANGLES = [0.0, 90.0, 180.0, 270.0]


def _bands_equal(a, b):
    assert a.n_src == b.n_src and a.n_dst == b.n_dst
    assert a.start.dtype == b.start.dtype
    assert np.array_equal(a.start, b.start)
    assert a.weights.dtype == b.weights.dtype
    assert np.array_equal(a.weights, b.weights)


def _ops(H, W, sr, dr, angle, mode="exact", iso=(0.0, 0.0)):
    js = aa.make_grid_spec((H, W), sr, dr, iso, angle)
    ts = at.make_grid_spec((H, W), sr, dr, iso, angle)
    return (j_weights.separable_operator(js, mode=mode),
            t_weights.separable_operator(ts, mode=mode))


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("angle", ANGLES)
@pytest.mark.parametrize("H,W,sr,dr", GEOMS)
def test_separable_operator_bit_equal(H, W, sr, dr, angle, mode):
    jop, top = _ops(H, W, sr, dr, angle, mode)
    assert dataclasses.asdict(jop.spec) == dataclasses.asdict(top.spec)
    _bands_equal(jop.wy, top.wy)
    _bands_equal(jop.wx, top.wx)
    for a, b in zip(jop.raw_row_sums, top.raw_row_sums):
        assert np.array_equal(a, b)
    assert jop.mode == top.mode


@pytest.mark.parametrize("angle", ANGLES)
@pytest.mark.parametrize("H,W,sr,dr", GEOMS)
def test_fold_and_transposes_bit_equal(H, W, sr, dr, angle):
    jop, top = _ops(H, W, sr, dr, angle)
    jy, jx, jt = j_weights.fold_quadrant_separable(jop)
    ty, tx, tt = t_weights.fold_quadrant_separable(top)
    assert jt == tt
    _bands_equal(jy, ty)
    _bands_equal(jx, tx)
    jtab = j_autodiff.folded_separable_tables(jop)
    ttab = t_autodiff.folded_separable_tables(top)
    for a, b in zip(jtab[:4], ttab[:4]):
        _bands_equal(a, b)
    assert jtab[4] == ttab[4]


@pytest.mark.parametrize("fn", ["transpose_band", "flip_band",
                                "reverse_rows_band"])
@pytest.mark.parametrize("H,W,sr,dr", GEOMS)
def test_band_transforms_bit_equal(H, W, sr, dr, fn):
    jop, top = _ops(H, W, sr, dr, 0.0)
    for jb, tb in ((jop.wy, top.wy), (jop.wx, top.wx)):
        _bands_equal(getattr(j_overlap1d, fn)(jb),
                     getattr(t_overlap1d, fn)(tb))
    # and the transform is what it says on dense matrices
    d = top.wx.dense()
    got = getattr(t_overlap1d, fn)(top.wx).dense()
    want = {"transpose_band": d.T, "flip_band": d[:, ::-1],
            "reverse_rows_band": d[::-1]}[fn]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gen", ["overlap_band_1d", "count_band_1d"])
@pytest.mark.parametrize("n_dst,n_src,side,scale,iso", [
    (17, 40, 2.3, 1, 0.25),
    (9, 5, 0.7, 2, 0.6),      # band wider than the source: clamped starts
    (30, 64, 3.0, 3, 0.0),
])
def test_band_generators_bit_equal(gen, n_dst, n_src, side, scale, iso):
    _bands_equal(getattr(j_overlap1d, gen)(n_dst, n_src, side, scale, iso),
                 getattr(t_overlap1d, gen)(n_dst, n_src, side, scale, iso))


@pytest.mark.parametrize("args", [
    ((4, 4), (1.0, 2.0), (1.0, 1.0)),
    ((4, 4), (0.0, 0.0), (1.0, 1.0)),
    ((0, 4), (1.0, 1.0), (1.0, 1.0)),
    ((4, 0), (1.0, 1.0), (1.0, 1.0)),
])
def test_validate_args_same_messages(args):
    with pytest.raises(aa.ValidationError) as je:
        aa.grids.validate_args(*args)
    with pytest.raises(at.ValidationError) as te:
        at.validate_args(*args)
    assert str(je.value) == str(te.value)


@pytest.mark.parametrize("mode", ["exact", "fast", "compat"])
def test_validate_operator_parity_and_rejection(mode):
    jop, top = _ops(512, 768, 150.0, 60.0, 0.0, mode)
    assert j_weights.validate_operator(jop) == t_weights.validate_operator(top)
    bad_w = top.wx.weights.copy()
    bad_w[3, 0] += 0.5
    bad = dataclasses.replace(top, wx=dataclasses.replace(top.wx,
                                                          weights=bad_w))
    with pytest.raises(at.OperatorValidationError, match="not normalised"):
        t_weights.validate_operator(bad)


def test_convert_operator_from_jax_tables():
    jop, top = _ops(384, 640, 4.0, 1.0, 90.0)

    def unpack(b):
        return (np.asarray(b.start), np.asarray(b.weights), b.n_src, b.n_dst)

    cop = convert.operator_from_numpy(
        dataclasses.asdict(jop.spec), unpack(jop.wy), unpack(jop.wx),
        tuple(np.asarray(s) for s in jop.raw_row_sums), jop.mode)
    assert cop.spec == top.spec
    _bands_equal(cop.wy, top.wy)
    _bands_equal(cop.wx, top.wx)
    t_weights.validate_operator(cop)
    with pytest.raises(ValueError, match="rows"):
        convert.band_from_numpy((jop.wy.start, jop.wy.weights, 10, 5))


def test_lru_counts_tensor_bytes_and_evicts_by_bytes():
    t = torch.zeros(10, 4, dtype=torch.float64)
    assert value_nbytes({"a": (t, np.zeros(3, np.float32)), "b": 7}) == 332
    lru = LruDict(8, max_bytes=1000)
    lru.put("x", torch.zeros(100, dtype=torch.float32))    # 400 B
    lru.put("y", torch.zeros(100, dtype=torch.bfloat16))   # 200 B
    lru.put("z", torch.zeros(120, dtype=torch.float32))    # 480 B: evicts x
    assert "x" not in lru and "y" in lru and "z" in lru
    assert lru.total_bytes == 680


def test_array_digest_memoized_and_content_keyed():
    a = np.arange(12.0)
    b = a.copy()
    assert array_digest(a) == array_digest(b) == array_digest(a)
    assert array_digest(a) != array_digest(a + 1.0)


def test_array_digest_memoizes_memory_maps(tmp_path):
    # a disk-cached operator's tables are memory maps: one hash each, not
    # one a call (np.asarray of a memmap is a new view every time)
    from aainterp_torch.utils.digest import digest_stats

    path = tmp_path / "t.npy"
    np.save(path, np.arange(1000.0))
    m = np.load(path, mmap_mode="r")
    before = digest_stats()
    d = array_digest(m)
    assert array_digest(m) == array_digest(m) == d
    after = digest_stats()
    assert (after["hashed"] - before["hashed"],
            after["memo_hits"] - before["memo_hits"]) == (1, 2)
    assert d == array_digest(np.arange(1000.0))


def test_import_pulls_in_neither_jax_nor_aainterp():
    code = (
        "import sys, aainterp_torch, aainterp_torch.api, "
        "aainterp_torch.ops.cuda_apply, aainterp_torch.convert, "
        "aainterp_torch.native, aainterp_torch.ops.clipper, "
        "aainterp_torch.ops.shear_apply, aainterp_torch.ops.cuda_shear, "
        "aainterp_torch.ops.weights, aainterp_torch.ops.apply, "
        "aainterp_torch.ops.shear3, aainterp_torch.ops.cuda_shear3, "
        "aainterp_torch.regrid, aainterp_torch.ops.cuda_apply_2d, "
        "aainterp_torch.utils.device, aainterp_torch.ops.compat, "
        "aainterp_torch.autodiff, aainterp_torch.ops.overlap1d, "
        "aainterp_torch.cli, aainterp_torch.__main__, "
        "aainterp_torch.pipeline, aainterp_torch.baselines, "
        "aainterp_torch.metrics, aainterp_torch.utils.io, "
        "aainterp_torch.utils.log, aainterp_torch.utils.cache, "
        "aainterp_torch.probes, aainterp_torch.probes.harness, "
        "aainterp_torch.probes.copy_ceiling, "
        "aainterp_torch.probes.rot_experiments, "
        "aainterp_torch.probes.band_probes, "
        "aainterp_torch.probes.flagship_experiments, "
        "aainterp_torch.probes.u8_experiments, "
        "aainterp_torch.probes.rgb1024_experiments, "
        "aainterp_torch.probes.aligned_fused_probe, "
        "aainterp_torch.probes.mosaic_watchlist, "
        "aainterp_torch.parallel, aainterp_torch.parallel.mesh, "
        "aainterp_torch.parallel.sharding, "
        "aainterp_torch.parallel.conserve\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'aainterp') "
        "or m.startswith(('jax.', 'jaxlib', 'aainterp.')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
