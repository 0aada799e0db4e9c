"""The port's streaming executor (``aainterp_torch.pipeline``) against the
JAX package's (``aainterp.pipeline``), on the CPU.

Both stream the same seeded numpy frames through the same operator; the
port runs its loop with ``device='cpu'`` (no streams; the pinned ring and
CUDA streams are held on the card by ``tests/test_torch_kernel_cuda.py``
and ``chip_smoke.py`` phase 39).  Tolerances are the direct applies':
separable and band pairs f32 rtol 1e-6, atol 1e-6 (quadrants rtol 1e-5);
rotated f32 rtol 1e-5, atol 1e-6 (uint8 input atol 1e-5); uint8 -> uint8
within one gray level of JAX (summation order can flip a .5) and equal
to the port's own direct apply.  Every stream also equals the port's
direct apply of each frame.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import aainterp as aa
from aainterp import pipeline as j_pipe
from aainterp.utils import io as j_io

import aainterp_torch as at
from aainterp_torch import pipeline as t_pipe
from aainterp_torch.utils import io as t_io

RNG = np.random.default_rng(11)
CPU = dict(device="cpu")


def _ops(shape=(48, 64), angle=0.0, method="auto"):
    spec = (shape, 2.0, 3.0, (0.0, 0.0), angle)
    jop = aa.build_operator(aa.make_grid_spec(*spec), mode="exact",
                            method=method)
    top = at.build_operator(at.make_grid_spec(*spec), mode="exact",
                            method=method)
    return jop, top


def _rot_ops():
    spec = ((40, 40), 1.0, 0.8, (20.0, 20.0), 30.0)
    jop = aa.build_operator(aa.make_grid_spec(*spec), mode="exact",
                            method="ell")
    top = at.build_operator(at.make_grid_spec(*spec), mode="exact",
                            method="ell")
    return jop, top


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _check(got, jgot, direct, rtol, atol):
    assert len(got) == len(jgot) == len(direct)
    for g, j, d in zip(got, jgot, direct):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        np.testing.assert_allclose(_np(g), np.asarray(j), rtol=rtol,
                                   atol=atol)
        np.testing.assert_allclose(_np(g), _np(d), rtol=rtol, atol=atol)


@pytest.mark.parametrize("n_frames", [1, 3, 4, 9])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_stream_matches_jax_and_direct(n_frames, depth):
    jop, top = _ops()
    frames = [RNG.uniform(0, 1, (48, 64)).astype(np.float32)
              for _ in range(n_frames)]
    got = list(t_pipe.stream_apply(top, frames, batch=4, depth=depth, **CPU))
    jgot = list(j_pipe.stream_apply(jop, frames, batch=4, depth=depth))
    direct = [at.apply_operator(top, torch.from_numpy(f)) for f in frames]
    _check(got, jgot, direct, 1e-6, 1e-6)


def test_stream_accepts_generator_tensors_and_leading_dims():
    jop, top = _ops()
    ref = [RNG.uniform(0, 1, (3, 48, 64)).astype(np.float32)
           for _ in range(5)]
    got = list(t_pipe.stream_apply(top, (torch.from_numpy(f) for f in ref),
                                   batch=2, depth=2, **CPU))
    jgot = list(j_pipe.stream_apply(jop, (f for f in ref), batch=2, depth=2))
    direct = [at.apply_operator(top, torch.from_numpy(f)) for f in ref]
    assert all(tuple(g.shape[:-2]) == (3,) for g in got)
    _check(got, jgot, direct, 1e-6, 1e-6)


def test_stream_uint8_contract():
    """u8 frames keep u8 in -> u8 out (round half to even, saturate)."""
    jop, top = _ops()
    frames = [RNG.integers(0, 256, (48, 64), dtype=np.uint8)
              for _ in range(3)]
    got = list(t_pipe.stream_apply(top, frames, batch=2, depth=2, **CPU))
    jgot = list(j_pipe.stream_apply(jop, frames, batch=2, depth=2))
    yb, xb, out_t = at.ops.weights.fold_quadrant_separable(top)
    assert not out_t
    for f, g, j in zip(frames, got, jgot):
        assert g.dtype == torch.uint8
        assert torch.equal(g, at.apply_band_operators(torch.from_numpy(f),
                                                      yb, xb))
        assert np.abs(_np(g).astype(int) - np.asarray(j).astype(int)).max() \
            <= 1


@pytest.mark.parametrize("angle,quad", [(90.0, 1), (180.0, 2), (270.0, 3)])
def test_stream_quadrants_fold(angle, quad):
    jop, top = _ops(angle=angle)
    assert top.spec.quadrant == quad
    frames = [RNG.uniform(0, 1, (48, 64)).astype(np.float32)
              for _ in range(3)]
    got = list(t_pipe.stream_apply(top, frames, batch=2, depth=2, **CPU))
    jgot = list(j_pipe.stream_apply(jop, frames, batch=2, depth=2))
    direct = [at.apply_operator(top, torch.from_numpy(f)) for f in frames]
    _check(got, jgot, direct, 1e-5, 1e-6)


def test_stream_band_pair_regrid():
    """A raw (Band1D, Band1D) pair (regrid / area_resize operators)."""
    jb = aa.regrid.conservative_regrid_operator(aa.regrid.LatLonGrid(24, 36),
                                                aa.regrid.LatLonGrid(12, 18))
    tb = at.conservative_regrid_operator(at.LatLonGrid(24, 36),
                                         at.LatLonGrid(12, 18))
    frames = [RNG.uniform(0, 1, (24, 36)).astype(np.float32)
              for _ in range(5)]
    got = list(t_pipe.stream_apply(tb, frames, batch=2, depth=2, **CPU))
    jgot = list(j_pipe.stream_apply(jb, frames, batch=2, depth=2))
    direct = [at.apply_band_operators(torch.from_numpy(f), *tb)
              for f in frames]
    _check(got, jgot, direct, 1e-6, 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_stream_rotated_ell(dtype):
    """Rotated (ELL) streams; uint8 input is cast to float32 (float out,
    as the JAX package's executor does)."""
    jop, top = _rot_ops()
    if dtype == "uint8":
        frames = [RNG.integers(0, 256, (40, 40), dtype=np.uint8)
                  for _ in range(3)]
    else:
        frames = [RNG.uniform(0, 1, (40, 40)).astype(np.float32)
                  for _ in range(3)]
    got = list(t_pipe.stream_apply(top, frames, batch=2, depth=2, **CPU))
    jgot = list(j_pipe.stream_apply(jop, frames, batch=2, depth=2))
    direct = [at.apply_operator(top, torch.from_numpy(
        f.astype(np.float32))) for f in frames]
    assert all(g.dtype == torch.float32 for g in got)
    _check(got, jgot, direct, 1e-5, 1e-5 if dtype == "uint8" else 1e-6)


def test_stream_rejects_ragged_frames():
    jop, top = _ops()
    ragged = [np.zeros((48, 64), np.float32), np.zeros((48, 63), np.float32)]
    for pipe, op, kw in ((t_pipe, top, CPU), (j_pipe, jop, {})):
        with pytest.raises(ValueError, match="changed mid-stream"):
            list(pipe.stream_apply(op, ragged, batch=4, **kw))
        with pytest.raises(ValueError, match="changed mid-stream"):
            list(pipe.stream_apply(op, [ragged[0], ragged[0].astype(
                np.float64)], batch=4, **kw))
        with pytest.raises(ValueError, match="at least 2-D"):
            list(pipe.stream_apply(op, [np.zeros(48, np.float32)], batch=4,
                                   **kw))
        with pytest.raises(ValueError, match="batch"):
            pipe.stream_apply(op, [], batch=0, **kw)
        with pytest.raises(ValueError, match="depth"):
            pipe.stream_apply(op, [], depth=0, **kw)
        with pytest.raises(TypeError, match="Band1D"):
            pipe.stream_apply((1, 2), [np.zeros((4, 4), np.float32)], **kw)


def test_stream_yields_copies_and_bf16_frames():
    """Yielded frames never alias the ring: a consumer that overwrites
    each one changes nothing later.  bf16 frames (tensors) stream too."""
    _, top = _ops()
    frames = [torch.from_numpy(RNG.uniform(0, 1, (48, 64)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(7)]
    got = []
    for g in t_pipe.stream_apply(top, frames, batch=2, depth=3, **CPU):
        got.append(g.clone())
        g.fill_(float("nan"))
    for f, g in zip(frames, got):
        assert torch.equal(g, at.apply_operator(top, f))
    # an identity step returns views of the ring's slot
    got = []
    for g in t_pipe.stream_apply(lambda x: x, frames, batch=3, depth=2,
                                 **CPU):
        got.append(g)
        g.zero_()
    assert len(got) == 7
    got = list(t_pipe.stream_apply(lambda x: x, frames, batch=3, depth=2,
                                   **CPU))
    assert all(torch.equal(f, g) for f, g in zip(frames, got))


def test_stream_failing_step_raises_and_device_rule():
    def bad(x):
        raise RuntimeError("step failed")

    with pytest.raises(RuntimeError, match="step failed"):
        list(t_pipe.stream_apply(bad, [np.zeros((4, 4), np.float32)],
                                 **CPU))
    _, top = _ops()
    if not torch.cuda.is_available():
        # a CUDA target with no CUDA device raises, eagerly
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_pipe.stream_apply(top, [])


def test_iter_files_order_threads_and_errors(tmp_path):
    mats = [RNG.uniform(0, 1, (8, 9)) for _ in range(7)]
    paths = []
    for i, m in enumerate(mats):
        p = tmp_path / f"f{i}.csv"
        t_io.csv_write(str(p), m)
        paths.append(str(p))
    got = list(t_pipe.iter_files(paths, threads=3, prefetch=2))
    jgot = list(j_pipe.iter_files(paths, threads=3, prefetch=2))
    assert len(got) == 7
    for m, g, j in zip(mats, got, jgot):
        np.testing.assert_array_equal(g, j)
        np.testing.assert_allclose(g, m, rtol=1e-12)
    # a missing file raises on ITS yield, after the earlier ones arrive
    it = t_pipe.iter_files(paths[:2] + [str(tmp_path / "missing.csv")],
                           threads=2)
    next(it), next(it)
    with pytest.raises(OSError):
        next(it)


def test_stream_apply_files_matches_jax(tmp_path):
    """read -> pipelined apply -> write, with the reference's _mod naming
    and 6-digit precision, against the JAX package's files."""
    jop, top = _ops((32, 40))
    mats = [RNG.uniform(0, 1, (32, 40)) for _ in range(5)]
    paths = []
    for i, m in enumerate(mats):
        p = tmp_path / f"in{i}.csv"
        t_io.csv_write(str(p), m)
        paths.append(str(p))
    jdir = tmp_path / "jax"
    jdir.mkdir()
    jouts = j_pipe.stream_apply_files(
        jop, paths, [str(jdir / f"in{i}_mod.csv") for i in range(5)],
        batch=2, depth=2, threads=2)
    outs = t_pipe.stream_apply_files(top, paths, batch=2, depth=2,
                                     threads=2, **CPU)
    assert outs == [str(tmp_path / f"in{i}_mod.csv") for i in range(5)]
    for m, o, jo in zip(mats, outs, jouts):
        got, ref = t_io.csv_read(o), j_io.csv_read(jo)
        np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(m).max())
    with pytest.raises(ValueError, match="outputs"):
        t_pipe.stream_apply_files(top, paths, [str(tmp_path / "x.csv")],
                                  **CPU)
