"""The rotated route's dead-pixel skip (``ops/cuda_shear``: the masked
contraction, TPU kernel 6 with ``masked=True``) on the CPU.

* ``live_spans``: each dst row's span holds every pixel whose weights in
  JAX's ``build_kernel_plan`` (its tiled ``w2t``) are not all 0, and its
  first and last columns are live ones, at the contraction probes'
  geometries (tests/test_torch_probes.py: 96 x 80 at 30 degrees, 300 x
  260 at 17) and one upscale (64 x 48, 1.0 -> 2.0 at 20 degrees);
  hand-made tables for empty and ragged rows.
* The masked plain contraction equals the unmasked one bit for bit on
  finite T (a dead pixel sums zero weights), f32 and bf16.
* The kernel route on the CPU (its plain versions: the fused shear, then
  the masked contraction) against JAX's masked route
  (``make_pallas_shear_apply``, ``interpret=True``) on ``[:Hd, :Wd]``: f32
  atol 1e-5 (tests/test_torch_ell_apply.py's pin; JAX sums b-major through
  one-hot matmuls, the port a-major), bf16 within one bf16 ulp (both round
  an f32 sum).
* NaN-filled T: the port writes 0 outside every row's span and NaN on the
  live pixels; JAX's masked contraction (in interpret mode, on 16 x 16 dst
  tiles so that these small planes have dead tiles) writes 0 on its dead
  tiles and NaN on every pixel of its live tiles, dead ones too: the
  departure the port keeps (the area average over no source area is 0).
* The disk cache: a v1 entry (no spans) is not loaded as a v2 plan, and a
  v2 entry without its span table is rebuilt with a warning.
* ``contract_unmasked_kernel`` on a CPU tensor takes the unmasked plain
  version and launches nothing.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aainterp as aa
from aainterp.ops import weights as j_weights
from aainterp.ops.pallas_shear import (_build_contract, build_kernel_plan,
                                       make_pallas_shear_apply, tile_masks)

import aainterp_torch as at
from aainterp_torch.ops import cuda_shear
from aainterp_torch.ops import weights as t_weights
from aainterp_torch.utils import cache as t_cache

GEOMS = [((96, 80), 1.0, 0.5, (40.0, 48.0), 30.0),
         ((300, 260), 1.0, 0.5, (130.0, 150.0), 17.0),
         ((64, 48), 1.0, 2.0, (24.0, 32.0), 20.0)]
IDS = ["96x80-30", "300x260-17", "up64x48-20"]
DTYPES = [torch.float32, torch.bfloat16]
_CASES = {}


def _case(args):
    """(JAX operator, JAX kernel plan, port operator, port plan)."""
    if args not in _CASES:
        jop = j_weights.ell_operator(aa.make_grid_spec(*args), mode="exact",
                                     prefer_native=False)
        top = t_weights.ell_operator(at.make_grid_spec(*args), mode="exact",
                                     prefer_native=False)
        _CASES[args] = (jop, build_kernel_plan(jop), top,
                        cuda_shear.plan_from_operator(top))
    return _CASES[args]


def _jax_weights(kp, Hd, Wd) -> np.ndarray:
    """JAX's tiled w2t as (taps, Hd, Wd)."""
    n, taps, TY, TX = kp.w2t.shape
    w = kp.w2t.reshape(kp.nty, kp.ntx, taps, TY, TX).transpose(2, 0, 3, 1, 4)
    return w.reshape(taps, kp.nty * TY, kp.ntx * TX)[:, :Hd, :Wd]


def _inside(plan) -> np.ndarray:
    cols = np.arange(plan.Wd)[None, :]
    return (cols >= plan.span[:, :1]) & (cols < plan.span[:, 1:])


def _t(plan, dtype, seed, frames=2):
    t = np.random.default_rng(seed).uniform(
        0, 1, (frames, plan.TH, plan.TW)).astype(np.float32)
    return torch.from_numpy(t).to(dtype)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(x.astype(np.float64)), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("args", GEOMS, ids=IDS)
def test_spans_hold_jax_live_pixels(args):
    jop, kp, top, plan = _case(args)
    Hd, Wd = plan.Hd, plan.Wd
    live = (_jax_weights(kp, Hd, Wd) != 0).any(axis=0)
    assert plan.span.shape == (Hd, 2) and plan.span.dtype == np.int32
    inside = _inside(plan)
    assert live.any() and (~inside).any()
    assert (inside | ~live).all()            # every live pixel is inside
    rows = plan.span[:, 1] > plan.span[:, 0]
    assert (rows == live.any(axis=1)).all()
    r = np.nonzero(rows)[0]
    lo, hi = plan.span[r, 0], plan.span[r, 1]
    assert live[r, lo].all() and live[r, hi - 1].all()   # ends are live
    assert (plan.span[~rows] == 0).all()
    # the port's own weights agree
    assert ((plan.w2 != 0).any(axis=0) == live).all()


def test_live_spans_of_handmade_tables():
    w2 = np.zeros((3, 4, 7), np.float32)
    w2[0, 0, 2] = 1.0                        # one live pixel
    w2[1, 1, 1] = w2[2, 1, 5] = 0.5          # dead pixels between live ones
    w2[2, 3, 0] = w2[0, 3, 6] = -1.0         # the whole row
    got = cuda_shear.live_spans(w2)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, [[2, 3], [1, 6], [0, 0], [0, 7]])


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("args", GEOMS, ids=IDS)
def test_masked_plain_equals_unmasked_on_finite_t(args, dtype):
    plan = _case(args)[3]
    t = _t(plan, dtype, seed=3)
    masked = cuda_shear.contract_plain(t, plan)
    assert torch.equal(masked, cuda_shear.contract_plain(t, plan,
                                                         masked=False))
    assert (masked[:, ~torch.from_numpy(_inside(plan))] == 0).all()
    # the wrappers on a CPU tensor take the plain versions, no launch
    before = dict(cuda_shear.LAUNCHES)
    assert torch.equal(cuda_shear.contract_kernel(t, plan), masked)
    assert torch.equal(cuda_shear.contract_unmasked_kernel(t, plan), masked)
    assert cuda_shear.LAUNCHES == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("args", GEOMS, ids=IDS)
def test_kernel_route_matches_jax_masked_route(args, dtype):
    jop, _, top, plan = _case(args)
    x = np.random.default_rng(5).uniform(
        0, 1, (2,) + tuple(top.spec.qrot_shape)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    fn, arrs = make_pallas_shear_apply(jop, interpret=True)
    want = np.asarray(fn(jnp.asarray(x, jdt), **arrs).astype(jnp.float32))
    xt = torch.from_numpy(np.asarray(jnp.asarray(x, jdt).astype(jnp.float32)))
    got = cuda_shear.apply_ell_shear_kernel(xt.to(getattr(torch, dtype)),
                                            plan)
    assert got.dtype == getattr(torch, dtype)
    assert want.shape == tuple(got.shape) == (2, plan.Hd, plan.Wd)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert (np.abs(got.astype(np.float64) - want) <= bf16_ulp(want)).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("args", GEOMS[:2], ids=IDS[:2])
def test_nan_t_gives_zero_outside_spans(args, dtype):
    jop, kp, top, plan = _case(args)
    F = 2
    t = torch.full((F, plan.TH, plan.TW), float("nan"), dtype=dtype)
    got = cuda_shear.contract_plain(t, plan).float().numpy()
    inside = _inside(plan)
    live = (plan.w2 != 0).any(axis=0)
    assert (got[:, ~inside] == 0).all()
    assert np.isnan(got[:, live]).all()
    # unmasked, the dead pixels give NaN too (NaN * 0)
    un = cuda_shear.contract_plain(t, plan, masked=False).float().numpy()
    assert np.isnan(un).all()
    # JAX's masked contraction: 0 on its dead tiles, NaN on its live ones
    # (16 x 16 dst tiles here, so that these small planes have dead ones)
    kp = build_kernel_plan(jop, tile_y=16, tile_x=16)
    dname = "float32" if dtype == torch.float32 else "bfloat16"
    tp = jnp.full((F, kp.THp, kp.TWp), jnp.nan, jnp.dtype(dname))
    masks = tile_masks(kp.w2t)
    fn = _build_contract(F, kp.THp, kp.TWp, kp.nty, kp.ntx, kp.TYd, kp.TXd,
                         kp.Ka, kp.Kb, kp.SRF, kp.SCF, dname, dname, True,
                         masked=True)
    want = np.asarray(fn(jnp.asarray(kp.r0), jnp.asarray(kp.c0),
                         jnp.asarray(masks), tp,
                         jnp.asarray(kp.rsel, jnp.dtype(dname)),
                         jnp.asarray(kp.csel, jnp.dtype(dname)),
                         jnp.asarray(kp.w2t)).astype(jnp.float32))
    tile_live = np.repeat(np.repeat(masks.reshape(kp.nty, kp.ntx) != 0,
                                    kp.TYd, 0), kp.TXd, 1)[:plan.Hd, :plan.Wd]
    want = want[:, :plan.Hd, :plan.Wd]
    assert (~tile_live).any() and (want[:, ~tile_live] == 0).all()
    assert np.isnan(want[:, tile_live]).all()
    # where the two differ: dead pixels of JAX's live tiles
    assert (tile_live & ~inside).any()


def test_v1_disk_entry_is_not_loaded_as_a_plan(tmp_path, monkeypatch):
    args = GEOMS[0]
    top = _case(args)[2]
    d = str(tmp_path)
    fresh = cuda_shear.plan_from_operator(top)
    # a v1 entry, written as the v1 cache did (no span table), at its key
    monkeypatch.setattr(cuda_shear, "PLAN_CACHE_VERSION", "cuda_shear_v1")
    v1 = cuda_shear.plan_cache_path(top, d)
    meta = {n: int(getattr(fresh, n)) for n in cuda_shear._PLAN_DIMS}
    meta["fingerprint"] = cuda_shear.table_fingerprint(top)
    np.savez(v1, __meta__=json.dumps(meta),
             **{n: getattr(fresh, n) for n in ("gy", "hx", "ry0", "cx0",
                                               "w2")})
    monkeypatch.undo()
    assert cuda_shear.PLAN_CACHE_VERSION == "cuda_shear_v2"
    v2 = cuda_shear.plan_cache_path(top, d)
    assert v2 != v1 and os.path.exists(v1) and not os.path.exists(v2)
    assert os.path.basename(v2).startswith(
        t_cache.spec_key(top.spec, top.mode, "cuda_shear_v2"))
    assert cuda_shear.load_plan(top, d) is None
    cuda_shear._PLAN_CACHE.clear()
    before = dict(cuda_shear.PLAN_DISK)
    plan = cuda_shear.kernel_plan_cached(top, cache_dir=d)
    assert cuda_shear.PLAN_DISK == {"built": before["built"] + 1,
                                    "loaded": before["loaded"]}
    np.testing.assert_array_equal(plan.span, fresh.span)
    # a v2 entry that lost its span table is not a plan either
    with np.load(v2) as z:
        arrays = {k: z[k] for k in z.files if k != "span"}
    np.savez(v2, **arrays)
    cuda_shear._PLAN_CACHE.clear()
    with pytest.warns(RuntimeWarning, match="unreadable shear plan"):
        again = cuda_shear.kernel_plan_cached(top, cache_dir=d)
    np.testing.assert_array_equal(again.span, fresh.span)
    cuda_shear._PLAN_CACHE.clear()
    loaded = cuda_shear.kernel_plan_cached(top, cache_dir=d)
    assert cuda_shear.PLAN_DISK["loaded"] == before["loaded"] + 1
    np.testing.assert_array_equal(loaded.span, fresh.span)
