"""The fused aligned regrid (``aainterp_torch/probes/aligned_fused_probe.py``)
against the JAX package's probe ``benchmarks/aligned_fused_probe.py`` and
the aligned route, on the CPU, where the wrapper takes the plain version.

JAX's ``_build_fused`` runs in interpret mode (``interpret=True``) and its
output goes through ``_fused_finish``, at a reduced aligned geometry,
``LatLonGrid(180, 360)`` -> ``LatLonGrid(18, 36)`` (m = 10 on both axes),
set through ``monkeypatch`` of the module's ``H``, ``W``, ``Hd``, ``Wd``,
``TY`` (9: two row blocks) and ``TX`` (36, so that mx * TX * ntx = W: at
config 5, JAX's last 1280-column block reaches past W = 3600, which
interpret mode does not check); the plans are built in the test, as JAX's
``_geometry`` is fixed at config 5.  The port's plain version against it
and against ``apply_separable_aligned`` at rel 1e-5 (JAX's own ``check``
bound, aligned_fused_probe.py:277), against a float64 statement, with
``c0`` offsets applied; the einsum within 1e-5 of the plain version; the
byte counts, the entry points with ``device="cpu"`` and, without a GPU,
the default device raising.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aainterp.ops.apply import aligned_axis_plan as j_aligned_axis_plan
from aainterp.regrid import LatLonGrid as JGrid
from aainterp.regrid import conservative_regrid_operator as j_operator

from aainterp_torch.ops import cuda_apply_2d
from aainterp_torch.ops.apply import apply_separable_aligned
from aainterp_torch.probes import aligned_fused_probe as af

SRC, DST = (180, 360), (18, 36)
F = 2


@pytest.fixture
def jfused(monkeypatch):
    from benchmarks import aligned_fused_probe as jf
    for name, v in (("H", SRC[0]), ("W", SRC[1]), ("Hd", DST[0]),
                    ("Wd", DST[1]), ("TY", 9), ("TX", 36)):
        monkeypatch.setattr(jf, name, v)
    jf._build_fused.cache_clear()
    yield jf
    jf._build_fused.cache_clear()


def _fields(shape, seed=3, frames=F):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        200, 300, (frames,) + tuple(shape)).astype(np.float32))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1e-6)).max())


def _jax_plans():
    by, bx = j_operator(JGrid(*SRC), JGrid(*DST))
    return (j_aligned_axis_plan(np.asarray(by.start),
                                np.asarray(by.weights, np.float32), by.n_src),
            j_aligned_axis_plan(np.asarray(bx.start),
                                np.asarray(bx.weights, np.float32), bx.n_src))


def _statement(f, yp, xp) -> np.ndarray:
    """float64 sum_b wkx * sum_a wky * src, offsets applied."""
    f = f.double().numpy()
    my, cy, wy = yp["m"], yp["c0"], np.asarray(yp["wk"], np.float64)
    mx, cx, wx = xp["m"], xp["c0"], np.asarray(xp["wk"], np.float64)
    hd, wd = len(wy), len(wx)
    q = f[:, cy:cy + my * hd, cx:cx + mx * wd]
    q = q.reshape(f.shape[0], hd, my, wd, mx)
    return np.einsum("fhawb,ha,wb->fhw", q, wy, wx)


def test_plans_match_jax():
    yp, xp = af.geometry(SRC, DST)
    jyp, jxp = _jax_plans()
    for p, jp in ((yp, jyp), (xp, jxp)):
        assert (p["m"], p["c0"]) == (jp["m"], jp["c0"]) == (10, 0)
        np.testing.assert_array_equal(p["wk"], jp["wk"])


def test_plain_matches_jax_fused(jfused):
    jyp, jxp = _jax_plans()
    my, mx, nty, ntx, wyb, wxb = jfused._fused_tables(jyp, jxp)
    assert (nty, ntx) == (2, 1) and mx * jfused.TX * ntx == SRC[1]
    f = _fields(SRC)
    probe = jfused._build_fused(F, my, mx, nty, ntx, interpret=True)
    want = np.asarray(jfused._fused_finish(
        probe(jnp.asarray(f.numpy()), jnp.asarray(wyb), jnp.asarray(wxb)),
        nty, ntx))
    yp, xp = af.geometry(SRC, DST)
    before = af.LAUNCHES
    got = af.aligned_fused_kernel(f, yp, xp)
    assert af.LAUNCHES == before
    assert got.dtype == torch.float32 and got.shape == (F,) + DST
    assert _rel(got, want) < 1e-5
    assert _rel(got, apply_separable_aligned(f, yp, xp)) < 1e-5
    assert torch.equal(got, af.aligned_fused_plain(f, yp, xp))


@pytest.mark.parametrize("geom", [(SRC, DST), ((1800, 3600), (180, 360))],
                         ids=["18x36", "config5"])
def test_plain_meets_its_statement(geom):
    src, dst = geom
    yp, xp = af.geometry(src, dst)
    f = _fields(src, seed=4, frames=1)
    got = af.aligned_fused_plain(f, yp, xp)
    assert _rel(got, _statement(f, yp, xp)) < 1e-6
    assert _rel(got, apply_separable_aligned(f, yp, xp)) < 1e-5


def test_c0_offsets_are_applied():
    rng = np.random.default_rng(5)
    yp = dict(m=3, c0=2, wk=rng.uniform(0, 1, (7, 3)).astype(np.float32))
    xp = dict(m=5, c0=1, wk=rng.uniform(0, 1, (9, 5)).astype(np.float32))
    f = _fields((2 + 3 * 7 + 1, 1 + 5 * 9 + 3), seed=6)
    got = af.aligned_fused_kernel(f, yp, xp)
    assert got.shape == (F, 7, 9)
    assert _rel(got, _statement(f, yp, xp)) < 1e-6
    assert _rel(got, apply_separable_aligned(f, yp, xp)) < 1e-5
    # the plain version sums in the kernel's order: tap by tap, y then x
    t = torch.zeros(F, 7, 45)
    for a in range(3):
        t = t + torch.from_numpy(yp["wk"][:, a, None]) * f[:, 2 + a:23:3, 1:46]
    assert _rel(got, (t.reshape(F, 7, 9, 5)
                      * torch.from_numpy(xp["wk"])).sum(-1)) < 1e-5


def test_fused_rejects_what_it_cannot_take():
    yp, xp = af.geometry(SRC, DST)
    f = _fields(SRC)
    with pytest.raises(TypeError, match="float32"):
        af.aligned_fused_kernel(f.to(torch.bfloat16), yp, xp)
    with pytest.raises(ValueError, match="does not fit"):
        af.aligned_fused_kernel(f[:, :170], yp, xp)
    with pytest.raises(ValueError, match="does not fit"):
        af.aligned_fused_kernel(f, yp, dict(xp, c0=1))
    with pytest.raises(ValueError, match=r"\(F, H, W\)"):
        af.aligned_fused_kernel(f[0], yp, xp)
    buf = torch.full((F,) + DST, float("nan"))
    got = af.aligned_fused_kernel(f, yp, xp, out=buf)
    assert got is buf and torch.equal(got, af.aligned_fused_plain(f, yp, xp))


def test_einsum_matches_plain():
    yp, xp = af.geometry(SRC, DST)
    f = _fields(SRC, seed=7)
    assert _rel(af.einsum(f, yp, xp), af.aligned_fused_plain(f, yp, xp)) \
        < 1e-5


def test_check_on_cpu():
    rel = af.check("cpu", SRC, DST)
    assert set(rel) == {"fused", "einsum"}
    assert all(0 <= v < 1e-5 for v in rel.values())


def test_chunks_and_traffic():
    assert af.chunk_cols(360, 10) == 360            # config 5: one chunk
    assert 4 * 60 * af.chunk_cols(250, 60) <= af.CHUNK_BYTES
    assert af.chunk_cols(250, 60) < 250
    yp, xp = af.geometry()
    nbytes, ops = af.traffic(yp, xp, (8, 1800, 3600))
    assert nbytes == 4 * (8 * 1800 * 3600 + 8 * 180 * 360 + 180 * 10
                          + 360 * 10)
    assert ops == 2 * 8 * 180 * (3600 * 10 + 360 * 10)
    assert round(nbytes / 3.35e12 * 1e3, 4) == 0.0625


@pytest.mark.parametrize("exp", sorted(af.EXPS))
def test_experiments_run_on_cpu(exp):
    before = (af.LAUNCHES, cuda_apply_2d.LAUNCHES)
    r = af.EXPS[exp](1, "cpu", SRC, DST)
    assert (af.LAUNCHES, cuda_apply_2d.LAUNCHES) == before
    assert r["clock"] == "host" and r["device"] == "cpu"
    assert r["exp"] == exp and r["batch"] == 1 and r["shape"] == list(SRC)
    assert r["ms_per_batch"] > 0 and r["gpixel_s"] > 0
    assert (r["bytes"], r["operations"]) == af.traffic(
        *af.geometry(SRC, DST), (1,) + SRC)


def test_entry_point_main_and_default_device(capsys):
    assert af.main(["--check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "check fused: max rel err" in out and "check einsum" in out
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        af.EXPS["pallas"](1, None, SRC, DST)
    assert af.main(["--exp", "pallas"]) == 2
    assert "device='cpu'" in capsys.readouterr().err
