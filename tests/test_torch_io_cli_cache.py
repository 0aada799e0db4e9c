"""The port's I/O, logging, CLI and disk caches (``aainterp_torch.utils.io``,
``utils.log``, ``cli``, ``utils.cache`` and the shear-plan disk cache of
``ops.cuda_shear``) against the JAX package's, on the CPU.

CLI: the port runs with ``--device cpu``, the JAX package's ``cli.main``
in-process on its CPU backend; stdout must be byte-equal once the
"Calculation time" and "ms/file" numbers are masked, and the output CSVs
agree within 1e-5 x max|src| (both compute in float32 and write 6
significant digits).  Caches: the on-disk format is shared, so an
operator either package wrote loads in the other bit for bit
(``np.array_equal``), and ``spec_key`` gives the same string.
"""

import dataclasses
import os
import re
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import aainterp as aa
from aainterp import cli as j_cli
from aainterp.utils import cache as j_cache
from aainterp.utils import io as j_io
from aainterp.utils import log as j_log

import aainterp_torch as at
from aainterp_torch import cli as t_cli
from aainterp_torch.ops import cuda_shear
from aainterp_torch.utils import cache as t_cache
from aainterp_torch.utils import io as t_io
from aainterp_torch.utils import log as t_log

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MASKS = ((re.compile(r"Calculation time : \S+ \[ms\]"),
           "Calculation time : ? [ms]"),
          (re.compile(r"\(\S+ ms/file\)"), "(? ms/file)"))


def _mask(text: str) -> str:
    for pat, rep in _MASKS:
        text = pat.sub(rep, text)
    return text


def _run_both(capsys, tmp_path, argv_of, out_name=None):
    """Run the JAX CLI and the port's on the same input; return (rc_j,
    rc_t, stdout_j, stdout_t, out_j, out_t) with the output CSV paths
    (JAX's under tmp_path/jax, the port's under tmp_path/torch)."""
    res = []
    for who, main, extra in (("jax", j_cli.main, []),
                             ("torch", t_cli.main, ["--device", "cpu"])):
        d = tmp_path / who
        d.mkdir(exist_ok=True)
        rc = main(argv_of(d) + extra)
        res.append((rc, capsys.readouterr().out,
                    None if out_name is None else str(d / out_name)))
    (rj, sj, oj), (rt, st, ot) = res
    return rj, rt, sj, st, oj, ot


def _write_input(tmp_path, name, arr):
    p = str(tmp_path / name)
    t_io.csv_write(p, arr)
    return p


# ----------------------------------------------------------------------
# I/O and logging
# ----------------------------------------------------------------------


def test_split_path_and_default_output_path():
    for p in ("a/b/c.csv", "c.csv", "a\\b\\c.CSV", "noext", "d/x.y.csv"):
        assert t_io.split_path(p) == j_io.split_path(p)
        assert t_io.default_output_path(p) == j_io.default_output_path(p)


def test_csv_read_semantics_match_jax(tmp_path):
    p = str(tmp_path / "img.csv")
    with open(p, "w") as f:
        f.write("1.0,abc,2.0\n\n3.0,4.0,5.0\n-1e-3, 7 ,x\n")
    got = t_io.csv_read(p)
    np.testing.assert_array_equal(got, j_io.csv_read(p))
    np.testing.assert_array_equal(t_io._csv_read_py(p), j_io._csv_read_py(p))
    np.testing.assert_array_equal(got, t_io._csv_read_py(p))
    empty = tmp_path / "empty.csv"
    empty.write_text("")
    with pytest.raises(ValueError, match="no data"):
        t_io.csv_read(str(empty))
    with pytest.raises(OSError):
        t_io.csv_read(str(tmp_path / "missing.csv"))


@pytest.mark.parametrize("sig_digits", [6, 0])
def test_csv_write_native_byte_identical(tmp_path, sig_digits):
    """The native writer's bytes equal np.savetxt's and the JAX package's
    writer's, at both precisions; a tensor writes like its array."""
    from aainterp_torch import native

    rng = np.random.default_rng(3)
    a = rng.uniform(-1e6, 1e6, (25, 19))
    a[0, 0], a[1, 1], a[2, 2] = 0.0, 1e-12, -3.25
    paths = {k: str(tmp_path / f"{k}.csv")
             for k in ("nat", "py", "jax", "tensor")}
    native.csv_write_native(paths["nat"], a, sig_digits=sig_digits)
    fmt = f"%.{sig_digits}g" if sig_digits > 0 else "%.17g"
    np.savetxt(paths["py"], a, delimiter=",", fmt=fmt)
    j_io.csv_write(paths["jax"], a, sig_digits=sig_digits)
    t_io.csv_write(paths["tensor"], torch.from_numpy(a),
                   sig_digits=sig_digits)
    blobs = {k: open(p, "rb").read() for k, p in paths.items()}
    assert native.available()
    assert blobs["nat"] == blobs["py"] == blobs["jax"] == blobs["tensor"]
    np.testing.assert_array_equal(native.csv_read_native(paths["py"]),
                                  j_io.csv_read(paths["py"]))


def test_image_read_write_roundtrip(tmp_path):
    img = np.random.default_rng(4).uniform(0, 1, (12, 10))
    pt, pj = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    t_io.image_write(pt, torch.from_numpy(img))
    j_io.image_write(pj, img)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    np.testing.assert_array_equal(t_io.image_read(pt), j_io.image_read(pj))
    np.testing.assert_array_equal(t_io.image_read(pt, as_gray=True),
                                  j_io.image_read(pj, as_gray=True))


def test_banner_and_logging(tmp_path, capsys):
    for args in (("AreaAverageInterpolation::areaAverageInterpolation",
                  150.0, 25.4, (455.0, 455.0), 1.5),
                 ("AreaAverageInterpolation::fastAreaAverageInterpolation",
                  1 / 3, 1e-7, (0.5, 12345.678), 359.99)):
        assert t_log.banner(*args) == j_log.banner(*args)
    assert t_log.log_record("x", a=1) == j_log.log_record("x", a=1)
    holder = {}
    with t_log.device_timer("apply", holder):
        at.area_resize(torch.ones(1, 8, 8), (4, 4))
    assert holder["apply"] >= 0.0
    assert "Calculation time : " in capsys.readouterr().out
    with t_log.profile_trace(str(tmp_path / "trace")) as d:
        at.area_resize(torch.ones(1, 8, 8), (4, 4))
        at.area_average_interpolate(torch.ones(1, 8, 8), 2.0, 1.0,
                                    (0.0, 0.0), 0.0)
    assert os.path.getsize(os.path.join(d, "trace.json")) > 0
    # the program's own spans are in the trace
    with open(os.path.join(d, "trace.json")) as f:
        assert '"aa.interpolate"' in f.read()


# ----------------------------------------------------------------------
# The CLI against the JAX package's
# ----------------------------------------------------------------------

LEGACY = {
    "mode2": ["--mode", "2"],
    "mode1": ["--mode", "1"],
    "compat": ["--mode", "1", "--compat"],
    "angle0": ["--mode", "1", "--angle", "0"],
    "mode2_verbose_6sig": ["--mode", "2", "--verbose", "--sig-digits", "0",
                           "--no-banner"],
}


@pytest.mark.parametrize("case", sorted(LEGACY))
def test_cli_legacy_stdout_and_csv_match_jax(tmp_path, capsys, case):
    img = np.random.default_rng(3).uniform(0, 1, (48, 48))
    inp = _write_input(tmp_path, "in.csv", img)
    base = ["--src-resolution", "150", "--dst-resolution", "25.4",
            "--isocenter", "24", "24", "--angle", "1.5"]

    def argv(d):
        return [inp] + base + LEGACY[case] + ["--output", str(d / "o.csv")]

    rj, rt, sj, st, oj, ot = _run_both(capsys, tmp_path, argv, "o.csv")
    assert rj == rt == 0
    assert _mask(st) == _mask(sj)
    assert "Run terminated correctly." in st
    got, ref = t_io.csv_read(ot), j_io.csv_read(oj)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(img).max())


ERRORS = {
    "non_csv": lambda tmp: [str(tmp / "x.txt")],
    "src_resolution_0": lambda tmp: [str(tmp / "in.csv"),
                                     "--src-resolution", "0"],
    "missing_file": lambda tmp: [str(tmp / "missing.csv")],
    "empty_file": lambda tmp: [str(tmp / "empty.csv")],
    "resize_non_csv": lambda tmp: ["resize", str(tmp / "x.txt"),
                                   "--shape", "2", "2"],
    "regrid_shape_mismatch": lambda tmp: [
        "regrid", str(tmp / "in.csv"), "--src-grid", "99", "20",
        "--dst-grid", "5", "10"],
    "multi_output": lambda tmp: [str(tmp / "in.csv"), str(tmp / "in.csv"),
                                 "--output", str(tmp / "o.csv")],
    "resize_mask_bilinear": lambda tmp: [
        "resize", str(tmp / "in.csv"), "--shape", "4", "4", "--method",
        "bilinear", "--mask", str(tmp / "in.csv")],
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_cli_error_paths_match_jax(tmp_path, capsys, case):
    _write_input(tmp_path, "in.csv",
                 np.random.default_rng(5).uniform(0, 1, (10, 20)))
    (tmp_path / "empty.csv").write_text("")
    rj, rt, sj, st, _, _ = _run_both(capsys, tmp_path,
                                     lambda d: ERRORS[case](tmp_path))
    assert rj == rt == -1
    assert st == sj
    assert st.endswith("Run terminated abnormally.\n")


SUBCOMMANDS = {
    "resize_area": (["resize", "{inp}", "--shape", "30", "20"], (60, 90)),
    "resize_bicubic": (["resize", "{inp}", "--shape", "30", "64",
                        "--method", "bicubic"], (60, 90)),
    "resize_bilinear_up": (["resize", "{inp}", "--shape", "70", "100",
                            "--method", "bilinear"], (60, 90)),
    "resize_masked": (["resize", "{inp}", "--shape", "20", "20", "--mask",
                       "{mask}", "--fill", "0"], (40, 40)),
    "rotate": (["rotate", "{inp}", "--angle", "30"], (48, 48)),
    "rotate_fast_iso": (["rotate", "{inp}", "--angle", "-12.5",
                         "--mode", "fast", "--isocenter", "10", "14"],
                        (32, 40)),
    "regrid": (["regrid", "{inp}", "--dst-grid", "12", "18"], (120, 72)),
}


@pytest.mark.parametrize("case", sorted(SUBCOMMANDS))
def test_cli_subcommands_match_jax(tmp_path, capsys, case):
    template, shape = SUBCOMMANDS[case]
    rng = np.random.default_rng(6)
    img = rng.uniform(200, 300, shape)
    inp = _write_input(tmp_path, "in.csv", img)
    mask = _write_input(tmp_path, "mask.csv",
                        (rng.uniform(0, 1, shape) > 0.3).astype(float))

    def argv(d):
        return [a.format(inp=inp, mask=mask) for a in template] + [
            "--output", str(d / "o.csv")]

    rj, rt, sj, st, oj, ot = _run_both(capsys, tmp_path, argv, "o.csv")
    assert rj == rt == 0
    assert _mask(st) == _mask(sj)
    got, ref = t_io.csv_read(ot), j_io.csv_read(oj)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(img).max())


def test_cli_regrid_conserve_check(tmp_path, capsys):
    """--conserve-check prints the flux pair; the source mean is the same
    float64 sum (byte-equal), the destination mean and relative error
    agree to float32 summation order."""
    field = np.random.default_rng(4).uniform(200, 300, (120, 72))
    inp = _write_input(tmp_path, "f.csv", field)
    rj, rt, sj, st, _, _ = _run_both(
        capsys, tmp_path, lambda d: ["regrid", inp, "--dst-grid", "12",
                                     "18", "--conserve-check", "--output",
                                     str(d / "o.csv")])
    assert rj == rt == 0
    pat = r"Flux check : src mean (\S+), dst mean (\S+), relative error (\S+)"
    mj, mt = re.search(pat, sj), re.search(pat, st)
    assert mt.group(1) == mj.group(1)
    assert abs(float(mt.group(2)) - float(mj.group(2))) <= 1e-6 * 300
    assert float(mt.group(3)) < 1e-6
    assert re.sub(pat, "", _mask(st)) == re.sub(pat, "", _mask(sj))


def test_cli_multi_input_stream_matches_jax_and_single(tmp_path, capsys):
    """Multi-input: one operator, <base>_mod.csv per input; each output
    byte-equal to the single-input command's on the same file, and
    stdout equal to the JAX package's (timings masked)."""
    mats = [np.random.default_rng(7 + i).uniform(0, 1, (24, 24))
            for i in range(3)]
    common = ["--src-resolution", "150", "--dst-resolution", "25.4",
              "--isocenter", "12", "12", "--angle", "1.5", "--mode", "2",
              "--batch", "2"]
    outs = {}
    for who, main, extra in (("jax", j_cli.main, []),
                             ("torch", t_cli.main, ["--device", "cpu"])):
        d = tmp_path / who
        d.mkdir()
        paths = [_write_input(d, f"s{i}.csv", m) for i, m in enumerate(mats)]
        assert main(paths + common + extra) == 0
        outs[who] = capsys.readouterr().out
    assert _mask(outs["torch"]) == _mask(outs["jax"])
    assert "Streamed 3 files" in outs["torch"]
    d = tmp_path / "torch"
    for i, m in enumerate(mats):
        multi = open(d / f"s{i}_mod.csv", "rb").read()
        (d / f"s{i}_mod.csv").unlink()
        assert t_cli.main([str(d / f"s{i}.csv")] + common
                          + ["--device", "cpu", "--no-banner"]) == 0
        assert open(d / f"s{i}_mod.csv", "rb").read() == multi
        np.testing.assert_allclose(
            t_io.csv_read(str(d / f"s{i}_mod.csv")),
            j_io.csv_read(str(tmp_path / "jax" / f"s{i}_mod.csv")),
            atol=1e-5)
    capsys.readouterr()


def test_cli_raster_without_pillow_fails_cleanly(tmp_path, capsys,
                                                 monkeypatch):
    """No Pillow: a raster input prints a message and returns -1 (exit
    255) instead of raising ImportError (the JAX CLI lets it escape)."""
    from PIL import Image

    img = np.random.default_rng(8).integers(0, 256, (16, 16), np.uint8)
    inp = str(tmp_path / "in.png")
    Image.fromarray(img).save(inp)
    assert t_cli.main(["resize", inp, "--shape", "8", "8",
                       "--device", "cpu"]) == 0
    out = np.asarray(Image.open(str(tmp_path / "in_mod.png")))
    ref = j_cli.main(["resize", inp, "--shape", "8", "8", "--output",
                      str(tmp_path / "j.png")])
    assert ref == 0
    assert np.abs(out.astype(int) - np.asarray(
        Image.open(str(tmp_path / "j.png"))).astype(int)).max() <= 1
    capsys.readouterr()
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert t_cli.main(["rotate", inp, "--angle", "10",
                       "--device", "cpu"]) == -1
    text = capsys.readouterr().out
    assert text.startswith("Failed to read image file.")
    assert text.endswith("Run terminated abnormally.\n")
    csv_in = _write_input(tmp_path, "c.csv", img.astype(float))
    assert t_cli.main(["resize", csv_in, "--shape", "8", "8", "--output",
                       str(tmp_path / "o.png"), "--device", "cpu"]) == -1
    assert capsys.readouterr().out.endswith("Run terminated abnormally.\n")


def test_cli_without_gpu_exits_255(tmp_path):
    """`python -m aainterp_torch` with no GPU and no --device cpu prints
    the device error and exits 255, computing nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    img = np.random.default_rng(9).uniform(0, 1, (16, 16))
    inp = _write_input(tmp_path, "in.csv", img)
    env = dict(os.environ, PYTHONPATH=REPO)
    for argv in ([inp], ["resize", inp, "--shape", "8", "8"]):
        proc = subprocess.run([sys.executable, "-m", "aainterp_torch"]
                              + argv, capture_output=True, text=True,
                              env=env, cwd=str(tmp_path), timeout=300)
        assert proc.returncode == 255, proc.stderr
        assert proc.stdout.endswith("Run terminated abnormally.\n")
        assert "no CUDA device" in proc.stdout
        assert not os.path.exists(tmp_path / "in_mod.csv")


# ----------------------------------------------------------------------
# Operator cache: shared format with the JAX package
# ----------------------------------------------------------------------

GEOMS = {
    "separable": ((24, 24), 2.0, 1.0, (4.0, 4.0), 0.0, "exact"),
    "separable_q1": ((20, 28), 2.0, 1.5, (4.0, 4.0), 90.0, "fast"),
    "ell": ((20, 20), 1.0, 0.5, (10.0, 10.0), 30.0, "exact"),
    "ell_fast": ((20, 20), 1.0, 0.8, (10.0, 10.0), 200.0, "fast"),
}


def _spec_pair(name):
    *geom, mode = GEOMS[name]
    return aa.make_grid_spec(*geom), at.make_grid_spec(*geom), mode


def _tables(op):
    if hasattr(op, "wy"):
        return (op.wy.start, op.wy.weights, op.wx.start, op.wx.weights,
                *op.raw_row_sums)
    return op.base, op.weights, op.raw_row_sums


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_operator_cache_shared_with_jax(tmp_path, name):
    jspec, tspec, mode = _spec_pair(name)
    method = "separable" if tspec.is_axis_aligned else "ell"
    assert t_cache.spec_key(tspec, mode, method) == \
        j_cache.spec_key(jspec, mode, method)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    # JAX writes, the port loads (and the reverse), bit for bit
    jop = j_cache.build_operator_cached(jspec, mode=mode, cache_dir=jdir)
    got = t_cache.load_operator(tspec, mode, method, cache_dir=jdir)
    top = t_cache.build_operator_cached(tspec, mode=mode, cache_dir=tdir)
    back = j_cache.load_operator(jspec, mode, method, cache_dir=tdir)
    for a, b, c, d in zip(_tables(jop), _tables(got), _tables(top),
                          _tables(back)):
        assert np.array_equal(a, b) and np.array_equal(c, d)
        assert np.array_equal(a, c)
    assert got.mode == back.mode == mode
    assert type(got).__name__ == type(jop).__name__
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))


def test_legacy_npz_entry_loads(tmp_path):
    _, tspec, mode = _spec_pair("ell")
    op = at.build_operator(tspec, mode=mode)
    key = t_cache.spec_key(tspec, mode, "ell")
    np.savez(str(tmp_path / f"{key}.npz"), base=op.base, w=op.weights,
             sums=op.raw_row_sums, __mode__=np.array(mode))
    got = t_cache.load_operator(tspec, mode, "ell", cache_dir=str(tmp_path))
    assert np.array_equal(got.weights, op.weights) and got.mode == mode


def test_poisoned_or_unreadable_operator_entry_is_rebuilt(tmp_path):
    _, spec, _ = _spec_pair("separable")
    d = str(tmp_path)
    op1 = t_cache.build_operator_cached(spec, cache_dir=d)
    key = t_cache.spec_key(spec, "exact", "separable")
    wpath = tmp_path / f"{key}.op" / "wy_w.npy"
    w = np.load(wpath)
    w[0, 0] = np.nan
    np.save(wpath, w)
    with pytest.warns(RuntimeWarning, match="failed validation"):
        op2 = t_cache.build_operator_cached(spec, cache_dir=d)
    np.testing.assert_array_equal(op2.wy.weights, op1.wy.weights)
    assert np.isfinite(t_cache.load_operator(
        spec, "exact", "separable", cache_dir=d).wy.weights).all()
    os.remove(wpath)                       # a partial write
    with pytest.warns(RuntimeWarning, match="unreadable"):
        assert t_cache.load_operator(spec, "exact", "separable",
                                     cache_dir=d) is None
    with pytest.warns(RuntimeWarning, match="unreadable"):
        op3 = t_cache.build_operator_cached(spec, cache_dir=d)
    np.testing.assert_array_equal(op3.wy.weights, op1.wy.weights)


def test_cli_cache_dir_reuses_operator(tmp_path, capsys):
    """A second --cache-dir run loads the operator: the weight-gen
    counters do not move, and the output is the same bytes."""
    from aainterp_torch.ops import weights as t_weights

    img = np.random.default_rng(2).uniform(0, 1, (20, 20))
    inp = _write_input(tmp_path, "in.csv", img)
    cache = str(tmp_path / "opcache")
    argv = [inp, "--src-resolution", "1", "--dst-resolution", "0.5",
            "--isocenter", "10", "10", "--angle", "30", "--mode", "1",
            "--cache-dir", cache, "--device", "cpu"]
    before = dict(t_weights.WEIGHT_GEN_ENGINES)
    assert t_cli.main(argv) == 0
    first = open(tmp_path / "in_mod.csv", "rb").read()
    mid = dict(t_weights.WEIGHT_GEN_ENGINES)
    assert sum(mid.values()) == sum(before.values()) + 1
    assert any(f.endswith(".op") for f in os.listdir(cache))
    assert t_cli.main(argv) == 0
    assert dict(t_weights.WEIGHT_GEN_ENGINES) == mid
    assert open(tmp_path / "in_mod.csv", "rb").read() == first
    capsys.readouterr()


def test_prefetch_operator_fills_the_apply_caches(tmp_path):
    """prefetch_operator puts the tables into the caches the applies read
    (device='cpu' here; the card's pinned, non_blocking upload is held in
    tests/test_torch_kernel_cuda.py); the apply after it reuses them."""
    from aainterp_torch import autodiff, regrid

    _, spec, _ = _spec_pair("separable_q1")
    op = at.build_operator(spec, mode="fast")
    assert t_cache.prefetch_operator(op, device="cpu") is op
    yb, xb, _ = at.ops.weights.fold_quadrant_separable(op)
    tabs = regrid.band_tables(yb, xb)
    first = tabs.dev[torch.device("cpu")]
    x = torch.rand(3, *spec.src_shape)
    from aainterp_torch import pipeline

    got = list(pipeline.stream_apply(op, x, batch=2, device="cpu"))
    assert tabs.dev[torch.device("cpu")] is first
    ref = at.apply_operator(op, x)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)
    _, rspec, _ = _spec_pair("ell_fast")
    rop = at.build_operator(rspec, mode="fast")
    for wd in (torch.float32, torch.float64):
        t_cache.prefetch_operator(rop, device="cpu", weight_dtype=wd)
        folded, _ = at.ops.weights.fold_quadrant_ell_cached(rop)
        base, w = autodiff.ell_tables(folded, wd, torch.device("cpu"))
        assert w.dtype == wd
        assert np.array_equal(w.numpy(), folded.weights.astype(
            w.numpy().dtype))
    x = torch.rand(2, *rspec.qrot_shape[::-1], dtype=torch.float64)
    out = at.apply_operator(rop, x, weight_dtype=torch.float64)
    assert out.dtype == torch.float64
    with pytest.raises(ValueError, match="weight_dtype"):
        t_cache.prefetch_operator(rop, device="cpu",
                                  weight_dtype=torch.float16)


# ----------------------------------------------------------------------
# Shear-plan disk cache (ops.cuda_shear.kernel_plan_cached)
# ----------------------------------------------------------------------


def _plan_equal(a, b):
    for f in dataclasses.fields(cuda_shear.ShearKernelPlan):
        if f.name in ("tiles", "dev"):
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("mode", ["exact", "compat"])
def test_shear_plan_disk_cache_roundtrip(tmp_path, mode):
    spec = at.make_grid_spec((40, 40), 1.0, 0.5, (20.0, 20.0), 30.0)
    op = at.ops.weights.ell_operator(spec, mode=mode, prefer_native=False)
    d = str(tmp_path)
    fresh = cuda_shear.plan_from_operator(op)
    cuda_shear._PLAN_CACHE.clear()
    before = dict(cuda_shear.PLAN_DISK)
    built = cuda_shear.kernel_plan_cached(op, cache_dir=d)
    path = cuda_shear.plan_cache_path(op, d)
    assert os.path.basename(path).startswith(
        t_cache.spec_key(op.spec, mode, "cuda_shear_v2"))
    assert os.path.exists(path) and not [
        f for f in os.listdir(d) if f.endswith(".tmp")]
    cuda_shear._PLAN_CACHE.clear()
    loaded = cuda_shear.kernel_plan_cached(op, cache_dir=d)
    assert loaded is not built
    assert cuda_shear.PLAN_DISK == {"built": before["built"] + 1,
                                    "loaded": before["loaded"] + 1}
    _plan_equal(built, fresh)
    _plan_equal(loaded, fresh)
    # the plain 'sheared' route on the loaded plan gives the same bits
    q = torch.rand(2, 40, 40)
    assert torch.equal(cuda_shear.apply_ell_shear_plain(q, loaded),
                       cuda_shear.apply_ell_shear_plain(q, fresh))
    # another operator of the same geometry and mode (the squared one of
    # propagate_variance) does not take this plan
    sq = at.ops.weights.squared_operator(op)
    cuda_shear._PLAN_CACHE.clear()
    assert cuda_shear.load_plan(sq, d) is None
    _plan_equal(cuda_shear.kernel_plan_cached(sq, cache_dir=d),
                cuda_shear.plan_from_operator(sq))


@pytest.mark.parametrize("damage", ["garbage", "truncated", "missing_array",
                                    "wrong_shape"])
def test_corrupt_shear_plan_entry_is_rebuilt(tmp_path, damage):
    spec = at.make_grid_spec((32, 32), 1.0, 0.5, (16.0, 16.0), 20.0)
    op = at.ops.weights.ell_operator(spec, prefer_native=False)
    d = str(tmp_path)
    cuda_shear._PLAN_CACHE.clear()
    fresh = cuda_shear.kernel_plan_cached(op, cache_dir=d)
    path = cuda_shear.plan_cache_path(op, d)
    blob = open(path, "rb").read()
    if damage == "garbage":
        blob = b"not a plan" * 10
    elif damage == "truncated":
        blob = blob[: len(blob) // 2]
    else:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        if damage == "missing_array":
            del arrays["w2"]
        else:
            arrays["ry0"] = arrays["ry0"][:-1]
        np.savez(path, **arrays)
        blob = None
    if blob is not None:
        open(path, "wb").write(blob)
    cuda_shear._PLAN_CACHE.clear()
    with pytest.warns(RuntimeWarning, match="unreadable shear plan"):
        plan = cuda_shear.kernel_plan_cached(op, cache_dir=d)
    _plan_equal(plan, fresh)
    cuda_shear._PLAN_CACHE.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        _plan_equal(cuda_shear.load_plan(op, d), fresh)   # rewritten whole
