"""The Mosaic watchlist on Hopper (``aainterp_torch/probes/mosaic_watchlist.py``,
``csrc/watchlist.cu`` on ``csrc/hopper.cuh``) against the JAX package's
watchlist ``benchmarks/mosaic_watchlist.py``.

On the CPU: each of JAX's six probes, run inside
``pltpu.force_tpu_interpret_mode()``, against the port's plain version on
``inputs(name)`` (JAX's arrays, drawn bit for bit): ``np.array_equal`` for
all but high_dot, which is held to |Δ| ≤ 1e-5 · max|ref| (the CPU runs
JAX's Precision.HIGH dot in full f32; the plain bf16x3 lies within 1.5e-6
of the float64 product, while TF32 and single-bf16 products fall outside
1e-5, which a test pins).  Then the entry points with ``device="cpu"``,
the default device raising without a GPU, the wrappers taking their plain
versions on CPU tensors, and the build hashing ``hopper.cuh``.

On the card (marker ``cuda``, skipped here; imports no JAX, so it runs
with ``--noconftest -m cuda``): each kernel against its plain version into
NaN-filled outputs at JAX's shapes and at other shapes per probe —
strided_y_bf16 (one block per box of one row x 256 columns) at every
parity and frame of a ragged (3, 20, 3, 264) x, for R = 1 .. 20, and at
C = 8; strided_load (one block per window of 4 rows x 256 columns) with
several blocks each way, R = 1, R not a multiple of 4, W / 2 not a
multiple of 4 (odd rows of out not 16-byte aligned, a last group of 2
columns) and W under one window; value_slice on ragged tiles,
unaligned_dma at JAX's shape (16 rows x 8 pieces), at other row offsets
and counts, on narrow rows and on one row beyond the shared-memory
opt-in, high_dot with a ≠ b (64 x 32 tiles, K through a four-stage TMA
ring) on a 4 x 12 grid of tiles, at K 16 (one chunk, half out of bounds)
and 224, on ragged tiles (100 x 36 @ 36 x 68: zeros past every edge) and
at K 1000 (32 chunks of the ring), vpu_dyn_rows with shuffled offsets
(``arange`` hides an index slip), and at JAX's shape on 8 seeds, at C =
250 and 3 (the scalar path), 4096 (16 column blocks), R = 1 and 40, with
repeated and out-of-range offsets (NaN rows), into NaN-filled and
misaligned outputs — ``mw.equal`` (bit for bit), or the high_dot
tolerance, and one launch per call.  The programmatic launches
(value_slice, vpu_dyn_rows) read inputs that a PyTorch kernel wrote just
before each of 50 launches, and keep their programmatic edges through
graph capture; each probe's launch floor launches.  strided_y_bf16 and strided_load
write 16-byte stores: an ``out`` that is not 16-byte aligned raises
before any launch, on the CPU too.
"""

import dataclasses

import numpy as np
import pytest
import torch

from aainterp_torch import _build
from aainterp_torch.probes import mosaic_watchlist as mw

NAMES = mw.NAMES


@pytest.fixture(scope="module")
def jw():
    """JAX's watchlist and the interpret-mode switch (imported here, so the
    card's run, which has no JAX, never imports them)."""
    from jax.experimental.pallas import tpu as pltpu

    from benchmarks import mosaic_watchlist

    return mosaic_watchlist, pltpu


def _jax(jw, name: str) -> np.ndarray:
    module, pltpu = jw
    fn = {n: f for n, f, _ in module.PROBES}[name]
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn())


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_jax_probe(jw, name):
    want = _jax(jw, name)
    got = getattr(mw, f"{name}_plain")(*mw.inputs(name)).numpy()
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    if name == "high_dot":
        assert _rel(got, want) <= mw.HIGH_DOT_RTOL
    else:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_inputs_are_jax_draws(name):
    import jax.numpy as jnp

    args = mw.inputs(name)
    shape = mw.SHAPES[name]
    x = np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)
    if name == "strided_y_bf16":
        want = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        assert args[0].dtype == torch.bfloat16
        assert np.array_equal(args[0].float().numpy().view(np.uint32),
                              want.view(np.uint32))
    else:
        assert np.array_equal(args[0].numpy().view(np.uint32),
                              x.view(np.uint32))
    if name == "high_dot":
        assert args[1] is args[0]
    if name == "vpu_dyn_rows":
        assert args[1].dtype == torch.int32
        assert np.array_equal(args[1].numpy(), np.arange(16))
    other = mw.inputs(name, seed=3)
    assert not torch.equal(other[0], args[0])


def test_shuffled_offsets_stay_in_range():
    x, off = mw.inputs("vpu_dyn_rows", seed=5)
    o = off.numpy()
    assert len(set(o.tolist())) == 16 and o.min() >= 0
    assert o.max() <= x.shape[0] - 2
    assert not np.array_equal(o, np.sort(o))


def _tf32(a: np.ndarray) -> np.ndarray:
    """f32 rounded to TF32's 10 mantissa bits, to nearest even."""
    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0xFFF + ((u >> 13) & 1)) & ~np.uint64(0x1FFF)
    return u.astype(np.uint32).view(np.float32)


def test_high_dot_tolerance_separates_bf16x3_from_tf32_and_bf16():
    a = mw.inputs("high_dot")[0]
    exact = a.double().numpy() @ a.double().numpy()
    bf16x3 = mw.high_dot_plain(a, a).numpy()
    t = _tf32(a.numpy()).astype(np.float64)
    tf32 = (t @ t).astype(np.float32)
    h = a.to(torch.bfloat16).double().numpy()
    bf16 = (h @ h).astype(np.float32)
    assert _rel(bf16x3, exact) < 3e-6
    assert _rel(tf32, exact) > mw.HIGH_DOT_RTOL
    assert _rel(bf16, exact) > mw.HIGH_DOT_RTOL
    # the split is exact where it should be: hi + lo carries 16 bits
    hi, lo = mw.bf16x3_split(a)
    assert float((hi.double() + lo.double() - a.double()).abs().max()) \
        <= 2.0 ** -17


def test_run_watchlist_on_cpu(capsys):
    res = mw.run_watchlist(device="cpu")
    assert set(res) == set(NAMES)
    assert all(status == "plain" for status, _ in res.values())
    out = capsys.readouterr().out
    assert "# device: cpu" in out and all(n in out for n in NAMES)


def test_entry_point_main_and_default_device(capsys):
    before = dict(mw.LAUNCHES)
    assert mw.main(["--device", "cpu", "--probe", "value_slice"]) == 0
    out = capsys.readouterr().out
    assert "value_slice      plain" in out
    assert "host's clock, not a device time" in out
    assert mw.LAUNCHES == before
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mw.run_watchlist()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mw.measure("high_dot")
    assert mw.main([]) == 2
    assert "device='cpu'" in capsys.readouterr().err


def test_main_runs_every_probe_on_cpu(capsys):
    assert mw.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for name in NAMES:
        assert f"{name}: kernel " in out


@pytest.mark.parametrize("name", NAMES)
def test_kernels_take_their_plain_versions_on_cpu(name):
    kernel, plain = getattr(mw, f"{name}_kernel"), getattr(mw, f"{name}_plain")
    args = mw.inputs(name, seed=2)
    before = dict(mw.LAUNCHES)
    want = plain(*args)
    got = kernel(*args)
    assert torch.equal(got, want)
    buf = torch.full_like(want, float("nan"))
    assert kernel(*args, out=buf) is buf and torch.equal(buf, want)
    assert mw.LAUNCHES == before


@pytest.mark.parametrize("name", NAMES)
def test_measure_on_cpu(name):
    r = mw.measure(name, "cpu", n=2)
    assert r["probe"] == name and r["clock"] == "host" and r["device"] == "cpu"
    assert min(r["kernel_ms"], r["plain_ms"], r["library_ms"]) > 0
    assert (r["bytes"], r["operations"]) == mw.traffic(
        name, mw.inputs(name, seed=1))


def test_library_calls_compute_the_probes():
    x = mw.inputs("value_slice")[0]
    assert torch.equal(mw.LIBRARY["value_slice"](x), mw.value_slice_plain(x))
    x, off = mw.inputs("vpu_dyn_rows", seed=4)
    assert torch.equal(mw.LIBRARY["vpu_dyn_rows"](x, off),
                       mw.vpu_dyn_rows_plain(x, off))
    a, b = (mw.inputs("high_dot", seed=s)[0] for s in (1, 2))
    assert _rel(mw.LIBRARY["high_dot"](a, b).numpy(),
                mw.high_dot_plain(a, b).numpy()) <= mw.HIGH_DOT_RTOL
    assert set(mw.LIBRARY) | {"strided_y_bf16", "strided_load",
                              "unaligned_dma"} == set(NAMES)


def test_traffic():
    assert mw.traffic("strided_y_bf16", mw.inputs("strided_y_bf16")) == (
        16 * 256 * 6, 0)
    assert mw.traffic("strided_load", mw.inputs("strided_load")) == (
        120 * 3840 * 4 + 120 * 1920 * 4, 0)
    assert mw.traffic("value_slice", mw.inputs("value_slice")) == (
        8 * 512 * 4 + 8 * 256 * 4, 8 * 256)
    assert mw.traffic("unaligned_dma", mw.inputs("unaligned_dma")) == (
        2 * 16 * 3600 * 4, 0)
    a = mw.inputs("high_dot")[0]
    # high_dot: its three bf16 products on the tensor cores
    assert mw.traffic("high_dot", (a, a)) == (2 * 128 * 128 * 4,
                                              3 * 2 * 128 ** 3)
    assert mw.TENSOR_CORE_BF16 == ("high_dot",)
    assert mw.traffic("high_dot", (a, a.clone()))[0] == 3 * 128 * 128 * 4
    # arange(16): rows 0..16 read, 17 of them
    assert mw.traffic("vpu_dyn_rows", mw.inputs("vpu_dyn_rows")) == (
        17 * 256 * 4 + 16 * 4 + 16 * 256 * 4, 16 * 256)


def test_kernels_reject_what_they_cannot_take():
    x = mw.inputs("strided_y_bf16")[0]
    with pytest.raises(ValueError, match="bfloat16"):
        mw.strided_y_bf16_kernel(x.float())
    with pytest.raises(ValueError, match="outside"):
        mw.strided_y_bf16_kernel(x, parity=2)
    with pytest.raises(ValueError, match="outside"):
        mw.strided_y_bf16_kernel(x, rows=33)
    with pytest.raises(ValueError, match="float32"):
        mw.strided_load_kernel(torch.zeros(4, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="2-D"):
        mw.value_slice_kernel(torch.zeros(2, 4, 8))
    x = mw.inputs("unaligned_dma")[0]
    with pytest.raises(ValueError, match="outside"):
        mw.unaligned_dma_kernel(x, 60, 16)
    with pytest.raises(ValueError, match=r"@ b"):
        mw.high_dot_kernel(torch.zeros(128, 64), torch.zeros(32, 128))
    x, off = mw.inputs("vpu_dyn_rows")
    with pytest.raises(ValueError, match="int32"):
        mw.vpu_dyn_rows_kernel(x, off.long())
    with pytest.raises(ValueError, match="different devices"):
        mw.vpu_dyn_rows_kernel(x, off.to("meta"))
    with pytest.raises(ValueError, match="no probe"):
        mw.inputs("strided")
    with pytest.raises(ValueError, match="out must be"):
        mw.value_slice_kernel(mw.inputs("value_slice")[0],
                              out=torch.empty(8, 255))
    with pytest.raises(ValueError, match="16-byte aligned"):
        mw.strided_load_kernel(torch.zeros(4, 8),
                               out=torch.empty(17)[1:].view(4, 4))
    with pytest.raises(ValueError, match="16-byte aligned"):
        mw.strided_y_bf16_kernel(torch.zeros(1, 4, 2, 8, dtype=torch.bfloat16),
                                 rows=2, out=torch.empty(17)[1:].view(2, 8))


@pytest.mark.parametrize("name", ["strided_y_bf16", "strided_load"])
@pytest.mark.parametrize("shift", [1, 2, 3])
def test_strided_kernels_need_a_16_byte_aligned_out(name, shift):
    # their 16-byte stores: an out 4, 8 or 12 bytes past a 16-byte boundary
    # raises before any launch, on CPU tensors too; an aligned one is taken
    kernel, plain = getattr(mw, f"{name}_kernel"), getattr(mw, f"{name}_plain")
    args = mw.inputs(name, seed=shift)
    want = plain(*args)
    flat = torch.full((want.numel() + 4,), float("nan"))
    assert flat.data_ptr() % 16 == 0
    before = dict(mw.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernel(*args, out=flat[shift:shift + want.numel()].view(want.shape))
    assert mw.LAUNCHES == before
    out = flat[4:].view(want.shape)
    assert kernel(*args, out=out) is out and torch.equal(out, want)


@pytest.mark.parametrize("shape", [(128, 30, 128), (128, 32, 66)],
                         ids=["k30", "n66"])
def test_high_dot_limits_raise_before_any_launch(shape):
    # K and N must be multiples of 4 (the tensor maps' 16-byte row
    # strides), checked on CPU tensors too, before any launch
    M, K, N = shape
    before = dict(mw.LAUNCHES)
    with pytest.raises(ValueError, match="multiples of 4"):
        mw.high_dot_kernel(torch.zeros(M, K), torch.zeros(K, N))
    assert mw.LAUNCHES == before


@pytest.mark.parametrize("shape", [(100, 36, 68), (64, 1000, 32),
                                   (1, 4, 4)], ids=["ragged", "k1000", "one"])
def test_high_dot_takes_any_m_and_k_n_multiples_of_4(shape):
    # the tile no longer limits the shape: any M, K beyond one chunk's
    # worth; on the CPU the wrapper takes the plain version
    M, K, N = shape
    a = torch.from_numpy(np.random.default_rng(M).uniform(
        -1, 1, (M, K)).astype(np.float32))
    b = torch.from_numpy(np.random.default_rng(N).uniform(
        0, 1, (K, N)).astype(np.float32))
    got = mw.high_dot_kernel(a, b)
    assert got.shape == (M, N) and torch.equal(got, mw.high_dot_plain(a, b))
    assert _rel(got.numpy(), (a.double() @ b.double()).numpy()) \
        <= mw.HIGH_DOT_RTOL


def test_build_hashes_hopper_header(tmp_path):
    lib = _build.WATCHLIST
    assert lib.compiler == "nvcc" and lib.flags == _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in lib.flags
    names = {h.name for h in lib.headers}
    assert {"hopper.cuh", "stage_common.cuh"} <= names
    assert all(h.exists() for h in lib.headers)
    copy = tmp_path / "hopper.cuh"
    copy.write_bytes((lib.source.parent / "hopper.cuh").read_bytes())
    other = tuple(copy if h.name == "hopper.cuh" else h for h in lib.headers)
    moved = dataclasses.replace(lib, headers=other)
    assert _build.library_path(moved) == _build.library_path(lib)
    copy.write_bytes(copy.read_bytes() + b"\n// changed\n")
    assert _build.library_path(moved) != _build.library_path(lib)
    symbols = {s for s, _, _ in lib.symbols}
    assert symbols == {f"aainterp_{n}" for n in NAMES} | {
        "aainterp_watchlist_floor", "aainterp_graph_edges"}


def test_vpu_dyn_rows_plain_gives_nan_rows_out_of_range():
    # the kernel's function: NaN rows for offsets outside [0, rows - 2]
    # (-1 and rows wrap or raise under plain indexing), x[o] + x[o + 1]
    # elsewhere, bit for bit
    x = mw.inputs("vpu_dyn_rows", seed=6)[0]
    rows = x.shape[0]
    off = torch.tensor([3, -1, rows - 1, rows, 0, rows - 2, 3, -70],
                       dtype=torch.int32)
    got = mw.vpu_dyn_rows_plain(x, off)
    assert got.shape == (8, x.shape[1]) and got.dtype == torch.float32
    bad = [1, 2, 3, 7]
    assert bool(torch.isnan(got[bad]).all())
    assert np.array_equal(got[bad].numpy().view(np.uint32),
                          np.full((4, x.shape[1]), 0x7FC00000, np.uint32))
    for i, o in ((0, 3), (4, 0), (5, rows - 2), (6, 3)):
        assert torch.equal(got[i], x[o] + x[o + 1])
    assert not bool(torch.isnan(got[[0, 4, 5, 6]]).any())


@pytest.mark.parametrize("bad", ["minus_one", "rows_minus_one", "rows"])
def test_vpu_dyn_rows_wrapper_on_cpu_nan_row(bad):
    x = mw.inputs("vpu_dyn_rows", seed=7)[0]
    o = {"minus_one": -1, "rows_minus_one": x.shape[0] - 1,
         "rows": x.shape[0]}[bad]
    off = torch.tensor([5, o, 9], dtype=torch.int32)
    before = dict(mw.LAUNCHES)
    buf = torch.zeros(3, x.shape[1])
    got = mw.vpu_dyn_rows_kernel(x, off, out=buf)
    assert got is buf and mw.LAUNCHES == before
    assert bool(torch.isnan(got[1]).all())
    assert torch.equal(got[0], x[5] + x[6]) and torch.equal(got[2],
                                                           x[9] + x[10])
    assert mw.equal("vpu_dyn_rows", got, mw.vpu_dyn_rows_plain(x, off))


def test_equal_is_bit_for_bit():
    x, off = mw.inputs("vpu_dyn_rows", seed=8)
    off[2] = -1
    want = mw.vpu_dyn_rows_plain(x, off)
    # NaN rows compare equal bit for bit, where torch.equal says no
    assert not torch.equal(want, want.clone())
    assert mw.equal("vpu_dyn_rows", want.clone(), want)
    one_ulp = want.clone()
    one_ulp[0, 0] = torch.nextafter(one_ulp[0, 0], torch.tensor(2.0))
    assert not mw.equal("vpu_dyn_rows", one_ulp, want)
    assert not mw.equal("vpu_dyn_rows", want[:3], want)
    assert not mw.equal("vpu_dyn_rows", want.double(), want)


def test_traffic_counts_the_rows_live_offsets_read():
    x = mw.inputs("vpu_dyn_rows")[0]
    off = torch.tensor([0, 0, -1, 63, 64, 5], dtype=torch.int32)
    # rows 0, 1, 5, 6: NaN rows read nothing
    assert mw.traffic("vpu_dyn_rows", (x, off)) == (
        4 * 256 * 4 + 6 * 4 + 6 * 256 * 4, 6 * 256)


@pytest.mark.parametrize("name", NAMES)
def test_measure_on_cpu_has_no_floor(name):
    # nothing launches on the CPU: no floor, and no floor launch
    before = dict(mw.FLOOR_LAUNCHES)
    r = mw.measure(name, "cpu", n=1)
    assert "floor_ms" in r and r["floor_ms"] is None
    assert mw.FLOOR_LAUNCHES == before


def test_floor_dims_follow_the_wrappers():
    dims = {name: mw.floor_dims(name, mw.inputs(name)) for name in NAMES}
    assert dims == {"strided_y_bf16": (16, 256), "strided_load": (120, 3840),
                    "value_slice": (8, 512), "unaligned_dma": (16, 3600),
                    "high_dot": (128, 128), "vpu_dyn_rows": (16, 256)}
    x = mw.inputs("strided_y_bf16")[0]
    assert mw.floor_dims("strided_y_bf16", (x, 0, 1, 7)) == (7, 256)
    x = mw.inputs("unaligned_dma")[0]
    assert mw.floor_dims("unaligned_dma", (x, 2, 5)) == (5, 3600)
    assert mw.floor_dims("high_dot", (torch.zeros(100, 36),
                                      torch.zeros(36, 68))) == (100, 68)
    with pytest.raises(ValueError, match="no probe"):
        mw.floor_dims("strided", (x,))


def test_launch_floor_needs_cuda_tensors():
    before = dict(mw.FLOOR_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mw.launch_floor("value_slice", *mw.inputs("value_slice"))
    assert mw.FLOOR_LAUNCHES == before


def test_probe_ids_follow_the_source_enum():
    # the floor entry numbers the probes as csrc/watchlist.cu's enum Probe
    import re

    text = _build.WATCHLIST.source.read_text()
    body = re.search(r"enum Probe \{([^}]*)\}", text).group(1)
    names = [n.strip() for n in body.split(",")]
    assert names == ["kStridedY", "kStridedLoad", "kValueSlice",
                     "kUnalignedDma", "kHighDot", "kDynRows", "kProbes"]
    assert [mw.PROBE_IDS[n] for n in NAMES] == list(range(6))
    assert set(mw.PROGRAMMATIC) <= set(NAMES)


def test_probes_name_their_features():
    assert tuple(p[0] for p in mw.PROBES) == NAMES
    for name, kernel, plain, feature, design in mw.PROBES:
        assert kernel is getattr(mw, f"{name}_kernel")
        assert plain is getattr(mw, f"{name}_plain")
        assert feature and design
        # no TPU time in the port's strings
        assert "us/frame" not in feature + design
        assert " us" not in feature + design


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    # TF32 off for this test only (restored after it)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda:0")


def _held(name, kernel, plain, args):
    want = plain(*args)
    buf = torch.full_like(want, float("nan"))
    before = mw.LAUNCHES[name]
    got = kernel(*args, out=buf)
    torch.cuda.synchronize()
    assert got is buf and mw.LAUNCHES[name] == before + 1
    assert mw.equal(name, got, want), (
        f"{name}: max |diff| "
        f"{float((got.double() - want.double()).abs().max())}")
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_matches_plain_at_jax_shapes(cuda, name, seed):
    _, kernel, plain, _, _ = mw.probe(name)
    _held(name, kernel, plain, mw.inputs(name, cuda, seed))


def _uniform(shape, seed, device, dtype=torch.float32):
    x = np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


@pytest.mark.cuda
def test_strided_y_other_parity_frame_and_ragged_boxes(cuda):
    x = _uniform((3, 100, 2, 264), 7, cuda, torch.bfloat16)
    _held("strided_y_bf16", mw.strided_y_bf16_kernel, mw.strided_y_bf16_plain,
          (x, 2, 0, 90))
    _held("strided_y_bf16", mw.strided_y_bf16_kernel, mw.strided_y_bf16_plain,
          (x, 1, 1, 100))


@pytest.mark.cuda
@pytest.mark.parametrize("frame", [0, 1, 2])
@pytest.mark.parametrize("parity", [0, 1, 2])
def test_strided_y_every_parity_frame_and_row_count(cuda, frame, parity):
    # one block per box of one row x 256 columns: C = 264 takes two column
    # blocks (256 + 8), R = 1 .. 20 one to twenty row blocks
    x = _uniform((3, 20, 3, 264), 14 + 3 * frame + parity, cuda,
                 torch.bfloat16)
    for rows in range(1, 21):
        _held("strided_y_bf16", mw.strided_y_bf16_kernel,
              mw.strided_y_bf16_plain, (x, frame, parity, rows))
    x = _uniform((2, 5, 2, 8), 15, cuda, torch.bfloat16)   # C = 8: 2 groups
    _held("strided_y_bf16", mw.strided_y_bf16_kernel, mw.strided_y_bf16_plain,
          (x, frame % 2, parity % 2, 5))


@pytest.mark.cuda
def test_strided_load_and_value_slice_ragged(cuda):
    x = _uniform((70, 600), 8, cuda)
    _held("strided_load", mw.strided_load_kernel, mw.strided_load_plain, (x,))
    x = _uniform((5, 36), 9, cuda)
    _held("value_slice", mw.value_slice_kernel, mw.value_slice_plain, (x,))
    _held("strided_load", mw.strided_load_kernel, mw.strided_load_plain, (x,))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(120, 3840), (70, 600), (1, 3840),
                                   (9, 3844), (13, 12), (1, 4), (17, 520),
                                   (33, 1028)],
                         ids=["jax", "blocks_each_way", "one_row",
                              "half_not_4", "under_one_window", "one_pair",
                              "last_window_8", "rows_33_half_not_4"])
def test_strided_load_windows(cuda, shape):
    # windows of 4 rows x 256 columns: R not a multiple of 4 and R = 1; W /
    # 2 not a multiple of 4 (3844, 12, 4, 1028: odd rows of out are not
    # 16-byte aligned, a row's last group holds 2 columns); W under one
    # window; a last window of 8 columns
    x = _uniform(shape, shape[0] + shape[1], cuda)
    _held("strided_load", mw.strided_load_kernel, mw.strided_load_plain, (x,))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(5, 11, 1004), (3, 20, 3600),
                                  (8, 16, 3600), (0, 64, 3600),
                                  (2, 7, 36), (1, 1, 60000)],
                         ids=["offset5", "twenty_rows", "jax_shape",
                              "all_rows", "narrow_odd_rows", "wide_row"])
def test_unaligned_dma_offsets_and_blocks(cuda, case):
    # rows cut into pieces of whole 16-byte chunks of at most 2 KB, one
    # block a piece: 3600 f32 in 8 pieces (7 of 113 chunks, one of 109),
    # 1004 f32 in 2 (126 + 125), 36 f32 in one, 60,000 f32 (240,000 bytes,
    # beyond the shared-memory opt-in) in 118
    start, rows, W = case
    x = _uniform((64, W), 10, cuda)
    _held("unaligned_dma", mw.unaligned_dma_kernel, mw.unaligned_dma_plain,
          (x, start, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 128, 128), (256, 64, 384),
                                   (128, 224, 128), (128, 16, 256),
                                   (100, 36, 68), (64, 1000, 32)],
                         ids=["jax", "2x3_tiles", "k224", "k16", "ragged",
                              "k1000"])
def test_high_dot_with_a_not_b(cuda, shape):
    M, K, N = shape
    a = _uniform((M, K), 11, cuda) - 0.25
    b = _uniform((K, N), 12, cuda)
    got = _held("high_dot", mw.high_dot_kernel, mw.high_dot_plain, (a, b))
    # a transposed operand or a swapped fragment cannot pass
    if M == N == K:
        assert not mw.equal("high_dot", got, mw.high_dot_plain(a.T.contiguous(),
                                                               b))
        assert not mw.equal("high_dot", got.T.contiguous(),
                            mw.high_dot_plain(a, b))


@pytest.mark.cuda
def test_vpu_dyn_rows_shuffled_offsets(cuda):
    x, off = mw.inputs("vpu_dyn_rows", cuda, seed=3)
    assert not torch.equal(off.cpu(), torch.arange(16, dtype=torch.int32))
    _held("vpu_dyn_rows", mw.vpu_dyn_rows_kernel, mw.vpu_dyn_rows_plain,
          (x, off))
    x = _uniform((50, 300), 13, cuda)
    off = torch.tensor([48, 0, 17, 3, 3, 30], dtype=torch.int32, device=cuda)
    _held("vpu_dyn_rows", mw.vpu_dyn_rows_kernel, mw.vpu_dyn_rows_plain,
          (x, off))
    bad = torch.tensor([49, -1, 2], dtype=torch.int32, device=cuda)
    got = mw.vpu_dyn_rows_kernel(x, bad)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[:2]).all())
    assert torch.equal(got[2], x[2] + x[3])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(1, 9))
def test_vpu_dyn_rows_at_jax_shape_eight_seeds(cuda, seed):
    # one block a row and 256 columns: 16 blocks at JAX's (64, 256)
    x, off = mw.inputs("vpu_dyn_rows", cuda, seed)
    _held("vpu_dyn_rows", mw.vpu_dyn_rows_kernel, mw.vpu_dyn_rows_plain,
          (x, off))


# (rows, C, offsets): C = 250 and 3 take the scalar path, 4096 16 column
# blocks; R = 1 and 40; repeated offsets, and out-of-range ones (NaN rows)
DYN_CASES = {
    "c250": (64, 250, [5, 62, 0, 5, 31, -1, 63, 64, 17]),
    "c3": (10, 3, [8, 0, 4, 4, 9, -2]),
    "c4096": (64, 4096, [62, 0, 33, 33, 7, 63, -1, 200, 12, 1, 2, 3]),
    "r1": (64, 256, [40]),
    "r40": (64, 256, [(7 * i) % 70 - 3 for i in range(40)]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True],
                         ids=["nan_out", "misaligned_out"])
@pytest.mark.parametrize("case", sorted(DYN_CASES))
def test_vpu_dyn_rows_shapes_offsets_and_outputs(cuda, case, misaligned):
    rows, C, offs = DYN_CASES[case]
    x = _uniform((rows, C), rows + C, cuda)
    off = torch.tensor(offs, dtype=torch.int32, device=cuda)
    want = mw.vpu_dyn_rows_plain(x, off)
    flat = torch.full((want.numel() + 4,), float("nan"), device=cuda)
    shift = 1 if misaligned else 0    # 4 bytes past 16: the scalar path
    buf = flat[shift:shift + want.numel()].view(want.shape)
    before = mw.LAUNCHES["vpu_dyn_rows"]
    got = mw.vpu_dyn_rows_kernel(x, off, out=buf)
    torch.cuda.synchronize()
    assert got is buf and mw.LAUNCHES["vpu_dyn_rows"] == before + 1
    assert mw.equal("vpu_dyn_rows", got, want)
    bad = [i for i, o in enumerate(offs) if not 0 <= o <= rows - 2]
    assert bool(torch.isnan(got[bad]).all()) if bad else True


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["value_slice", "vpu_dyn_rows"])
def test_programmatic_launch_reads_what_the_op_before_wrote(cuda, name):
    # a PyTorch kernel (a float64 -> float32 copy) writes the input right
    # before each of 50 launches: the kernel waits for it before its first
    # read
    assert name in mw.PROGRAMMATIC
    _, kernel, plain, _, _ = mw.probe(name)
    args = mw.inputs(name, cuda, 1)
    for i in range(50):
        src = mw.inputs(name, cuda, 100 + i)
        for a, b in zip(args, src):
            a.copy_(b.double() if a.is_floating_point() else b.long())
        before = mw.LAUNCHES[name]
        got = kernel(*args)
        assert mw.LAUNCHES[name] == before + 1
        want = plain(*src)
        torch.cuda.synchronize()
        assert mw.equal(name, got, want), f"{name}: launch {i}"


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_graph_capture_keeps_programmatic_edges(cuda, name):
    prog, total = mw.programmatic_edges(name, cuda, n=8)
    assert total == 7     # a chain of 8 kernels
    assert prog == (7 if name in mw.PROGRAMMATIC else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_launch_floor_launches(cuda, name):
    args = mw.inputs(name, cuda, 0)
    before, launches = mw.FLOOR_LAUNCHES[name], dict(mw.LAUNCHES)
    assert mw.launch_floor(name, *args) is None
    torch.cuda.synchronize()
    assert mw.FLOOR_LAUNCHES[name] == before + 1
    assert mw.LAUNCHES == launches


@pytest.mark.cuda
def test_run_watchlist_on_the_card(cuda):
    res = mw.run_watchlist(cuda, verbose=False)
    assert res == {name: ("available", "") for name in NAMES}


@pytest.mark.cuda
def test_kernels_raise_on_shapes_they_cannot_take(cuda):
    with pytest.raises(ValueError, match="multiple of 8"):
        mw.strided_y_bf16_kernel(torch.zeros(1, 4, 2, 12, dtype=torch.bfloat16,
                                             device=cuda), rows=2)
    # the tensor maps' 16-byte row strides: K and N multiples of 4
    with pytest.raises(ValueError, match="multiples of 4"):
        mw.high_dot_kernel(torch.zeros(64, 30, device=cuda),
                           torch.zeros(30, 128, device=cuda))
    with pytest.raises(ValueError, match="multiples of 4"):
        mw.high_dot_kernel(torch.zeros(128, 240, device=cuda),
                           torch.zeros(240, 130, device=cuda))
    with pytest.raises(ValueError, match="multiple of 4"):
        # rows of 30 f32 (120 bytes) are not whole 16-byte chunks
        mw.unaligned_dma_kernel(torch.zeros(2, 30, device=cuda), 0, 1)
    # 16-byte stores: an out 4 bytes past a 16-byte boundary, before any
    # launch
    before = dict(mw.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte aligned"):
        mw.strided_load_kernel(torch.zeros(4, 8, device=cuda),
                               out=torch.empty(17, device=cuda)[1:].view(4, 4))
    with pytest.raises(ValueError, match="16-byte aligned"):
        mw.strided_y_bf16_kernel(
            torch.zeros(1, 4, 2, 8, dtype=torch.bfloat16, device=cuda), rows=2,
            out=torch.empty(17, device=cuda)[1:].view(2, 8))
    assert mw.LAUNCHES == before
