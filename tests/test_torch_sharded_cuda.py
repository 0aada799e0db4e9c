"""The port's sharded applies over NCCL, on the card: CUDA tensors go to
the collectives as they are (``aainterp_torch.parallel.mesh``).

NCCL takes one rank a card.  ``test_nccl_collectives_to_self`` runs one
rank, which sends to itself, so it runs on one card;
``test_nccl_across_cards`` runs one rank on each of ``min(4, count)``
cards at meshes (1, k) and, with four, (2, 2), and skips with fewer than
two; its ranks run kernels 1 and 2 and the rotated route's fused shear
and masked contraction per shard.  ``test_nccl_2d_one_rank`` runs the
2-D (rows x cols) sharded paths on one NCCL rank, mesh (1, 1, 1), and
``test_nccl_2d_across_four_cards`` at (1, 2, 2), one rank a card (it
skips with fewer than four).  ``test_nccl_grad_one_rank`` runs the
``make_sharded_*_linear`` gradient steps on one NCCL rank, meshes (1, 1)
and (1, 1, 1), and ``test_nccl_grad_across_four_cards`` at (1, 4) and
(1, 2, 2) (it skips with fewer than four): kernel 1 per shard on the
transposed bands, the rotated scatter and ``_halo_reduce``.  The ranks' side is
tests/torch_dist_ranks.py (tolerances there: bit equality where the
sharded and unsharded calls take one route, f32 1e-5 where they do not,
flux rtol 1e-5).

Skips without ``torch.cuda.is_available()``.  Imports no JAX, so it runs
on a machine with only PyTorch; there, skip the repo's conftest (which
sets up JAX) from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_sharded_cuda.py
"""


import pytest
import torch

import torch_dist_ranks as ranks
from aainterp_torch import _build
from aainterp_torch.parallel import mesh as pmesh

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cards(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    # kernels 1 and 2 and the rotated route's are built here, before any
    # rank starts: the ranks load the built libraries; their shear plans
    # go to a directory of the module's own (AAINTERP_CACHE_DIR, read
    # when a rank starts)
    _build.build_many([_build.SEPARABLE, _build.SEPARABLE_2D,
                       _build.ELL_SHEAR])
    mp = pytest.MonkeyPatch()
    mp.setenv("AAINTERP_CACHE_DIR", str(tmp_path_factory.mktemp("plans")))
    yield torch.cuda.device_count()
    mp.undo()


def test_nccl_collectives_to_self(cards):
    res = pmesh.run_spmd(ranks.collectives_to_self, (1, 1), backend="nccl",
                         timeout=300.0)
    assert res[0] and all(res[0].values()), res[0]


def test_nccl_across_cards(cards):
    if cards < 2:
        pytest.skip(f"needs two cards or more, one NCCL rank a card; "
                    f"{cards} here")
    k = min(4, cards)
    shapes = [(1, k)] + ([(2, 2)] if k == 4 else [])
    with pmesh.RankPool(k, backend="nccl", timeout=600.0) as pool:
        for shape in shapes:
            res = pool.run(ranks.sharded_vs_unsharded, shape)
            assert [r["bf16"]["device"] for r in res] == [
                f"cuda:{r}" for r in range(k)]
            ranks.check_sharded_vs_unsharded(res, shape, on_card=True)


def test_nccl_2d_one_rank(cards):
    res = pmesh.run_spmd(ranks.sharded_2d_vs_unsharded, (1, 1, 1),
                         backend="nccl", timeout=300.0)
    assert res[0]["bf16"]["device"] == "cuda:0"
    ranks.check_sharded_2d_vs_unsharded(res, on_card=True)


def test_nccl_2d_across_four_cards(cards):
    if cards < 4:
        pytest.skip(f"needs four cards, one NCCL rank a card; {cards} here")
    with pmesh.RankPool(4, backend="nccl", timeout=600.0) as pool:
        res = pool.run(ranks.sharded_2d_vs_unsharded, (1, 2, 2))
    assert [r["bf16"]["device"] for r in res] == [
        f"cuda:{r}" for r in range(4)]
    ranks.check_sharded_2d_vs_unsharded(res, on_card=True)


def test_nccl_grad_one_rank(cards):
    with pmesh.RankPool(1, backend="nccl", timeout=300.0) as pool:
        for shape in ((1, 1), (1, 1, 1)):
            res = pool.run(ranks.sharded_grad_vs_unsharded, shape)
            assert res[0]["bf16"]["device"] == "cuda:0"
            ranks.check_sharded_grad_vs_unsharded(res, on_card=True)


def test_nccl_grad_across_four_cards(cards):
    if cards < 4:
        pytest.skip(f"needs four cards, one NCCL rank a card; {cards} here")
    with pmesh.RankPool(4, backend="nccl", timeout=600.0) as pool:
        for shape in ((1, 4), (1, 2, 2)):
            res = pool.run(ranks.sharded_grad_vs_unsharded, shape)
            assert [r["bf16"]["device"] for r in res] == [
                f"cuda:{r}" for r in range(4)]
            ranks.check_sharded_grad_vs_unsharded(res, on_card=True)
