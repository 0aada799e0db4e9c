"""Probe kernels of the port: the H100 counterparts of the TPU probes under
``benchmarks/``, each with the entry point that runs it.

* ``copy_ceiling`` — the row-tiled copy (``csrc/probes.cu``
  ``aainterp_copy_rows``): the card's copy ceiling at a frame geometry
  (``benchmarks/copy_ceiling.py``, and rgb1024's copy probe);
* ``rot_experiments`` — the rotated route's decomposition at the rotated
  flagship: the route, its shear forms, the contraction with and without
  its dead-pixel skip and the contraction's probe modes
  (``csrc/contract.cuh`` under ``probes.cu``: noweight on the tiled form
  and the live rectangle's tiles, its first form on the direct form;
  tshare, wshare, bothshare and pipelined on the route's tiled form;
  ``benchmarks/rot_experiments.py``);
* ``band_probes`` — kernel 1's probe modes (``csrc/band_probes.cu`` on
  ``csrc/band_apply.cuh``: stage, stagey, walk2-4, u8words, u8convert1/2/4,
  xpair, xonly (on the stage ring), densex), their plain versions and byte counts, run at the
  4K flagship by ``flagship_experiments`` (bf16, f32;
  ``benchmarks/flagship_experiments.py``) and ``u8_experiments`` (u8;
  ``benchmarks/u8_experiments.py``), and at rgb1024 (24 planes of 1024^2,
  150 -> 60 dpi) by ``rgb1024_experiments`` (the copy, staging, the y
  pass, the x pass alone, a dense x operator;
  ``benchmarks/rgb1024_experiments.py``);
* ``aligned_fused_probe`` — the config-5 regrid's aligned route with its
  y -> x intermediate kept on chip (``csrc/aligned_fused.cu``) beside the
  route, the einsum and kernel 2 (``benchmarks/aligned_fused_probe.py``);
* ``mosaic_watchlist`` — the Mosaic watchlist's six probes on
  ``csrc/watchlist.cu``, each computing its JAX probe's function with the
  Hopper feature its parked design needs (TMA tile loads, 1-D bulk copies
  on an mbarrier, wgmma; ``csrc/hopper.cuh``), each reported "available"
  or "blocked" (``benchmarks/mosaic_watchlist.py``);
* ``harness`` — their timer (CUDA-graph replays on distinct inputs, CUDA
  events).

    python -m aainterp_torch.probes.copy_ceiling --H 2160 --W 3840
    python -m aainterp_torch.probes.rot_experiments --exp noweight
    python -m aainterp_torch.probes.flagship_experiments --exp stage
    python -m aainterp_torch.probes.u8_experiments --exp u8words
    python -m aainterp_torch.probes.rgb1024_experiments --exp xonly
    python -m aainterp_torch.probes.aligned_fused_probe --exp all
    python -m aainterp_torch.probes.mosaic_watchlist [--probe high_dot]

All run on the card; ``--device cpu`` runs the plain versions on the
CPU, timed on the host's clock (not a device time).
"""
