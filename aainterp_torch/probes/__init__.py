"""Probe kernels of the port: the H100 counterparts of the TPU probes under
``benchmarks/``, each with the entry point that runs it.

* ``copy_ceiling`` — the row-tiled copy (``csrc/probes.cu``
  ``aainterp_copy_rows``): the card's copy ceiling at a frame geometry
  (``benchmarks/copy_ceiling.py``, and rgb1024's copy probe);
* ``rot_experiments`` — the rotated route's decomposition at the rotated
  flagship: the route, its shear forms, the contraction and the
  contraction's probe modes (``csrc/contract.cuh`` under ``probes.cu``:
  noweight, tshare, wshare, bothshare, pipelined;
  ``benchmarks/rot_experiments.py``);
* ``harness`` — their timer (CUDA-graph replays on distinct inputs, CUDA
  events).

    python -m aainterp_torch.probes.copy_ceiling --H 2160 --W 3840
    python -m aainterp_torch.probes.rot_experiments --exp noweight

Both run on the card; ``--device cpu`` runs the plain versions on the
CPU, timed on the host's clock (not a device time).
"""
