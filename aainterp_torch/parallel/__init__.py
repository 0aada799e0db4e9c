"""Multi-GPU parallelism: row sharding and 2-D (rows x cols) sharding
with a ring halo exchange, on ``torch.distributed`` (counterpart of
``aainterp/parallel``).

* ``mesh`` — the ``("data", "rows")`` and ``("data", "rows", "cols")``
  device meshes, a rank's block of a batch (``shard_rows`` /
  ``gather_rows``, ``shard_blocks`` / ``gather_blocks``), the staged
  collectives and the rank processes (``RankPool``, ``run_spmd``);
* ``sharding`` — the sharded separable apply (plain, and on kernel 1 per
  shard) and rotated (ELL) apply (plain gather, and the fused shear and
  the masked contraction per shard), row-sharded and ``_2d``, their ring
  halos and the quadrant folds under sharding; their transposes (kernel 1
  per shard on the transposed bands; the ELL scatter per shard and the
  reverse ring, ``_halo_reduce``) and the ``make_sharded_*_linear``
  autograd wrappers;
* ``conserve`` — the global conservation flux: local float64 dots, then
  one ``all_reduce``;
* ``dryrun`` — ``dryrun_multichip(n)``: one step of every sharded path,
  gradients included, over n gloo ranks on the CPU at tiny shapes.
"""
