"""Multi-GPU parallelism: row sharding with a ring halo exchange, on
``torch.distributed`` (counterpart of ``aainterp/parallel``).

* ``mesh`` — the ``("data", "rows")`` device mesh, a rank's block of a
  batch (``shard_rows``, ``gather_rows``), the staged collectives and the
  rank processes (``RankPool``, ``run_spmd``);
* ``sharding`` — the row-sharded separable apply (plain, and on kernel 1
  per shard) and rotated (ELL) apply (plain gather, and the fused shear
  and the masked contraction per shard), their ring halo and the
  quadrant fold under sharding;
* ``conserve`` — the global conservation flux: local float64 dots, then
  one ``all_reduce``.

1-D (data x rows) meshes and the forward applies only; 2-D meshes and
the transposes are not ported yet (ROADMAP.md, Queue 1).
"""
