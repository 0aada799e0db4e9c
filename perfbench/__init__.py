"""The benchmark of ``aainterp_torch`` (see ``BENCHMARK.json``)."""
