"""Fixtures of the benchmark's own tests."""

import json

import pytest

from perfbench.tests.roots import REPO, make_root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path / "bench")


@pytest.fixture(scope="session")
def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())
