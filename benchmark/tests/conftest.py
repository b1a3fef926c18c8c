"""Fixtures of the benchmark's own tests (CPU; the card test skips
where there is no card)."""

from __future__ import annotations

import contextlib
import io
import json
import os
import time

import pytest

from benchmark.tests import tiny


@pytest.fixture(scope="session")
def db_cache(tmp_path_factory):
    """One tiny database shared by the tests' runs."""
    return str(tmp_path_factory.mktemp("dbcache"))


@pytest.fixture
def bench(tmp_path, db_cache):
    return tiny.make(str(tmp_path / "bench"), db_cache)


def run_cell(bench_dir, cell, *extra, seed=3000000019, seconds=1.0,
             trace=0):
    """One tiny run on the CPU: (exit code, stdout lines, stderr lines)."""
    from benchmark import run

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace),
                       *extra], bench_dir=bench_dir, device="cpu",
                      t_start=time.perf_counter())
    return rc, out.getvalue().splitlines(), err.getvalue().splitlines()


def result(lines):
    return json.loads(lines[-1])


@pytest.fixture
def card():
    """Skips unless a CUDA card is there (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.cuda.get_device_name(0)


BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
