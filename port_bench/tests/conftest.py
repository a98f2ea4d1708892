"""Fixtures of the benchmark's CPU tests: one intra-op thread, and a
scratch copy of the benchmark at tiny sizes."""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True)
def one_thread():
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    from port_bench.tests.tiny import tiny_bench
    return tiny_bench(str(tmp_path_factory.mktemp("bench")))


def run_cell(tiny, cell, trace=0, seed=3000000123, seconds=0.3):
    """(exit code, the last stdout line as a dict or None, stderr) of one
    run of ``cell`` on the CPU at tiny sizes."""
    from port_bench import run as runmod
    manifest, bench = tiny
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = runmod.main(["--workload", cell, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", str(trace)],
                         device="cpu", manifest_path=manifest, bench=bench)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
