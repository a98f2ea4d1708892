"""The harness on the CPU at tiny sizes: every cell runs through the
discovery by name and prints its result line; a cell that
exists only in a copy of the manifest runs from new files alone; a run
without a card prints no result."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from port_bench.tests.conftest import ROOT, run_cell

CELLS = ("svd-clip", "gs2m-train-1080p", "gs2m-render-1080p")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_prints_the_result_line(tiny, cell, trace):
    rc, line, err = run_cell(tiny, cell, trace)
    assert rc == 0
    keys = list(line)
    assert keys[:5] == KEYS and keys[-1] == "check"
    assert set(keys) <= set(KEYS + ["breakdown", "check"])
    assert line["attempted"] >= 1
    assert line["correct"] is True and line["failed"] == 0
    manifest = json.load(open(tiny[0]))
    cellspec = next(c for c in manifest["workloads"] if c["name"] == cell)
    if trace:
        names = {m["name"] for m in manifest["per_layer"]
                 if cell in m["workloads"]}
        assert set(line["metrics"]) <= names
        assert "busy_s" in line["device"] and "window_s" in line["device"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        names = {m["name"] for m in manifest["end_to_end"]
                 if cell in m.get("workloads", [cell])}
        assert set(line["metrics"]) == names
        assert "setup_s" in line["metrics"]
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert cellspec["chips"] == 1
    # the numbers compared close standard error, each with its limit
    tail = err.strip().splitlines()[-len(line["check"]):]
    for (name, c), text in zip(line["check"].items(), tail):
        assert text == f"check {name} {c['value']!r} limit {c['limit']!r}"


def test_a_new_cell_needs_only_new_files(tiny, tmp_path):
    """A cell added to a copy of the manifest, with a traffic file of its
    own, runs without a change to any file already there."""
    manifest, bench = tiny
    copy = tmp_path / "bench"
    shutil.copytree(bench, copy)
    with open(os.path.join(copy, "traffic", "orbit-render-1080p.json")) as f:
        traffic = json.load(f)
    traffic.update(width=32, height=32, views=3)
    with open(os.path.join(copy, "traffic", "orbit-render-small.json"),
              "w") as f:
        json.dump(traffic, f)
    data = json.load(open(manifest))
    data["workloads"].append({"name": "gs2m-render-small",
                              "config": "gs-mip360-2m",
                              "traffic": "orbit-render-small", "chips": 1,
                              "why": "a smaller frame"})
    for m in data["end_to_end"]:
        if m["name"] == "frame_ms":
            m["workloads"].append("gs2m-render-small")
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(data))
    rc, line, _ = run_cell((str(path), str(copy)), "gs2m-render-small")
    assert rc == 0 and set(line["metrics"]) == {"frame_ms", "setup_s"}


def test_no_card_no_result(tmp_path):
    """From the command line a run asks for the card; without one it
    exits non-zero and prints no result, also in a directory that holds
    only the manifest and the benchmark's folder."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "port_bench"),
                    tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (ROOT, str(tmp_path)):
        proc = subprocess.run(
            [sys.executable, "port_bench/run.py", "--workload",
             "gs2m-render-1080p", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
        assert proc.returncode != 0
        assert proc.stdout.strip() == ""


def test_memo_computes_once_per_key(tmp_path, monkeypatch):
    """A cached result is worked out by the first call of its key and
    read back by every later one; another key computes anew."""
    from port_bench.harness import cache
    monkeypatch.setattr(cache, "DIR", str(tmp_path))
    calls = []

    def compute():
        calls.append(1)
        return [["a", [2, 3]]]

    assert cache.memo("spec", {"n": 1}, compute) == [["a", [2, 3]]]
    assert cache.memo("spec", {"n": 1}, compute) == [["a", [2, 3]]]
    assert len(calls) == 1
    cache.memo("spec", {"n": 2}, compute)
    assert len(calls) == 2
