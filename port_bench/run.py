"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload svd-clip --seed 7 --seconds 45 \\
        --trace 0

From the root of a checkout. The cell comes from ``BENCHMARK.json``; its
configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``) and the traffic's driver
(``drivers/<driver>.py``) are found by name, and with ``--trace 1`` so is
the reader of each per-layer metric (``metrics/<metric>.py``). The driver
sets up the program (``multiview_inpaint_tpu_torch``) and its inputs
from the seed, runs the window, and compares what the window produced
with the plain reference (``reference/``). The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (and with ``--trace 1`` ``breakdown``), then
``check``, each number compared with its limit, which also close the
standard error. Without a CUDA device the run exits with code 2 and
prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(run, manifest, cell, outcome):
    """The result object, ``check`` last."""
    from port_bench.harness import device as dev
    torch = run.torch
    chips = cell["chips"]
    device = (dict(run.device_info or dev.describe(torch, chips))
              if run.cuda else
              {"platform": "cpu", "kind": "cpu", "count": 0,
               "memory_peak_bytes": 0})
    out = {"correct": bool(outcome["correct"]),
           "attempted": int(outcome["attempted"]),
           "failed": int(outcome["failed"])}
    metrics = {}
    if not run.trace:
        for m in manifest.end_to_end(cell):
            value = outcome["end_to_end"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        r = run.readings
        for m in manifest.per_layer(cell):
            value = manifest.reader(m).read(r)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if r.trace is not None:
            device["busy_s"] = r.trace.busy_s
            device["window_s"] = r.trace.window_s
    out["metrics"] = metrics
    out["device"] = device
    if run.trace and run.readings.trace is not None:
        tr = run.readings.trace
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": tr.idle_gaps}
    out["check"] = {name: {"value": value, "limit": limit}
                    for name, value, limit in run.checks}
    return out


def note(what: str) -> None:
    """A line on standard error: seconds since the process began, and
    what was just done."""
    print(f"[{time.perf_counter() - T_START:.3f} s] {what}",
          file=sys.stderr, flush=True)


def main(argv=None, device=None, manifest_path=None, bench=None):
    """One run. ``device``, ``manifest_path`` and ``bench`` (the folder
    the manifest's files are found in) are for the CPU tests: a run from
    the command line always asks for the card."""
    args = parse(argv)
    sys.path.insert(0, ROOT)
    from port_bench.harness import env
    env.prepare(ROOT)
    from port_bench.harness import loader
    manifest = loader.Manifest(
        manifest_path or os.path.join(ROOT, "BENCHMARK.json"),
        bench or BENCH)
    cell = manifest.cell(args.workload)
    config, traffic = manifest.config(cell), manifest.traffic(cell)
    driver = manifest.driver(traffic)
    import torch
    note("import torch")
    from port_bench.harness import device as dev
    from port_bench.harness.context import Run
    if device is None:
        dev.require(torch, cell["chips"])
        torch.cuda.init()
        note("CUDA initialised")
        device = "cuda"
    bad = env.loaded_forbidden()
    if bad:
        print(f"port_bench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    run = Run(torch, torch.device(device), seed=args.seed,
              seconds=args.seconds, trace=bool(args.trace), config=config,
              traffic=traffic, cell=cell, t_start=T_START)
    outcome = driver.run(run)
    bad = env.loaded_forbidden()
    if bad:
        print(f"port_bench: forbidden modules loaded after the window: "
              f"{bad}", file=sys.stderr)
        return 3
    line = result_line(run, manifest, cell, outcome)
    if run.trace:
        note("per-layer metrics read")
    for name, value, limit in run.checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(line))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    # Bytecode of every module imported from here on is kept in a fixed
    # directory of the checkout, also where the environment says not to
    # write it: where the installed packages ship none, each process
    # would compile torch's sources anew (seconds of set-up).
    sys.pycache_prefix = os.path.join(ROOT, "build", "pycache")
    sys.dont_write_bytecode = False
    sys.exit(main())
