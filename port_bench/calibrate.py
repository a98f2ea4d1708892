"""Readings that the check's limits are set from, on the chip at a
cell's own sizes: for each seed, in one process, what the cell's driver
gives from its ``calibrate(run)``: the number(s) the cell compares for
the program, for the control (the reference computed one precision below
what the configuration states, put in the program's place) and, for a
training cell, for the program with half of its batch left out.

    python3 port_bench/calibrate.py --workload svd-clip --seeds 1,2,3

Prints one JSON line per seed; nothing here runs in the benchmark's own
runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from port_bench.harness import env, loader
    env.prepare(ROOT)
    manifest = loader.Manifest(os.path.join(ROOT, "BENCHMARK.json"))
    cell = manifest.cell(args.workload)
    config, traffic = manifest.config(cell), manifest.traffic(cell)
    import time

    import torch

    from port_bench.harness import device as dev
    from port_bench.harness.context import Run
    dev.require(torch, cell["chips"])
    driver = manifest.driver(traffic)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = Run(torch, torch.device("cuda"), seed=seed, seconds=0,
                  trace=False, config=config, traffic=traffic, cell=cell,
                  t_start=t0)
        out = driver.calibrate(run)
        run.close_program()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "card": torch.cuda.get_device_name(0),
                          "power_limit": dev.power_limit(), **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
