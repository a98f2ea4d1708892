"""Finds the benchmark's parts by name: the manifest's cell, its
configuration and traffic files, the traffic's driver, and the reader of
each per-layer metric."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    """``BENCHMARK.json`` and the files it names under ``port_bench``."""

    def __init__(self, path: str, bench: str = BENCH):
        self.path = path
        self.bench = bench
        self.data = load_json(path)

    def cell(self, name: str) -> dict:
        for cell in self.data["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in {self.path}")

    def config(self, cell: dict) -> dict:
        return load_json(os.path.join(self.bench, "configs",
                                      cell["config"] + ".json"))

    def traffic(self, cell: dict) -> dict:
        return load_json(os.path.join(self.bench, "traffic",
                                      cell["traffic"] + ".json"))

    def driver(self, traffic: dict):
        name = traffic["driver"]
        return load_module(os.path.join(self.bench, "drivers", name + ".py"),
                           "port_bench_driver_" + name)

    def _reports(self, metric: dict, cell: dict, e2e_names) -> bool:
        if "workloads" in metric:
            return cell["name"] in metric["workloads"]
        return metric.get("moves") in e2e_names

    def end_to_end(self, cell: dict) -> list:
        return [m for m in self.data["end_to_end"]
                if "workloads" not in m or cell["name"] in m["workloads"]]

    def per_layer(self, cell: dict) -> list:
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if self._reports(m, cell, e2e)]

    def reader(self, metric: dict):
        return load_module(os.path.join(self.bench, "metrics",
                                        metric["name"] + ".py"),
                           "port_bench_metric_" + metric["name"]
                           .replace(".", "_").replace("-", "_"))
