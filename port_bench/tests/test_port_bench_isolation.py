"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names; the reference loads nothing of the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from port_bench.harness import env
from port_bench.tests.conftest import ROOT, run_cell

REFERENCE = os.path.join(ROOT, "port_bench", "reference")


def test_names_are_compared_whole():
    assert env.loaded_forbidden(["multiview_inpaint_tpu_torch",
                                 "multiview_inpaint_tpu_torch.kernels",
                                 "jaxtyping", "flaxen"]) == []
    assert env.loaded_forbidden(["multiview_inpaint_tpu.ops", "jax",
                                 "jaxlib.xla_client", "optax",
                                 "flax.linen"]) == [
        "flax", "jax", "jaxlib", "multiview_inpaint_tpu", "optax"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    banned = set(env.FORBIDDEN) | {"multiview_inpaint_tpu_torch"}
    for folder, _, files in os.walk(REFERENCE):
        for name in files:
            if name.endswith(".py"):
                for mod in _imports(os.path.join(folder, name)):
                    assert mod.split(".")[0] not in banned, (name, mod)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import port_bench.reference.svd.model, "
            "port_bench.reference.svd.lowp, port_bench.reference.gs.model\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert "multiview_inpaint_tpu_torch" not in out
    assert not set(eval(out)) & set(env.FORBIDDEN)


def test_runs_load_no_forbidden_module(tiny):
    """Every cell, in a fresh process: after the run, no forbidden name."""
    code = ("import sys, io, contextlib; sys.path.insert(0, %r)\n"
            "import torch; torch.set_num_threads(1)\n"
            "from port_bench import run\n"
            "from port_bench.harness import env\n"
            "for cell in ('svd-clip', 'gs2m-train-1080p', "
            "'gs2m-render-1080p'):\n"
            "    with contextlib.redirect_stdout(io.StringIO()), "
            "contextlib.redirect_stderr(io.StringIO()):\n"
            "        assert run.main(['--workload', cell, '--seed', '5', "
            "'--seconds', '0.2', '--trace', '1'], device='cpu', "
            "manifest_path=%r, bench=%r) == 0\n"
            "print(env.loaded_forbidden())" % (ROOT, tiny[0], tiny[1]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_a_forbidden_module_stops_the_run(tiny, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    rc, line, err = run_cell(tiny, "gs2m-render-1080p")
    assert rc != 0 and line is None and "jax" in err
