"""Guards of the port's stage-1 modules: they import neither JAX nor the
JAX package, and the stage-1 CLIs run on ``cuda`` by default, so without a
card they raise instead of carrying on quietly on the CPU. Each check runs
in a clean subprocess (the test process itself has imported both
packages)."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE1 = ("gs.obb", "gs.scene", "pipelines.common", "pipelines.gen_seq",
          "pipelines.render_depth", "pipelines.delete", "pipelines.gen_pc",
          "pipelines.vis_render", "pipelines.vis", "utils.quaternion",
          "utils.sh", "utils.synthetic")


def _run(code):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


def test_stage1_modules_import_neither_jax_nor_the_jax_package():
    r = _run(f"""
        import importlib, pkgutil, sys
        import multiview_inpaint_tpu_torch as pkg
        mods = {{m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + ".")}}
        want = {{pkg.__name__ + "." + m for m in {STAGE1!r}}}
        for name in sorted(want):
            importlib.import_module(name)
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                            "multiview_inpaint_tpu"))
        print(sorted(want - mods), bad)
        sys.exit(1 if bad or not want <= mods else 0)
    """)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]


def test_stage1_clis_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device works")
    r = _run("""
        import pytest
        from multiview_inpaint_tpu_torch.pipelines import (
            delete, gen_seq, render_depth, vis_render)
        scene = ["-s", "scene", "-m", "model", "--scene_id", "toy_case"]
        for call in (lambda: gen_seq.main(scene),
                     lambda: render_depth.main(scene),
                     lambda: vis_render.main(scene + ["--src"]),
                     lambda: delete.main(["-m", "model", "--box", "b.obj"])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
        print("all raised")
    """)
    assert r.returncode == 0 and "all raised" in r.stdout, \
        r.stdout + r.stderr[-3000:]
