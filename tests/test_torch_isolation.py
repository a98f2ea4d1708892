"""Guards of the port: it never imports JAX or the JAX package, and its
entry points run on ``cuda`` by default, so without a card they raise
instead of carrying on quietly on the CPU. Each check runs in a clean
subprocess (the test process itself has imported both packages)."""

import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, cwd=REPO, env=None):
    env = dict(os.environ if env is None else env, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_port_imports_neither_jax_nor_the_jax_package():
    r = _run("""
        import importlib, pkgutil, sys
        import multiview_inpaint_tpu_torch as pkg
        mods = [m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + ".")]
        for name in mods:
            importlib.import_module(name)
        import chip_smoke  # noqa: F401
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                            "multiview_inpaint_tpu"))
        slices = {pkg.__name__ + "." + m for m in (
            "diffusion.flash_attention", "diffusion.engine",
            "data.svd_dataset", "pipelines.svd_test", "diffusion.losses",
            "data.warp", "parallel.svd_data_parallel",
            "pipelines.svd_train", "metrics.metrics", "metrics.lpips",
            "metrics.musiq", "metrics.wadiqam", "pipelines.cmp",
            "diffusion.regularizers", "diffusion.autoencoder_loss",
            "pipelines.vae_finetune", "diffusion.api", "diffusion.safety",
            "pipelines.divide_test", "pipelines.simple_video_sample",
            "pipelines.demo_app", "parallel.mesh", "parallel.render_parallel",
            "parallel.gs_data_parallel", "parallel.gs_band_train",
            "utils.live_view", "data.native_io",
            "parallel.svd_inference_parallel")}
        print(len(mods), bad, sorted(slices - set(mods)))
        sys.exit(1 if bad or len(mods) < 35 or not slices <= set(mods)
                 else 0)
    """)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]


def test_entry_points_raise_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        import pytest
        pytest.skip("this machine has a GPU: the default device works")
    r = _run("""
        import pytest
        from multiview_inpaint_tpu_torch.ops.rasterizer import (
            RenderCamera, render)
        from multiview_inpaint_tpu_torch.gs import checkpoint
        from multiview_inpaint_tpu_torch.pipelines import render as cli
        from multiview_inpaint_tpu_torch.pipelines import (
            cmp, demo_app, simple_video_sample, svd_test, svd_train,
            train_gs, vae_finetune)
        from multiview_inpaint_tpu_torch.diffusion import engine
        from multiview_inpaint_tpu_torch.utils import synthetic
        params = synthetic.make_gt_gaussians(8, device="cpu")
        cam = RenderCamera.from_camera(synthetic.bench_camera(), "cpu")
        for call in (lambda: render(params, cam, [0.0, 0.0, 0.0]),
                     lambda: synthetic.make_gt_gaussians(8),
                     lambda: RenderCamera.from_camera(
                         synthetic.bench_camera()),
                     lambda: cli.main(["-s", "scene", "-m", "model"]),
                     lambda: train_gs.main(["-s", "scene", "-m", "model"]),
                     lambda: checkpoint.load_train_state("chkpnt.npz"),
                     lambda: svd_test.main(["--data_root", "gs",
                                            "--tiny_model"]),
                     lambda: svd_train.main(["--data_root", "est",
                                             "--tiny_model"]),
                     lambda: engine.init_engine(),
                     lambda: cmp.main(["--root", "vis/cmp/exp"]),
                     lambda: vae_finetune.main(["--data_dir", "imgs",
                                                "--out_dir", "out"]),
                     lambda: simple_video_sample.main(["--image", "in.png",
                                                       "--tiny_model"]),
                     lambda: demo_app.main(["--tiny_model", "--port",
                                            "0"])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
        print("all raised")
    """)
    assert r.returncode == 0 and "all raised" in r.stdout, \
        r.stdout + r.stderr[-3000:]
    # chip_smoke.py fails with no card, and alone without the repo.
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for cwd, script in ((REPO, "chip_smoke.py"), (str(alone),
                                                   "chip_smoke.py")):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        p = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=300)
        assert p.returncode != 0 and '"ok"' not in p.stdout, p.stdout


def _loaders():
    from multiview_inpaint_tpu_torch.diffusion import api, regularizers
    from multiview_inpaint_tpu_torch.metrics import lpips, musiq, wadiqam
    from multiview_inpaint_tpu_torch.models import dpt
    pipe = api.SamplingPipeline(lambda x, s, c: x)
    return {"MUSIQScorer": lambda: musiq.MUSIQScorer({}),
            "init_ema_codebook": lambda: regularizers.init_ema_codebook(
                16, 3),
            "WaDIQaMScorer": lambda: wadiqam.WaDIQaMScorer({}),
            "load_lpips_npz": lambda: lpips.load_lpips_npz("lpips.npz"),
            "load_dpt_torch": lambda: dpt.load_dpt_torch("dpt.pt"),
            "SamplingPipeline.sample": lambda: pipe.sample((1, 2, 2, 4),
                                                           {})}


@pytest.mark.parametrize("loader", sorted(_loaders()))
def test_loaders_default_to_the_card(loader):
    """The public loaders and the sampling pipeline take the card unless
    the caller passes ``device="cpu"``: without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _loaders()[loader]()
