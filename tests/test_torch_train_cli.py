"""Port parity, the ``train_gs`` CLI with ``--device cpu``, mirroring
``tests/test_pipelines.py:17-60``: 60 iterations with densification on a
synthetic COLMAP scene, then the outputs (PLY, npz checkpoint, log), a
resume from the checkpoint, and the JAX package reading what the port
wrote.
"""

import json
import os

import numpy as np
import pytest
import torch

from multiview_inpaint_tpu.gs import checkpoint as jckpt
from multiview_inpaint_tpu.gs import gaussians as jgaussians
from multiview_inpaint_tpu_torch.gs import checkpoint as tckpt
from multiview_inpaint_tpu_torch.gs import gaussians as tgaussians
from multiview_inpaint_tpu_torch.pipelines import train_gs
from multiview_inpaint_tpu_torch.utils import synthetic


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's many small ops on one intra-op thread: on PyTorch's
    default threads they thrash when several test workers share the
    cores (this file took 20-50x longer in the 6-worker Tier-1 run than
    alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("ws")
    src = str(root / "dataset" / "toy")
    synthetic.make_colmap_scene(src, device="cpu")
    model = str(root / "output" / "toy")
    train_gs.main([
        "-s", src, "-m", model, "--resolution", "1",
        "--iterations", "60", "--densify_from_iter", "20",
        "--densify_until_iter", "50", "--densification_interval", "20",
        "--opacity_reset_interval", "100000",
        "--test_iterations", "60", "--save_iterations", "60",
        "--checkpoint_iterations", "60", "--log_interval", "20",
        "--device", "cpu",
    ])
    return {"src": src, "model": model}


def _log(model):
    with open(os.path.join(model, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_outputs(trained):
    model = trained["model"]
    ply = os.path.join(model, "point_cloud", "iteration_60",
                       "point_cloud.ply")
    p = tgaussians.load_ply(ply, 0, device="cpu")
    assert int(p.num_live()) > 0
    assert os.path.exists(os.path.join(model, "chkpnt60.npz"))
    log = _log(model)
    losses = [r["loss"] for r in log if "loss" in r]
    assert len(losses) == 3 and losses[-1] < losses[0]
    assert all(r["nonfinite_grads"] == 0 for r in log if "loss" in r)
    assert [r["step"] for r in log if "wanted" in r] == [20, 40]
    assert any("psnr" in r for r in log)
    with open(os.path.join(model, "cfg_args.json")) as f:
        assert json.load(f)["device"] == "cpu"


def test_jax_reads_the_ports_outputs(trained):
    model = trained["model"]
    ply = os.path.join(model, "point_cloud", "iteration_60",
                       "point_cloud.ply")
    ours = tgaussians.load_ply(ply, 0, device="cpu")
    theirs = jgaussians.load_ply(ply, 0)
    for f in ("xyz", "features_dc", "opacity", "scaling", "rotation"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                      np.asarray(getattr(theirs, f)))
    ck = os.path.join(model, "chkpnt60.npz")
    j = jckpt.load_train_state(ck)
    t = tckpt.load_train_state(ck, "cpu")
    assert int(j.step) == t.step == 60
    np.testing.assert_array_equal(np.asarray(j.params.live),
                                  t.params.live.numpy())


def test_train_resume(trained):
    model = trained["model"]
    train_gs.main([
        "-s", trained["src"], "-m", model, "--resolution", "1",
        "--iterations", "70", "--densify_from_iter", "100000",
        "--start_checkpoint", os.path.join(model, "chkpnt60.npz"),
        "--test_iterations", "-1", "--save_iterations", "70",
        "--log_interval", "5", "--device", "cpu",
    ])
    assert os.path.exists(os.path.join(model, "point_cloud",
                                       "iteration_70", "point_cloud.ply"))
    steps = [r["step"] for r in _log(model) if "loss" in r]
    assert steps[-2:] == [65, 70]
