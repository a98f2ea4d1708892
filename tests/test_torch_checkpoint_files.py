"""Weights files that the JAX ``weights_io.load_torch_state_dict`` reads
and the port reads the same way: a ``.safetensors`` file, and a
Lightning-shaped ``.ckpt`` whose non-tensor entries a weights-only load
refuses. Keys and values must match the JAX loader's exactly; one
synthetic ``.safetensors`` also goes through ``svd_test --base_ckpt``.
"""

import argparse

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from multiview_inpaint_tpu.diffusion import weights_io
from multiview_inpaint_tpu_torch.diffusion import checkpoint
from multiview_inpaint_tpu_torch.diffusion import engine as tengine
from multiview_inpaint_tpu_torch.pipelines import svd_test
from multiview_inpaint_tpu_torch.utils import synthetic


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"model.diffusion_model.x": np.zeros(2, np.float32),
            "model.diffusion_model.input_blocks.0.0.weight":
            rng.normal(size=(4, 3, 3, 3)).astype(np.float32),
            "first_stage_model.decoder.conv_in.bias":
            rng.normal(size=(5,)).astype(np.float32)}


def _assert_same(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert isinstance(got[k], torch.Tensor), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)


def test_safetensors_file_reads_as_the_jax_loader_reads_it(tmp_path):
    path = str(tmp_path / "b.safetensors")
    save_file(_arrays(), path)
    want = weights_io.load_torch_state_dict(path)
    _assert_same(checkpoint.read_state_dict(path), want)
    _assert_same(checkpoint.load_torch_state_dict(path), want)


@pytest.mark.parametrize("suffix", [".ckpt", ".pth"])
def test_lightning_checkpoint_with_python_objects_reads_as_the_jax_loader(
        tmp_path, capsys, suffix):
    """A ``{"state_dict": ..., "hyper_parameters": Namespace}`` pickle:
    the weights-only load refuses it, the port says so and loads it in
    full, as the reference does."""
    path = str(tmp_path / ("lightning" + suffix))
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in _arrays(1).items()},
                "hyper_parameters": argparse.Namespace(lr=1e-4),
                "epoch": 3}, path)
    with pytest.raises(Exception):
        torch.load(path, map_location="cpu", weights_only=True)
    want = weights_io.load_torch_state_dict(path)
    _assert_same(checkpoint.read_state_dict(path), want)
    assert "weights-only load refused it" in capsys.readouterr().out


def test_plain_state_dict_still_loads_weights_only(tmp_path, capsys):
    path = str(tmp_path / "plain.pth")
    torch.save({k: torch.from_numpy(v) for k, v in _arrays(2).items()},
               path)
    _assert_same(checkpoint.read_state_dict(path),
                 weights_io.load_torch_state_dict(path))
    assert "refused" not in capsys.readouterr().out


def test_unknown_suffix_is_refused(tmp_path):
    with pytest.raises(ValueError, match="safetensors"):
        checkpoint.read_state_dict(str(tmp_path / "w.bin"))


def test_svd_test_cli_takes_a_safetensors_base_ckpt(tmp_path, capsys):
    """The tiny engine's UNet, VAE and CLIP weights, moved off their
    init, written as ``.safetensors`` and read back through ``svd_test
    --base_ckpt``: nothing missing, nothing left over, and an engine that
    loads the file holds those weights bit for bit."""
    args = argparse.Namespace(tiny_model=True, num_frames=3, num_steps=1,
                              compute_dtype="float32")
    eng = tengine.init_engine(svd_test._engine_config(args), device="cpu")
    rng = np.random.default_rng(5)
    sd = {k: (v.numpy() + rng.normal(scale=0.05, size=v.shape)).astype(
        np.float32)
        for k, v in eng.reference_state_dict().items()
        if not k.startswith(checkpoint.PREFIXES["controlnet"])}
    path = str(tmp_path / "svd.safetensors")
    save_file(sd, path)

    fresh = tengine.init_engine(svd_test._engine_config(args), device="cpu")
    report = fresh.load_reference_state_dict(checkpoint.read_state_dict(path))
    assert all(len(m) == len(u) == 0 for comp, (m, u) in report.items()
               if comp != "controlnet")
    back = fresh.reference_state_dict()
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)

    root = str(tmp_path / "gs")
    synthetic.write_gs_tree(root, frames=3, size=(64, 48), iteration=7)
    svd_test.main(["--data_root", root, "--logdir", str(tmp_path / "l"),
                   "--tiny_model", "--num_frames", "3", "--num_steps", "1",
                   "--size", "64", "48", "--iteration", "7", "--modes",
                   "x1", "--device", "cpu", "--base_ckpt", path])
    out = capsys.readouterr().out
    for comp in ("unet", "vae", "clip"):
        assert f"base ckpt {comp}: 0 missing, 0 unexpected" in out, out
