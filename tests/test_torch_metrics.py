"""Port parity, slice 8's metrics: ``metrics/metrics.py``, ``metrics/lpips``
and ``metrics/wadiqam`` against the JAX package on the CPU in f32.

The networks start from the port's seeded init with every leaf moved by a
seeded N(0, 0.05^2) draw (so that the LPIPS ``lin`` convs and the heads
show) and go to JAX through ``checkpoint.torch_to_flax``, whose leaves
must be exactly those of the JAX module's init (its shapes by
``jax.eval_shape``).

Bars:
- psnr (masked and unmasked), sharpness and the three CLIP similarity
  helpers (numpy, copied): equal to JAX's; SSIM within 1e-6;
- LPIPS at full VGG16 on a [2, 64, 64, 3] pair: the distances within
  1e-5 relative, exactly 0 for identical inputs; the npz layout that
  ``vae_finetune --lpips_ckpt`` reads loads the same network;
- WaDIQaM-NR on a 96x128 image (12 patches) and on a 70x100 one (cropped
  to 64x96): within 1e-5 relative, through the scorer as ``cmp`` calls it;
- ``import_torch_weights`` and ``import_wadiqam`` on synthetic torch
  state dicts: every leaf equal to the JAX importer's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.core import unfreeze
from flax.traverse_util import flatten_dict, unflatten_dict

from multiview_inpaint_tpu.metrics import lpips as jlpips
from multiview_inpaint_tpu.metrics import metrics as jm
from multiview_inpaint_tpu.metrics import wadiqam as jwad
from multiview_inpaint_tpu_torch.diffusion import checkpoint
from multiview_inpaint_tpu_torch.metrics import lpips as tlpips
from multiview_inpaint_tpu_torch.metrics import metrics as tm
from multiview_inpaint_tpu_torch.metrics import wadiqam as twad

REL = 1e-5


def _seeded(module, seed, scale=0.05):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(scale * torch.randn(p.shape, generator=gen))
    return module


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in flatten_dict(
        unfreeze(tree), sep="/").items()}


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(
        unfreeze(tree), sep="/").items()}


def nested(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


def _carried(port, jax_module, *example):
    """The port module's weights as JAX params, their leaves checked
    against the JAX module's."""
    flat = checkpoint.torch_to_flax(port.state_dict())
    shapes = jax.eval_shape(jax_module.init, jax.random.key(0), *example)
    assert {k: v.shape for k, v in flat.items()} == _shapes(
        shapes["params"])
    return flat


def test_numpy_metrics_equal_jax():
    rng = np.random.default_rng(0)
    a = rng.random((24, 32, 3)).astype(np.float32)
    b = np.clip(a + 0.05 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    mask = (rng.random((24, 32)) > 0.4).astype(np.float32)
    assert tm.psnr(a, b) == jm.psnr(a, b)
    assert tm.psnr(a, b, mask) == jm.psnr(a, b, mask)
    assert tm.laplacian_sharpness(a) == jm.laplacian_sharpness(a)
    assert abs(tm.ssim(a, b) - jm.ssim(a, b)) <= 1e-6

    proj = rng.normal(size=(3, 8))

    def img_embed(im):
        return im.mean(axis=(0, 1)) @ proj

    def text_embed(text):
        return np.random.default_rng(len(text)).normal(size=8)

    frames = [rng.random((6, 6, 3)) for _ in range(4)]
    for fn, args in ((
            "text_img_similarity", (img_embed, text_embed, frames, "a cat")),
            ("directional_similarity", (img_embed, text_embed, frames,
                                        frames[::-1], "a cat", "a dog")),
            ("temporal_similarity", (img_embed, frames))):
        assert getattr(tm, fn)(*args) == getattr(jm, fn)(*args), fn


def test_lpips_matches_jax(tmp_path):
    torch.manual_seed(0)
    port = _seeded(tlpips.LPIPS(), 1)
    rng = np.random.default_rng(2)
    a = np.tanh(rng.normal(size=(2, 64, 64, 3))).astype(np.float32)
    b = np.tanh(a + 0.3 * rng.normal(size=a.shape)).astype(np.float32)
    flat = _carried(port, jlpips.LPIPS(), jnp.asarray(a), jnp.asarray(a))
    want = np.asarray(jlpips.LPIPS().apply({"params": nested(flat)},
                                           jnp.asarray(a), jnp.asarray(b)))
    # the npz layout vae_finetune reads: {"params": the pickled JAX tree}
    path = str(tmp_path / "lpips.npz")
    np.savez(path, params=unflatten_dict(
        {tuple(k.split("/")): v for k, v in flat.items()}))
    model = tlpips.load_lpips_npz(path, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        same = model(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    assert got.shape == (2,) and np.all(want > 0)
    assert np.all(np.abs(got - want) <= REL * np.abs(want)), (got, want)
    assert np.all(same == 0.0), same


@pytest.mark.parametrize("size", [(96, 128), (70, 100)])
def test_wadiqam_matches_jax(size):
    torch.manual_seed(0)
    port = _seeded(twad.WaDIQaMNR(), 3)
    flat = _carried(port, jwad.WaDIQaMNR(), jnp.zeros((1, 64, 64, 3)))
    img = np.random.default_rng(4).random(size + (3,)).astype(np.float32)
    want = jwad.WaDIQaMNR().apply({"params": nested(flat)},
                                  jnp.asarray(img)[None])
    got = twad.WaDIQaMScorer(flat, device="cpu")(img)
    assert abs(got - float(want[0])) <= REL * abs(float(want[0]))


def test_lpips_torch_import_equals_jax_importer():
    rng = np.random.default_rng(5)
    vgg, lins = {}, {}
    cin = 3
    for ci, ti in enumerate(tlpips._TORCHVISION_CONVS):
        ch = [c for c, n in tlpips._STAGES for _ in range(n)][ci]
        vgg[f"features.{ti}.weight"] = rng.normal(
            size=(ch, cin, 3, 3)).astype(np.float32)
        vgg[f"features.{ti}.bias"] = rng.normal(size=(ch,)).astype(
            np.float32)
        cin = ch
    for i, (ch, _) in enumerate(tlpips._STAGES):
        key = f"lin{i}.model.1.weight" if i % 2 else \
            f"lins.{i}.model.1.weight"
        lins[key] = rng.normal(size=(1, ch, 1, 1)).astype(np.float32)
    shapes = jax.eval_shape(jlpips.LPIPS().init, jax.random.key(0),
                            jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 32, 32, 3)))["params"]
    want = _flat(jlpips.import_torch_weights(shapes, vgg, lins))
    port = tlpips.LPIPS()
    port.load_state_dict(tlpips.import_torch_weights(vgg, lins))
    got = checkpoint.torch_to_flax(port.state_dict())
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_wadiqam_torch_import_equals_jax_importer():
    chans = [32, 32, 64, 64, 128, 128, 256, 256, 512, 512]
    seq, prev = [], 3
    for i, ch in enumerate(chans):
        seq += [torch.nn.Conv2d(prev, ch, 3, padding=1), torch.nn.ReLU()]
        if i % 2 == 1:
            seq += [torch.nn.MaxPool2d(2)]
        prev = ch
    rng = np.random.default_rng(6)
    state = {f"features.{k}": rng.normal(0, 0.05, v.shape).astype(np.float32)
             for k, v in torch.nn.Sequential(*seq).state_dict().items()}
    for n in ("fc1_q", "fc2_q", "fc1_w", "fc2_w"):
        out = 512 if n.startswith("fc1") else 1
        state[f"{n}.weight"] = rng.normal(0, 0.05, (out, 512)).astype(
            np.float32)
        state[f"{n}.bias"] = rng.normal(0, 0.05, (out,)).astype(np.float32)
    want = _flat(jwad.import_wadiqam(state))
    port = twad.WaDIQaMNR()
    port.load_state_dict(twad.import_wadiqam(state))
    got = checkpoint.torch_to_flax(port.state_dict())
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
