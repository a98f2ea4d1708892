"""Port parity, MUSIQ (``metrics/musiq.py``) against the JAX package on the
CPU in f32.

The networks start from the port's seeded init with every leaf moved by a
seeded N(0, 0.05^2) draw and go to JAX through
``musiq.state_dict_to_jax`` (the blocks through the port's OpenCLIP map,
``checkpoint._clip_to_jax``), whose leaves must be exactly those of the
JAX module's init (its shapes by ``jax.eval_shape``), and back through
``state_dict_from_jax`` (``checkpoint._clip_state_dict``) into the scorer.

Bars:
- ``_arp_size`` and ``_grid_index`` equal to JAX's;
- the multi-scale resizes at MUSIQ's own ratios, a downscale (1080x1920
  to 216x384 and 126x224) and an upscale (64x96 to 256x384 and 149x224):
  within 1e-6 of a float64 evaluation of ``jax.image.resize``'s weights,
  and within 2e-5 of ``jax.image.resize`` itself (its f32 contraction is
  up to 1.15e-5 off that float64 evaluation when it shrinks);
- the score of ``TINY_MUSIQ`` and of the full ``MUSIQConfig()`` (14
  layers of 384, 138 tokens) on a 64x96 image: within 1e-4 relative;
  the token count at 1080p is 2,153;
- ``import_musiq`` on the synthetic torch state dict of the JAX test
  (tiny and full width): 0 missing and 0 unexpected as the JAX importer,
  and every leaf equal to the JAX importer's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.core import unfreeze
from flax.traverse_util import flatten_dict, unflatten_dict

from multiview_inpaint_tpu.metrics import musiq as jmusiq
from multiview_inpaint_tpu_torch.diffusion import clip_vit as tclip
from multiview_inpaint_tpu_torch.metrics import musiq as tmusiq

REL = 1e-4
CONFIGS = ("tiny", "full")


def _cfgs(name):
    if name == "tiny":
        return jmusiq.TINY_MUSIQ, tmusiq.TINY_MUSIQ
    return jmusiq.MUSIQConfig(), tmusiq.MUSIQConfig()


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in flatten_dict(
        unfreeze(tree), sep="/").items()}


def nested(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


@pytest.mark.parametrize("h,w", [(480, 640), (640, 480), (1080, 1920),
                                 (64, 96), (33, 1000), (17, 5)])
def test_arp_size_and_grid_index_equal_jax(h, w):
    for longer in (384, 224, 64):
        assert tmusiq._arp_size(h, w, longer) == jmusiq._arp_size(
            h, w, longer)
    for grid in (4, 10):
        gh, gw = -(-h // 32), -(-w // 32)
        assert np.array_equal(tmusiq._grid_index(gh, gw, grid),
                              jmusiq._grid_index(gh, gw, grid))


@pytest.mark.parametrize("h,w", [(1080, 1920), (64, 96)])
def test_multiscale_resize_matches_jax(h, w):
    img = np.random.default_rng(h).random((1, h, w, 3)).astype(np.float32)
    for longer in (384, 224):
        size = tmusiq._arp_size(h, w, longer)
        got = tclip.resize_bilinear(torch.from_numpy(img), size).numpy()
        want = np.asarray(jax.image.resize(jnp.asarray(img),
                                           (1,) + size + (3,), "bilinear"))
        w_h, w_w = (tclip._resize_weights(n_in, n_out, "cpu",
                                          tclip._triangle).double()
                    for n_in, n_out in zip((h, w), size))
        exact = torch.einsum("bhwc,hi,wj->bijc",
                             torch.from_numpy(img).double(), w_h, w_w)
        assert got.shape == want.shape
        assert np.abs(got - exact.numpy()).max() <= 1e-6, size
        assert np.abs(got - want).max() <= 2e-5, size


@pytest.fixture(scope="module")
def weights():
    """Seeded port weights as JAX params, per config."""
    out = {}
    for i, name in enumerate(CONFIGS):
        jcfg, tcfg = _cfgs(name)
        torch.manual_seed(i)
        port = tmusiq.MUSIQ(tcfg)
        gen = torch.Generator().manual_seed(10 + i)
        with torch.no_grad():
            for p in port.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
        flat = tmusiq.state_dict_to_jax(port.state_dict(), tcfg.heads)
        shapes = jax.eval_shape(jmusiq.MUSIQ(jcfg).init, jax.random.key(0),
                                jnp.zeros((1, 64, 96, 3)))["params"]
        assert {k: v.shape for k, v in flat.items()} == _shapes(shapes)
        out[name] = flat
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_musiq_score_matches_jax(weights, name):
    jcfg, tcfg = _cfgs(name)
    flat = weights[name]
    img = np.random.default_rng(7).random((64, 96, 3)).astype(np.float32)
    want = float(jmusiq.MUSIQ(jcfg).apply({"params": nested(flat)},
                                          jnp.asarray(img)[None])[0])
    scorer = tmusiq.MUSIQScorer(flat, tcfg, device="cpu")
    got = scorer(img)
    assert abs(got - want) <= REL * abs(want), (got, want)
    if name == "full":
        assert scorer.model.tokens(img[None]) == 138
        assert scorer.model.tokens(np.zeros((1, 1080, 1920, 3))) == 2153


def _synthetic_state_dict(cfg, seed):
    """The torch MUSIQ key space of the JAX ``test_musiq.py`` coverage
    test, one random leaf per key."""
    rng = np.random.default_rng(seed)
    d, mlp, g, s = cfg.dim, cfg.mlp_dim, cfg.grid, len(cfg.scales) + 1

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    sd = {"embedding.patch_projection.weight": r(d, 32 * 32 * 3),
          "embedding.patch_projection.bias": r(d),
          "embedding.spatial_embedding": r(g * g, d),
          "embedding.scale_embedding": r(s, d),
          "cls_token": r(1, 1, d), "norm.weight": r(d), "norm.bias": r(d),
          "head.weight": r(1, d), "head.bias": r(1)}
    for i in range(cfg.layers):
        pre = f"blocks.{i}"
        sd.update({f"{pre}.norm1.weight": r(d), f"{pre}.norm1.bias": r(d),
                   f"{pre}.norm2.weight": r(d), f"{pre}.norm2.bias": r(d),
                   f"{pre}.attn.in_proj_weight": r(3 * d, d),
                   f"{pre}.attn.in_proj_bias": r(3 * d),
                   f"{pre}.attn.out_proj.weight": r(d, d),
                   f"{pre}.attn.out_proj.bias": r(d),
                   f"{pre}.mlp.fc1.weight": r(mlp, d),
                   f"{pre}.mlp.fc1.bias": r(mlp),
                   f"{pre}.mlp.fc2.weight": r(d, mlp),
                   f"{pre}.mlp.fc2.bias": r(d)})
    return sd


@pytest.mark.parametrize("name", CONFIGS)
def test_import_musiq_covers_what_the_jax_importer_covers(name):
    jcfg, tcfg = _cfgs(name)
    sd = _synthetic_state_dict(jcfg, 1)
    shapes = jax.eval_shape(jmusiq.MUSIQ(jcfg).init, jax.random.key(0),
                            jnp.zeros((1, 64, 96, 3)))["params"]
    merged, jmissing, junexpected = jmusiq.import_musiq(
        shapes, sd, heads=jcfg.heads)
    assert jmissing == [] and junexpected == []
    port = tmusiq.MUSIQ(tcfg)
    missing, unexpected = tmusiq.import_musiq(port, sd)
    assert missing == [] and unexpected == []
    got = tmusiq.state_dict_to_jax(port.state_dict(), tcfg.heads)
    want = {k: np.asarray(v) for k, v in flatten_dict(
        unfreeze(merged), sep="/").items()}
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
