"""Port parity, CLIP grounding: ``guidance/grounding`` and
``diffusion/clip_text`` of the port against the JAX package on the CPU.

Tiny towers (``TINY_VIT`` and a 2-layer width-64 text tower, ``TINY_TEXT``)
are built once by JAX's eager init; every leaf is moved by a seeded
N(0, 0.05^2) draw so that the zero-initialised biases and the unit
LayerNorm scales show, and the q/k projections are scaled x4 so that the
attention is far from uniform. The leaves go into the port through
``diffusion.checkpoint.state_dict_from_jax`` (the text tower as component
``clip_text``). The tokenizer reads a merges file the test writes.

Bars: tokens and windows exactly equal; the text tower's hidden states
and pooled output within 3e-5 of their largest magnitude (f32 sums in
another order, a different erf; with the x4 q/k gain the softmax is
sharp, and each package lies up to ~1e-5 of it from a float64
evaluation of the same weights, the port 0.9e-5, JAX 0.4e-5); window
scores (cosines) within 2e-5 absolute, and the same best window, whose
margin over the runner-up is asserted to exceed 10x that bar.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.core import unfreeze
from flax.traverse_util import flatten_dict, unflatten_dict

from multiview_inpaint_tpu.diffusion import clip_text as jtext
from multiview_inpaint_tpu.diffusion import clip_vit as jvit
from multiview_inpaint_tpu.guidance import grounding as jground
from multiview_inpaint_tpu_torch.diffusion import checkpoint
from multiview_inpaint_tpu_torch.diffusion import clip_text as ttext
from multiview_inpaint_tpu_torch.guidance import grounding as tground

MERGES = ["t h", "th e</w>", "c h", "a i", "ai r</w>", "r e", "re d</w>",
          "o b", "ob j", "obj e", "obje c", "objec t</w>", "a </w>",
          "ch air</w>", "l a", "la m", "lam p</w>", "b l", "bl u",
          "blu e</w>"]
TINY_TEXT = jtext.TextConfig(vocab_size=512 + len(MERGES) + 2,
                             context_length=16, width=64, layers=2, heads=2,
                             output_dim=64)
QUERIES = ["the red chair", "A blue  lamp!", "an object, 42 &amp; more",
           "chair chairs"]
TEXT_TOL, SCORE_TOL = 3e-5, 2e-5
H, W = 48, 64


def write_merges(path):
    with open(path, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(MERGES) + "\n")
    return str(path)


def perturb(params, seed, scale=0.05, qk_gain=4.0):
    rng = np.random.default_rng(seed)
    flat = flatten_dict(unfreeze(params), sep="/")
    out = {}
    for k, v in flat.items():
        v = (np.asarray(v, np.float32)
             + scale * rng.normal(size=np.shape(v))).astype(np.float32)
        if "/attn/query/" in k or "/attn/key/" in k:
            v = v * np.float32(qk_gain)
        out[k] = v
    return out


def nested(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    vit = jvit.CLIPVisionTower(jvit.TINY_VIT)
    text = jtext.CLIPTextTower(TINY_TEXT)
    flat_v = perturb(vit.init(jax.random.key(0),
                              jnp.zeros((1, 32, 32, 3)))["params"], 1)
    flat_t = perturb(text.init(jax.random.key(2), jnp.zeros(
        (1, TINY_TEXT.context_length), jnp.int32))["params"], 3)
    bpe = write_merges(tmp_path_factory.mktemp("bpe") / "merges.txt")
    return dict(vit=vit, text=text, flat_v=flat_v, flat_t=flat_t, bpe=bpe,
                jv=nested(flat_v), jt=nested(flat_t))


@pytest.mark.parametrize("hw", [(48, 64), (96, 128), (384, 512), (31, 17)])
def test_grounding_windows_equal(hw):
    np.testing.assert_array_equal(tground.grounding_windows(*hw),
                                  jground.grounding_windows(*hw))


def test_tokenizer_matches_jax(towers):
    jtok = jtext.SimpleTokenizer(towers["bpe"], TINY_TEXT.context_length)
    ttok = ttext.SimpleTokenizer(towers["bpe"], TINY_TEXT.context_length)
    for q in QUERIES:
        assert ttok.encode(q) == jtok.encode(q), q
    np.testing.assert_array_equal(ttok(QUERIES), jtok(QUERIES))
    # the merges apply: "the" is one token, the eot id is the highest
    assert len(ttok.encode("the")) == 1
    assert int(ttok(QUERIES).max()) == TINY_TEXT.vocab_size - 1


def test_text_tower_matches_jax(towers):
    toks = jtext.SimpleTokenizer(towers["bpe"],
                                 TINY_TEXT.context_length)(QUERIES)
    want_h, want_p = towers["text"].apply({"params": towers["jt"]},
                                          jnp.asarray(toks))
    port = tground.tower_from_jax(towers["flat_t"], TINY_TEXT, "clip_text",
                                  "cpu")
    with torch.no_grad():
        got_h, got_p = port(torch.from_numpy(toks))
    for got, want in ((got_h, want_h), (got_p, want_p)):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        assert err <= TEXT_TOL * np.abs(want).max(), err


def test_text_tower_round_trips_through_the_carrier(towers):
    sd = checkpoint.state_dict_from_jax(towers["flat_t"], "clip_text")
    assert all(k.startswith(checkpoint.TEXT_PREFIX) for k in sd)
    back = checkpoint.state_dict_to_jax(sd, component="clip_text",
                                        clip_heads=TINY_TEXT.heads)
    assert sorted(back) == sorted(towers["flat_t"])
    for k, v in towers["flat_t"].items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def _frame(seed=5):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.3, 0.7, (H, W, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:20, 0:20] / 20.0
    img[6:26, 34:54] = np.stack([yy, 1 - xx, yy * xx], -1)
    return img


@pytest.mark.parametrize("query", ["text", "features"])
def test_grounder_matches_jax(towers, query):
    jg = jground.CLIPGrounder(towers["jv"], vit_cfg=jvit.TINY_VIT,
                              text_params=towers["jt"], text_cfg=TINY_TEXT,
                              bpe_path=towers["bpe"])
    tg = tground.CLIPGrounder.from_jax_params(
        towers["flat_v"], jvit.TINY_VIT, towers["flat_t"], TINY_TEXT,
        towers["bpe"], device="cpu")
    img = _frame()
    if query == "text":
        q = "the red chair"
        want = np.asarray(jg.text_features(q))
        np.testing.assert_allclose(tg.text_features(q).numpy(), want,
                                   atol=TEXT_TOL * np.abs(want).max())
    else:
        q = np.random.default_rng(7).normal(size=64).astype(np.float32)
    jbox, jscores = jg(img, q)
    tbox, tscores = tg(img, q)
    assert len(tscores) == len(jground.grounding_windows(H, W))
    err = np.abs(tscores - np.asarray(jscores)).max()
    assert err <= SCORE_TOL, err
    assert tbox == jbox
    top = np.sort(np.asarray(jscores))[-2:]
    assert top[1] - top[0] > 10 * SCORE_TOL, top


def test_grounder_crops_match_jax_resize(towers):
    """The batched per-size crops equal ``jax.image.resize`` bilinear of
    each window to 2e-5 (the bar of ``test_torch_stage2_scene.py``'s
    resize test)."""
    tg = tground.CLIPGrounder.from_jax_params(
        towers["flat_v"], jvit.TINY_VIT, device="cpu")
    img = _frame(9)
    wins = jground.grounding_windows(H, W)
    got = tg.crops(img, wins).numpy()
    for k, (y0, x0, y1, x1) in enumerate(wins):
        want = jax.image.resize(jnp.asarray(img[y0:y1, x0:x1]),
                                (224, 224, 3), "bilinear")
        np.testing.assert_allclose(got[k], np.asarray(want), atol=2e-5)


def test_grounder_refuses_text_without_a_text_tower(towers):
    tg = tground.CLIPGrounder.from_jax_params(
        towers["flat_v"], jvit.TINY_VIT, device="cpu")
    with pytest.raises(ValueError, match="text queries need"):
        tg.text_features("a chair")


def test_filter_components_and_box_to_mask():
    rng = np.random.default_rng(3)
    mask = (rng.uniform(size=(40, 50)) > 0.7).astype(np.float32)
    mask[5:15, 5:15] = 1.0
    mask[25:38, 30:48] = 1.0
    for box in ((20, 25, 40, 50), (0, 0, 12, 12), (-3, -4, 60, 70),
                (10, 10, 10, 30)):
        region = tground.box_to_mask(box, 40, 50)
        np.testing.assert_array_equal(region,
                                      jground.box_to_mask(box, 40, 50))
        for overlap in (0.05, 0.3, 0.9):
            np.testing.assert_array_equal(
                tground.filter_components(mask, region, overlap),
                jground.filter_components(mask, region, overlap))
    empty = np.zeros((8, 8), np.float32)
    np.testing.assert_array_equal(
        tground.filter_components(empty, np.ones_like(empty)), empty)
