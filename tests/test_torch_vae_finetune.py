"""Port parity, the ``vae_finetune`` CLI (``pipelines/vae_finetune.py``)
against the JAX CLI on the CPU in f32.

Both CLIs run ``--tiny`` (the ch-32 one-level VAE and the 2-layer
discriminator) for one step on the same 4 images at 32x32, batch 2, lr
2e-3, ``--disc_start 0`` (every term on), from the same weights and the
same posterior noise: the port's seeded init moved by a seeded N(0,
0.05^2) draw, carried to JAX (``checkpoint.state_dict_to_jax``,
``checkpoint.torch_to_flax``; the JAX CLI's ``build_models`` patched so
that its ``init`` returns them), and JAX's own ``jax.random`` draw of the
step (``split(PRNGKey(seed))`` as its loop splits it) given to the
port's ``posterior_noise``. The batch comes from
``np.random.default_rng(seed)`` in both. One step, because later steps
are not a fair comparison: the adaptive weight's denominator, the norm of
the LeakyReLU discriminator's input gradient, moves by 1.5e-4 relative
when the reconstruction moves by 1e-6 (a unit crosses its kink), and the
two packages' reconstructions differ by ~4e-6 after one update.

Bars:
- ``train_log.jsonl``: the same keys at the same step, every logged value
  within 1e-5 relative of JAX's;
- the gradients the two CLIs hand their Adam updates (recorded by
  wrapping ``optax.adam`` through ``jax.debug.callback`` and the port's
  ``Optimizer``): every leaf within the gradient bar 2e-6 + 1e-4 max|g|
  of the leaf plus 2e-7 max|g| of the network, the f32 rounding of
  backward sums whose terms run up to the network's largest gradient
  (1,112 in the VAE, where the NLL sums 6,144 L1 terms): the null
  directions below have gradients of 0 up to that rounding (their
  largest entries read 5e-5 here, their errors 8e-5);
- ``vae_params.npz`` and ``disc_params.npz``: exactly the keys and shapes
  of the JAX trees when the JAX ``load_params`` reads them; every
  parameter after the Adam step within 2e-6 + 1e-4 max|JAX update| of its
  leaf, or else within Adam's sign-flip allowance, 2 lr where JAX's
  gradient entry is under that bar (the first update
  lr * g / (|g| + eps) is sign-like, and such an entry may take either
  sign: in this tiny VAE every block has 32 channels in 32 GroupNorm
  groups, so the biases before a GroupNorm and the attention's k, v and
  proj_out biases are null directions whose gradients are rounding
  noise);
- the port CLI with its own init for 3 steps at ``--disc_start 1``: both
  npz files read by the JAX ``load_params`` with the JAX trees' keys and
  shapes, ``loss/disc`` exactly 0 at step 0 and not 0 after, every logged
  value finite.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.core import unfreeze
from flax.traverse_util import flatten_dict, unflatten_dict

from multiview_inpaint_tpu.diffusion import checkpoint as jckpt
from multiview_inpaint_tpu.pipelines import vae_finetune as jvf
from multiview_inpaint_tpu_torch.diffusion import checkpoint
from multiview_inpaint_tpu_torch.gs import scene_io
from multiview_inpaint_tpu_torch.pipelines import vae_finetune as tvf

RES, BATCH, LR, SEED = 32, 2, 2e-3, 0
ARGS = ["--tiny", "--resolution", str(RES), "--batch_size", str(BATCH),
        "--lr", str(LR), "--log_interval", "1", "--seed", str(SEED)]
ONE_STEP = ["--steps", "1", "--disc_start", "0"]


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in flatten_dict(
        unfreeze(tree), sep="/").items()}


def nested(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


class _Preset:
    """A flax module whose ``init`` returns the given variables."""

    def __init__(self, module, variables):
        self.module, self.variables = module, variables

    def init(self, *args, **kwargs):
        return self.variables

    def apply(self, *args, **kwargs):
        return self.module.apply(*args, **kwargs)


def _jax_templates(x0):
    vae, disc = jvf.build_models(True)
    key = jax.random.key(0)
    return (vae, disc, jax.eval_shape(vae.init, key, x0)["params"],
            jax.eval_shape(lambda k, x: disc.init(k, x, train=True), key,
                           x0)["params"])


def _jax_noise(shape):
    """The JAX CLI's posterior draw of its first step."""
    key = jax.random.PRNGKey(SEED)
    key, _, _ = jax.random.split(key, 3)
    _, sub = jax.random.split(key)
    return np.array(jax.random.normal(sub, shape, jnp.float32))


def _read_log(out):
    with open(os.path.join(out, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vae_finetune")
    data = str(tmp / "imgs")
    rng = np.random.default_rng(4)
    for i in range(4):
        yy, xx = np.mgrid[0:RES, 0:RES] / RES
        img = np.stack([yy, xx, np.full_like(yy, 0.25 * i)], -1)
        img = np.clip(img + 0.1 * rng.normal(size=img.shape), 0, 1)
        scene_io.save_image(os.path.join(data, f"{i}.png"),
                            img.astype(np.float32))
    torch.manual_seed(1)
    vae, disc = tvf.build_models(True, "cpu")
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for p in list(vae.parameters()) + list(disc.parameters()):
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    vae_flat = checkpoint.state_dict_to_jax(
        {checkpoint.PREFIXES["vae"] + k: v
         for k, v in vae.state_dict().items()}, "vae2d")
    disc_flat = checkpoint.torch_to_flax(dict(disc.named_parameters()))
    x0 = jnp.zeros((BATCH, RES, RES, 3))
    jvae, jdisc, vae_shapes, disc_shapes = _jax_templates(x0)
    assert {k: v.shape for k, v in vae_flat.items()} == _shapes(vae_shapes)
    assert {k: v.shape for k, v in disc_flat.items()} == _shapes(
        disc_shapes)

    out = {"grads": {"jax": [], "port": []}}
    real_adam = jvf.optax.adam

    def recording_adam(*args, **kwargs):
        tx = real_adam(*args, **kwargs)

        def update(g, state, params=None):
            jax.debug.callback(out["grads"]["jax"].append, g)
            return tx.update(g, state, params)
        return jvf.optax.GradientTransformation(tx.init, update)

    class RecordingOptimizer(tvf.Optimizer):
        def step(self, params, grads, state):
            out["grads"]["port"].append(
                {k: g.detach().numpy().copy() for k, g in grads.items()})
            return super().step(params, grads, state)

    patch = pytest.MonkeyPatch()
    try:
        patch.setattr(jvf.optax, "adam", recording_adam)
        patch.setattr(tvf, "Optimizer", RecordingOptimizer)
        patch.setattr(jvf, "build_models", lambda tiny: (
            _Preset(jvae, {"params": nested(vae_flat)}),
            _Preset(jdisc, {"params": nested(disc_flat)})))
        out["jax"] = str(tmp / "jax")
        jvf.main(["--data_dir", data, "--out_dir", out["jax"]] + ARGS
                 + ONE_STEP)
        noise = torch.from_numpy(_jax_noise((BATCH, RES, RES, 4)))
        patch.setattr(tvf, "build_models", lambda tiny, device=None: (
            vae, disc))
        patch.setattr(tvf, "posterior_noise",
                      lambda shape, generator: noise)
        out["port"] = str(tmp / "port")
        tvf.main(["--data_dir", data, "--out_dir", out["port"],
                  "--device", "cpu"] + ARGS + ONE_STEP)
    finally:
        patch.undo()
    out["grads"] = {name: {
        "vae_params.npz" if "logvar" in g else "disc_params.npz": g
        for g in gs} for name, gs in out["grads"].items()}
    out["grads"]["jax"]["disc_params.npz"] = {
        "params": out["grads"]["jax"]["disc_params.npz"]}
    out["own"] = str(tmp / "own")
    tvf.main(["--data_dir", data, "--out_dir", out["own"],
              "--device", "cpu", "--steps", "3", "--disc_start", "1"] + ARGS)
    out["templates"] = {"vae_params.npz": vae_shapes,
                        "disc_params.npz": disc_shapes}
    out["start"] = {
        "vae_params.npz": dict({f"params/{k}": v for k, v in
                                vae_flat.items()}, logvar=np.float32(0)),
        "disc_params.npz": {f"params/{k}": v for k, v in disc_flat.items()}}
    return out


def test_train_log_matches_jax(runs):
    want, got = _read_log(runs["jax"]), _read_log(runs["port"])
    assert [r["step"] for r in got] == [r["step"] for r in want] == [0]
    w, g = want[0], got[0]
    assert set(g) == set(w)
    assert w["loss/disc"] != 0.0 and w["loss/g"] != 0.0
    for k in w:
        if k not in ("step", "dt"):
            assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]), (k, g[k], w[k])


def test_own_init_run_gates_and_writes_jax_checkpoints(runs):
    log = _read_log(runs["own"])
    assert [r["step"] for r in log] == [0, 1, 2]
    assert all(np.isfinite(v) for r in log for v in r.values())
    assert log[0]["loss/disc"] == 0.0
    assert all(r["loss/disc"] != 0.0 for r in log[1:])
    for name, tree in runs["templates"].items():
        loaded = jckpt.load_params(os.path.join(runs["own"], name))
        assert _shapes(loaded["params"]) == _shapes(tree), name
        assert set(loaded) == ({"params", "logvar"} if name.startswith("vae")
                               else {"params"})


def _jax_flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(
        unfreeze(tree), sep="/").items()}


def _bar(g, tree):
    """The gradient bar of leaf ``g`` of the gradient tree ``tree``."""
    top = max(float(np.abs(v).max()) for v in tree.values())
    return 2e-6 + 2e-7 * top + 1e-4 * float(np.abs(g).max())


@pytest.mark.parametrize("name", ["vae_params.npz", "disc_params.npz"])
def test_gradients_match_jax(runs, name):
    want = _jax_flat(runs["grads"]["jax"][name])
    got = runs["grads"]["port"][name]
    if name == "vae_params.npz":
        got = dict({"params/" + k: v for k, v in
                    _port_vae_flat(got).items()}, logvar=got["logvar"])
    else:
        got = {"params/" + k: v for k, v in checkpoint.torch_to_flax(
            {k: torch.from_numpy(v) for k, v in got.items()}).items()}
    assert set(got) == set(want)
    for k in want:
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= _bar(want[k], want), (k, err, _bar(want[k], want))


def _port_vae_flat(grads):
    pre = checkpoint.PREFIXES["vae"]
    return checkpoint.state_dict_to_jax(
        {pre + k[len("params/"):]: torch.from_numpy(v)
         for k, v in grads.items() if k != "logvar"}, "vae2d")


@pytest.mark.parametrize("name", ["vae_params.npz", "disc_params.npz"])
def test_params_after_the_step_match_jax(runs, name):
    want = jckpt.load_params(os.path.join(runs["jax"], name))
    got = jckpt.load_params(os.path.join(runs["port"], name))
    assert _shapes(got["params"]) == _shapes(runs["templates"][name])
    wf, gf = _jax_flat(want), _jax_flat(got)
    grads = _jax_flat(runs["grads"]["jax"][name])
    assert set(gf) == set(wf) == set(grads)
    for k in wf:
        delta = np.abs(wf[k] - runs["start"][name][k])
        err = np.abs(gf[k] - wf[k])
        beyond = err > 2e-6 + 1e-4 * float(delta.max())
        flat_g = np.abs(grads[k]) <= _bar(grads[k], grads)
        assert np.all(flat_g[beyond]) and np.all(
            err[beyond] <= 2 * LR + 1e-6), (k, int(beyond.sum()))
