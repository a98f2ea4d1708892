"""Port parity, GS training: ``gs/densify``, ``models/gs_trainer`` and
``gs/checkpoint`` against the JAX package on the CPU.

States come from numpy seeds and go through both packages; the split
resamples of densification take JAX's own normal draws, injected through
``noise``. Bars: densify's ``live``, ``moment_reset`` and counts exactly,
its floats within 1e-6; one train step's loss within 1e-5 relative, its
gradients (read from the Adam moments) and the densification statistics
at 2e-6 + 1e-4 max|g| (``tests/test_rasterizer.py:308-330``).

Params after one step: at step 1 Adam's update is lr * m/(sqrt(v)+eps)
with m = 0.1 g and v = 0.001 g^2, i.e. lr * sign(g). An entry whose |g|
lies under the gradient bar may take the other sign (or 0) in one
package, so it may differ by up to 2 lr; every other entry must match
within 1e-6 + 1e-3 lr.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiview_inpaint_tpu.gs import cameras as jcameras
from multiview_inpaint_tpu.gs import checkpoint as jckpt
from multiview_inpaint_tpu.gs import densify as jdensify
from multiview_inpaint_tpu.gs import gaussians as jgaussians
from multiview_inpaint_tpu.models import gs_trainer as jtrainer
from multiview_inpaint_tpu.ops import rasterizer as jr
from multiview_inpaint_tpu.utils import sh as jsh
from multiview_inpaint_tpu.utils.schedules import inverse_sigmoid
from multiview_inpaint_tpu_torch.gs import checkpoint as tckpt
from multiview_inpaint_tpu_torch.gs import densify as tdensify
from multiview_inpaint_tpu_torch.gs import gaussians as tgaussians
from multiview_inpaint_tpu_torch.models import gs_trainer as ttrainer
from multiview_inpaint_tpu_torch.ops import rasterizer as tr
from multiview_inpaint_tpu_torch.ops.rasterizer import project_cuda

FIELDS = ("xyz", "features_dc", "features_rest", "opacity", "scaling",
          "rotation")
BG = [0.1, 0.2, 0.3]
FLOAT_TOL = 1e-6


def _port(jp):
    return tgaussians.params_from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in tgaussians.FIELDS}, "cpu")


def _port_stats(js):
    return tdensify.DensifyStats(
        grad_accum=torch.tensor(np.asarray(js.grad_accum)),
        denom=torch.tensor(np.asarray(js.denom)),
        max_radii2d=torch.tensor(np.asarray(js.max_radii2d)))


def _logit(p):
    return float(inverse_sigmoid(jnp.asarray(p)))


# --- densification: the scenarios of tests/test_train_gs.py:40-127 ------

def _params(n=4, capacity=8, scale=0.05, opacity=0.8, seed=0):
    rng = np.random.default_rng(seed)
    dc = np.asarray(jsh.rgb_to_sh(jnp.asarray(
        rng.random((n, 3))))).reshape(n, 1, 3)
    return jgaussians.from_arrays(
        rng.normal(size=(n, 3)).astype(np.float32), dc,
        np.zeros((n, 0, 3), np.float32), np.full((n, 1), _logit(opacity)),
        np.full((n, 3), np.log(scale), np.float32),
        np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        capacity=capacity)


def _stats(capacity, hot_rows=(), radii=None):
    ga = np.zeros(capacity, np.float32)
    ga[list(hot_rows)] = 1.0
    mr = np.zeros(capacity, np.int32)
    if radii:
        for r, v in radii.items():
            mr[r] = v
    return jdensify.DensifyStats(
        grad_accum=jnp.asarray(ga),
        denom=jnp.ones(capacity, jnp.float32) if hot_rows
        else jnp.zeros(capacity, jnp.float32),
        max_radii2d=jnp.asarray(mr))


def _mixed():
    """Clones, splits and prunes at once, with pruned slots reused and
    random rotations: 40 live rows in 64."""
    rng = np.random.default_rng(7)
    n, cap = 40, 64
    op = rng.uniform(0.01, 0.9, (n, 1))
    op[::7] = 0.002      # faint rows, some of them hot: pruned and cloned
    jp = jgaussians.from_arrays(
        rng.normal(size=(n, 3)).astype(np.float32),
        rng.normal(size=(n, 1, 3)).astype(np.float32),
        np.zeros((n, 0, 3), np.float32),
        np.asarray(inverse_sigmoid(jnp.asarray(op))).astype(np.float32),
        np.log(rng.uniform(0.001, 0.015, (n, 3))).astype(np.float32),
        rng.normal(size=(n, 4)).astype(np.float32), capacity=cap)
    ga = np.zeros(cap, np.float32)
    ga[:n] = rng.uniform(0.0, 1.0, n)
    js = jdensify.DensifyStats(grad_accum=jnp.asarray(ga),
                               denom=jnp.ones(cap, jnp.float32),
                               max_radii2d=jnp.zeros(cap, jnp.int32))
    return jp, js


def _scenario(name):
    """(params, stats, key, max_screen_size) of each scenario."""
    if name == "clone":
        return _params(scale=0.005), _stats(8, [1]), 0, None
    if name == "split":
        return _params(scale=0.5), _stats(8, [2]), 1, None
    if name == "prune":
        p = _params(opacity=0.9)
        p = dataclasses.replace(p, opacity=p.opacity.at[3, 0].set(
            _logit(0.001)))
        return p, _stats(8), 2, None
    if name == "big_screen":
        p = _params(scale=0.05)
        p = dataclasses.replace(p, scaling=p.scaling.at[0].set(np.log(0.3)))
        return p, _stats(8, radii={1: 50}), 3, 20
    if name == "overflow":
        return _params(n=7, scale=0.005), _stats(8, range(7)), 4, None
    jp, js = _mixed()
    return jp, js, 5, None


@pytest.mark.parametrize("name", ["clone", "split", "prune", "big_screen",
                                  "overflow", "mixed"])
def test_densify_and_prune_matches_jax(name):
    jp, js, seed, max_screen = _scenario(name)
    key = jax.random.key(seed)
    kw = dict(grad_threshold=0.5, min_opacity=0.005, extent=1.0,
              max_screen_size=max_screen)
    want = jdensify.densify_and_prune(jp, js, key, **kw)
    # The same normal draws as the JAX resamples.
    k1, k2 = jax.random.split(key)
    noise = tuple(torch.tensor(np.asarray(jax.random.normal(k, (
        jp.capacity, 3)))) for k in (k1, k2))
    got = tdensify.densify_and_prune(_port(jp), _port_stats(js), noise=noise,
                                     **kw)
    for f in ("n_cloned", "n_split", "n_pruned", "wanted_slots",
              "granted_slots"):
        assert getattr(got, f) == int(getattr(want, f)), f
    np.testing.assert_array_equal(got.params.live.numpy(),
                                  np.asarray(want.params.live))
    np.testing.assert_array_equal(got.moment_reset.numpy(),
                                  np.asarray(want.moment_reset))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got.params, f).numpy(),
                                   np.asarray(getattr(want.params, f)),
                                   atol=FLOAT_TOL, err_msg=f)
    for f in ("grad_accum", "denom", "max_radii2d"):
        assert not getattr(got.stats, f).any()
    if name == "overflow":
        assert got.granted_slots < got.wanted_slots
        jq, jst = jdensify.grow_capacity(want.params, want.stats, 16)
        tq, tst = tdensify.grow_capacity(got.params, got.stats, 16)
        for f in tgaussians.FIELDS:
            np.testing.assert_allclose(getattr(tq, f).numpy(),
                                       np.asarray(getattr(jq, f)),
                                       atol=FLOAT_TOL, err_msg=f)
        assert tq.capacity == 16 and tst.denom.shape == (16,)
    if name == "mixed":
        assert got.n_cloned and got.n_split and got.n_pruned


def test_reset_opacity_matches_jax():
    jp = _params(opacity=0.9)
    jq, jmask = jdensify.reset_opacity(jp)
    tq, tmask = tdensify.reset_opacity(_port(jp))
    np.testing.assert_allclose(tq.opacity.numpy(), np.asarray(jq.opacity),
                               atol=FLOAT_TOL)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


# --- one train step ------------------------------------------------------

def _train_scene(n=120, capacity=128, seed=3):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.2, 1.2, size=(n, 3))
    xyz[:, 2] = rng.uniform(-0.5, 1.5, size=n)
    dc = np.asarray(jsh.rgb_to_sh(jnp.asarray(rng.random((n, 3)))))
    return jgaussians.from_arrays(
        xyz.astype(np.float32), dc.reshape(n, 1, 3).astype(np.float32),
        np.zeros((n, 0, 3), np.float32),
        np.asarray(inverse_sigmoid(jnp.asarray(
            rng.uniform(0.2, 0.9, (n, 1))))).astype(np.float32),
        np.log(rng.uniform(0.03, 0.15, (n, 3))).astype(np.float32),
        rng.normal(size=(n, 4)).astype(np.float32), capacity=capacity)


def _step_inputs(width=64, height=48, seed=0):
    cam = jcameras.make_camera(0, np.eye(3), np.array([0.0, 0.0, 4.0]),
                               fovx=0.8, fovy=0.7, width=width,
                               height=height)
    rng = np.random.default_rng(seed)
    gt = rng.random((height, width, 3)).astype(np.float32)
    mask = np.zeros((height, width), np.float32)
    mask[:, width // 2:] = 1.0
    return cam, gt, mask


def _grad_bar(want):
    return 2e-6 + 1e-4 * np.abs(want).max(initial=0.0)


def _jax_and_port_steps(jp, loss_mode="full", spatial=1.3):
    """One train step of each package on the same state and camera."""
    cam, gt, mask = _step_inputs()
    jnew, jm = jtrainer.train_step(
        jtrainer.init_state(jp), jr.RenderCamera.from_camera(cam),
        jnp.asarray(gt), jnp.asarray(BG, jnp.float32),
        jtrainer.OptimizationConfig(), spatial, mask=jnp.asarray(mask),
        loss_mode=loss_mode, max_per_tile=1024, pair_budget_mult=64)
    tnew, tm = ttrainer.train_step(
        ttrainer.init_state(_port(jp)),
        tr.RenderCamera.from_camera(cam, "cpu"), torch.from_numpy(gt),
        torch.tensor(BG), ttrainer.OptimizationConfig(), spatial,
        mask=torch.from_numpy(mask), loss_mode=loss_mode)
    return (jnew, jm), (tnew, tm)


def _assert_step_matches(jax_step, port_step, spatial=1.3,
                         same_nonfinite=True):
    """Loss, counts, moments, params and densify statistics at the bars of
    the module docstring. A NaN param entry must be NaN in both. With
    ``same_nonfinite`` False the non-finite gradient counts are left to
    the caller."""
    (jnew, jm), (tnew, tm) = jax_step, port_step
    assert abs(float(tm.loss) - float(jm.loss)) <= 1e-5 * abs(float(jm.loss))
    assert abs(float(tm.l1) - float(jm.l1)) <= 1e-5 * abs(float(jm.l1))
    assert tm.pairs == int(jm.pairs) > 0
    assert int(tm.num_live) == int(jm.num_live)
    if same_nonfinite:
        assert int(tm.nonfinite_grads) == int(jm.nonfinite_grads)
    assert tnew.step == int(jnew.step) == 1

    lrs = jtrainer._group_lrs(jtrainer.OptimizationConfig(), jnp.int32(1),
                              spatial)
    for f in FIELDS:
        # At step 1, mu = 0.1 g and nu = 0.001 g^2: both give back g.
        g_want = np.asarray(jnew.mu[f]) / 0.1
        bar = _grad_bar(g_want)
        np.testing.assert_allclose(tnew.mu[f].numpy() / 0.1, g_want,
                                   atol=bar, err_msg=f"mu {f}")
        np.testing.assert_allclose(np.sqrt(tnew.nu[f].numpy() / 0.001),
                                   np.sqrt(np.asarray(jnew.nu[f]) / 0.001),
                                   atol=bar, err_msg=f"nu {f}")
        lr = float(lrs[f])
        got = getattr(tnew.params, f).numpy()
        want = np.asarray(getattr(jnew.params, f))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), f)
        diff = np.abs(np.nan_to_num(got) - np.nan_to_num(want))
        small = np.abs(g_want) <= bar
        assert (diff[small] <= 2 * lr + 1e-6).all(), f
        assert (diff[~small] <= 1e-6 + 1e-3 * lr).all(), f
    ga = np.asarray(jnew.stats.grad_accum)
    np.testing.assert_allclose(tnew.stats.grad_accum.numpy(), ga,
                               atol=_grad_bar(ga))
    np.testing.assert_array_equal(tnew.stats.denom.numpy(),
                                  np.asarray(jnew.stats.denom))
    np.testing.assert_array_equal(tnew.stats.max_radii2d.numpy(),
                                  np.asarray(jnew.stats.max_radii2d))


@pytest.mark.parametrize("loss_mode", ["full", "background"])
def test_train_step_matches_jax(loss_mode, monkeypatch):
    """Also: the port's step projects through the projection's autograd
    Function, whose backward on the CPU is K7's plain version."""
    calls = []

    def bwd_ref(*args):
        calls.append(1)
        return project_cuda.project_bwd_ref(*args)

    monkeypatch.setattr(project_cuda, "project_bwd", bwd_ref)
    jax_step, port_step = _jax_and_port_steps(_train_scene(), loss_mode)
    assert len(calls) == 1
    _assert_step_matches(jax_step, port_step)
    assert int(port_step[1].num_live) == 120
    assert int(port_step[1].nonfinite_grads) == 0


def test_train_step_zeroes_and_counts_nonfinite_gradients():
    """A NaN row stays quarantined: its gradients are zero, the moments
    stay finite (the reference's 5413b48 fix) and every other number is
    JAX's. JAX's projection gives the culled row non-finite xyz, scaling
    and rotation gradients (3 + 3 + 4), which its step zeroes and counts;
    the port's projection backward gives a culled row exact zeros, so
    there are none to count."""
    jp = _train_scene(n=40, capacity=48, seed=4)
    jp = dataclasses.replace(jp, scaling=jp.scaling.at[5].set(jnp.nan))
    jax_step, port_step = _jax_and_port_steps(jp)
    _assert_step_matches(jax_step, port_step, same_nonfinite=False)
    assert int(jax_step[1].nonfinite_grads) == 10
    new, m = port_step
    assert int(m.nonfinite_grads) == 0
    assert torch.isfinite(m.loss)
    for f in FIELDS:
        assert torch.isfinite(new.mu[f]).all() and \
            torch.isfinite(new.nu[f]).all(), f
        assert not new.mu[f][5].any() and not new.nu[f][5].any(), f


# --- checkpoints -----------------------------------------------------------

def _stepped_jax_state():
    jp = _train_scene(n=60, capacity=64, seed=5)
    cam, gt, _ = _step_inputs(seed=1)
    state, _ = jtrainer.train_step(
        jtrainer.init_state(jp), jr.RenderCamera.from_camera(cam),
        jnp.asarray(gt), jnp.asarray(BG, jnp.float32),
        jtrainer.OptimizationConfig(), 1.0, max_per_tile=1024,
        pair_budget_mult=64)
    return state, cam, gt


def _assert_states_equal(t_state, j_state):
    for f in FIELDS:
        for name, a, b in (("param", getattr(t_state.params, f),
                            getattr(j_state.params, f)),
                           ("mu", t_state.mu[f], j_state.mu[f]),
                           ("nu", t_state.nu[f], j_state.nu[f])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{name} {f}")
    np.testing.assert_array_equal(t_state.params.live.numpy(),
                                  np.asarray(j_state.params.live))
    for f in ("grad_accum", "denom", "max_radii2d"):
        np.testing.assert_array_equal(getattr(t_state.stats, f).numpy(),
                                      np.asarray(getattr(j_state.stats, f)))
    assert t_state.step == int(j_state.step)


def test_jax_checkpoint_loads_into_port_and_resumes(tmp_path):
    jstate, cam, gt = _stepped_jax_state()
    path = str(tmp_path / "chkpnt1.npz")
    jckpt.save_train_state(path, jstate)
    tstate = tckpt.load_train_state(path, "cpu")
    _assert_states_equal(tstate, jstate)
    resumed, m = ttrainer.train_step(
        tstate, tr.RenderCamera.from_camera(cam, "cpu"),
        torch.from_numpy(gt), torch.tensor(BG),
        ttrainer.OptimizationConfig(), 1.0)
    assert resumed.step == 2 and torch.isfinite(m.loss)


def test_port_checkpoint_loads_into_jax(tmp_path):
    jstate, cam, gt = _stepped_jax_state()
    tstate, _ = ttrainer.train_step(
        ttrainer.init_state(_port(jstate.params)),
        tr.RenderCamera.from_camera(cam, "cpu"), torch.from_numpy(gt),
        torch.tensor(BG), ttrainer.OptimizationConfig(), 1.0)
    path = str(tmp_path / "chkpnt.npz")
    tckpt.save_train_state(path, tstate)
    _assert_states_equal(tstate, jckpt.load_train_state(path))
