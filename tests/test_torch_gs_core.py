"""Port parity, scene core: SH, schedules, activations, PLY, KNN, cameras.

Every input is made with numpy from a seed and passed to the JAX package
(the reference) and to its PyTorch port on the CPU; weights cross over by
``params_from_numpy``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiview_inpaint_tpu.gs import cameras as jcameras
from multiview_inpaint_tpu.gs import gaussians as jgaussians
from multiview_inpaint_tpu.ops.knn import knn_mean_sq_dist as jknn
from multiview_inpaint_tpu.utils import schedules as jschedules
from multiview_inpaint_tpu.utils import sh as jsh
from multiview_inpaint_tpu_torch.gs import cameras as tcameras
from multiview_inpaint_tpu_torch.gs import gaussians as tgaussians
from multiview_inpaint_tpu_torch.ops.knn import knn_mean_sq_dist as tknn
from multiview_inpaint_tpu_torch.utils import schedules as tschedules
from multiview_inpaint_tpu_torch.utils import sh as tsh

F32_TOL = dict(rtol=1e-6, atol=1e-6)


def _raw_arrays(n=17, deg=0, seed=0):
    rng = np.random.default_rng(seed)
    m = (deg + 1) ** 2 - 1
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, 1, 3)).astype(np.float32),
            rng.normal(size=(n, m, 3)).astype(np.float32),
            rng.normal(size=(n, 1)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32) * 12.0,
            rng.normal(size=(n, 4)).astype(np.float32))


def _to_numpy(params):
    return {f: np.asarray(getattr(params, f)) for f in tgaussians.FIELDS}


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(64, 3, (deg + 1) ** 2)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = np.asarray(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d)))
    got = tsh.eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_rgb_to_sh_and_schedules_match_jax():
    rgb = np.random.default_rng(1).random((50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tsh.rgb_to_sh(torch.from_numpy(rgb)).numpy(),
        np.asarray(jsh.rgb_to_sh(jnp.asarray(rgb))), **F32_TOL)
    np.testing.assert_allclose(tsh.rgb_to_sh(rgb),
                               np.asarray(jsh.rgb_to_sh(jnp.asarray(rgb))),
                               **F32_TOL)
    p = np.linspace(0.01, 0.99, 33).astype(np.float32)
    np.testing.assert_allclose(
        tschedules.inverse_sigmoid(torch.from_numpy(p)).numpy(),
        np.asarray(jschedules.inverse_sigmoid(jnp.asarray(p))), **F32_TOL)
    for kw in (dict(lr_init=1.6e-4, lr_final=1.6e-6, max_steps=30000),
               dict(lr_init=5e-3, lr_final=5e-5, max_steps=1000,
                    lr_delay_steps=100, lr_delay_mult=0.01),
               dict(lr_init=0.0, lr_final=0.0, max_steps=10)):
        for step in (-1, 0, 7, 50, 999, 30000, 40000):
            want = float(jschedules.expon_lr(step, **kw))
            got = float(tschedules.expon_lr(step, **kw))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12), (kw,
                                                                      step)


def test_from_arrays_and_activations_match_jax():
    arrs = _raw_arrays(n=20, deg=1, seed=2)
    arrs[4][3] = 30.0       # past the clamp of the scaling activation
    jp = jgaussians.from_arrays(*arrs, capacity=32)
    tp = tgaussians.from_arrays(*arrs, capacity=32, device="cpu")
    for f, want in _to_numpy(jp).items():
        np.testing.assert_array_equal(getattr(tp, f).numpy(), want,
                                      err_msg=f)
    assert tp.capacity == jp.capacity and tp.max_sh_degree == 1
    assert int(tp.num_live()) == int(jp.num_live()) == 20
    for act in ("act_opacity", "act_scaling", "act_rotation", "features"):
        np.testing.assert_allclose(getattr(tp, act)().numpy(),
                                   np.asarray(getattr(jp, act)()),
                                   **F32_TOL, err_msg=act)
    # params_from_numpy carries every row across, dead rows included.
    cp = tgaussians.params_from_numpy(_to_numpy(jp), "cpu")
    for f, want in _to_numpy(jp).items():
        np.testing.assert_array_equal(getattr(cp, f).numpy(), want)
    with pytest.raises(KeyError):
        tgaussians.params_from_numpy({"xyz": arrs[0]}, "cpu")


def test_ply_byte_identical_both_ways(tmp_path):
    arrs = _raw_arrays(n=23, deg=3, seed=4)
    jp = jgaussians.from_arrays(*arrs, capacity=40)
    tp = tgaussians.params_from_numpy(_to_numpy(jp), "cpu")
    pj, pt = str(tmp_path / "jax.ply"), str(tmp_path / "torch.ply")
    jgaussians.save_ply(jp, pj)
    tgaussians.save_ply(tp, pt)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    # Each file loads in both packages with the same rows.
    for path in (pj, pt):
        a = jgaussians.load_ply(path, max_sh_degree=3)
        b = tgaussians.load_ply(path, max_sh_degree=3, device="cpu")
        for f, want in _to_numpy(a).items():
            np.testing.assert_array_equal(getattr(b, f).numpy(), want)
        np.testing.assert_array_equal(b.xyz.numpy(), arrs[0])


def test_knn_and_create_from_pcd_match_jax():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    cols = rng.random((300, 3)).astype(np.float32)
    want = np.asarray(jknn(jnp.asarray(pts), chunk=128))
    got = tknn(torch.from_numpy(pts), chunk=128).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    jp = jgaussians.create_from_pcd(
        pts, cols, jgaussians.GaussianConfig(max_sh_degree=2), capacity=400)
    tp = tgaussians.create_from_pcd(
        pts, cols, tgaussians.GaussianConfig(max_sh_degree=2), capacity=400,
        device="cpu")
    for f, want_f in _to_numpy(jp).items():
        np.testing.assert_allclose(getattr(tp, f).numpy(), want_f,
                                   rtol=1e-4, atol=1e-6, err_msg=f)


def test_camera_matrices_match_jax():
    rng = np.random.default_rng(6)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    from multiview_inpaint_tpu_torch.gs import colmap
    R = colmap.qvec2rotmat(q)
    T = rng.normal(size=3)
    kw = dict(fovx=0.9, fovy=0.6, width=96, height=64)
    a = jcameras.make_camera(0, R, T, **kw)
    b = tcameras.make_camera(0, R, T, **kw)
    for prop in ("world_view", "full_proj", "camera_center"):
        np.testing.assert_array_equal(getattr(b, prop), getattr(a, prop))
    assert (b.tan_half_fovx, b.tan_half_fovy) == (a.tan_half_fovx,
                                                  a.tan_half_fovy)
