"""Port parity, the distributed GS paths: ``parallel/{mesh,render_parallel,
gs_data_parallel,gs_band_train}`` over ``torch.distributed`` (gloo, two
CPU processes) against the JAX package's functions on a 2-device mesh
(``make_mesh(2)`` over the virtual CPU devices of ``tests/conftest.py``),
on the scene and cameras of ``__graft_entry__.dryrun_multichip``.

One spawn of two ranks runs every port path (the process start-up is paid
once) while this process runs the JAX ones; rank 0 writes its results to
an npz. Bars, the dry run's own where it has one:
- the data-parallel step on two views (one per rank): loss within 1e-6
  relative, xyz within 3e-5 relative + 3e-6;
- the sharded orbit render of 3 views (padded to 4): rgb within 1e-6;
- the band-sharded frame: rgb within 2e-6, pairs equal;
- the band-sharded train step: loss within 1e-6 relative, xyz within
  3e-5 relative + 3e-6;
- the ZeRO band step: the same, each rank holding only N/2 rows of the
  moments and statistics, and those rows gathered equal to the band
  step's;
- the ``render`` CLI with ``--shard_views`` at world size 2 (rank 0
  writes) and at world size 1 writes the same PNG bytes as ``render``.
"""

import dataclasses
import multiprocessing
import os
import shutil
import socket

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _tiny_scene
from multiview_inpaint_tpu.gs.cameras import make_camera as jmake_camera
from multiview_inpaint_tpu.models import gs_trainer as jtrainer
from multiview_inpaint_tpu.ops.rasterizer import RenderCamera as JCamera
from multiview_inpaint_tpu.ops.rasterizer import render as jrender
from multiview_inpaint_tpu.parallel import make_mesh
from multiview_inpaint_tpu.parallel import gs_band_train as jband
from multiview_inpaint_tpu.parallel import gs_data_parallel as jdp
from multiview_inpaint_tpu.parallel import render_parallel as jrp

W = H = 32
HB = 32          # the band step's frame height: 16 * max(D, 2)
N_VIEWS = 3      # the orbit render: one view of padding at D = 2
TIMEOUT = 240


def _cam_spec(i, rng):
    ang = 0.3 * i
    r = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    return dict(uid=i, R=r.T, T=-r @ np.array([0.0, 0, -3.0]), fovx=0.8,
                fovy=0.8, width=W, height=H,
                image=rng.random((H, W, 3)).astype(np.float32))


def _spec():
    rng = np.random.default_rng(0)
    cams = [_cam_spec(i, rng) for i in range(N_VIEWS)]
    band = dict(cams[0], height=HB,
                image=rng.random((HB, W, 3)).astype(np.float32))
    jp = _tiny_scene(n=128, capacity=256)
    arrays = {f: np.asarray(getattr(jp, f)) for f in
              ("xyz", "features_dc", "features_rest", "opacity", "scaling",
               "rotation", "live")}
    return dict(cams=cams, band=band, arrays=arrays), jp


def _port_paths(spec, scene_dir, model_dir):
    """Every port path at this process's rank; the results as numpy."""
    from multiview_inpaint_tpu_torch.gs import gaussians
    from multiview_inpaint_tpu_torch.gs.cameras import make_camera
    from multiview_inpaint_tpu_torch.models import gs_trainer
    from multiview_inpaint_tpu_torch.ops.rasterizer import RenderCamera
    from multiview_inpaint_tpu_torch.parallel import mesh
    from multiview_inpaint_tpu_torch.parallel.gs_band_train import (
        band_train_step, gather_zero_state)
    from multiview_inpaint_tpu_torch.parallel.gs_data_parallel import (
        CameraBatch, dp_train_step, shard_for_dp)
    from multiview_inpaint_tpu_torch.parallel.render_parallel import (
        render_frame_sharded, render_views_sharded)
    from multiview_inpaint_tpu_torch.pipelines import render as render_cli

    params = gaussians.params_from_numpy(spec["arrays"], "cpu")
    cams = [make_camera(**c) for c in spec["cams"]]
    bg = torch.zeros(3)
    cfg = gs_trainer.OptimizationConfig()
    res = {}

    # the view-batch data-parallel step: one view per rank
    state, batch = shard_for_dp(gs_trainer.init_state(params),
                                CameraBatch.from_cameras(cams[:2], "cpu"))
    new, loss = dp_train_step(state, batch, bg, cfg, 1.0,
                              cams[0].tan_half_fovx, cams[0].tan_half_fovy,
                              W, H)
    res["dp_loss"], res["dp_xyz"] = loss.numpy(), new.params.xyz.numpy()

    with torch.no_grad():
        out = render_views_sharded(params, cams, bg, device="cpu")
        res["orbit_rgb"] = out.rgb.numpy()
        out = render_frame_sharded(params, cams[0], bg, device="cpu")
        res["frame_rgb"], res["frame_pairs"] = out.rgb.numpy(), out.pairs

    band_cam = make_camera(**spec["band"])
    rcam = RenderCamera.from_camera(band_cam, "cpu")
    gt = torch.from_numpy(band_cam.image)
    st0 = gs_trainer.init_state(params)
    b_state, b_m = band_train_step(st0, rcam, gt, bg, cfg, 1.0)
    res["band_loss"], res["band_xyz"] = (b_m.loss.numpy(),
                                         b_state.params.xyz.numpy())
    res["band_pairs"] = b_m.pairs
    z_state, z_m = band_train_step(st0, rcam, gt, bg, cfg, 1.0,
                                   zero_sharded=True)
    res["zero_loss"], res["zero_xyz"] = (z_m.loss.numpy(),
                                         z_state.params.xyz.numpy())
    res["zero_rows"] = [v.shape[0] for v in z_state.mu.values()] + [
        z_state.stats.grad_accum.shape[0]]
    full = gather_zero_state(z_state)
    res["zero_moments_equal"] = all(
        torch.equal(full.mu[f], b_state.mu[f])
        and torch.equal(full.nu[f], b_state.nu[f]) for f in full.mu) and \
        torch.equal(full.stats.grad_accum, b_state.stats.grad_accum) and \
        torch.equal(full.stats.max_radii2d, b_state.stats.max_radii2d)
    res["zero_nonfinite"] = int(z_m.nonfinite_grads)
    res["band_nonfinite"] = int(b_m.nonfinite_grads)

    render_cli.main(["-s", scene_dir, "-m", model_dir, "--resolution", "1",
                     "--skip_test", "--shard_views", "--device", "cpu"])
    res["world"] = mesh.world()
    return res


def _worker(rank, world, port, spec, out_dir):
    import torch.distributed as dist

    from multiview_inpaint_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    mesh.init(rank, world, f"tcp://127.0.0.1:{port}", "cpu")
    try:
        res = _port_paths(spec, os.path.join(out_dir, "scene"),
                          os.path.join(out_dir, "model_sharded"))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **{k: np.asarray(v) for k, v in res.items()})
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _model(root, name, ply):
    dst = os.path.join(root, name, "point_cloud", "iteration_7",
                       "point_cloud.ply")
    os.makedirs(os.path.dirname(dst))
    shutil.copy(ply, dst)
    return os.path.join(root, name)


def _jax_paths(spec, jp):
    mesh = make_mesh(2)
    cams = [jmake_camera(**c) for c in spec["cams"]]
    bg = jnp.zeros(3, jnp.float32)
    cfg = jtrainer.OptimizationConfig()
    res = {}
    with mesh:
        state, batch = jdp.shard_for_dp(
            jtrainer.init_state(jp), jdp.CameraBatch.from_cameras(cams[:2]),
            mesh)
        new, loss = jdp.dp_train_step(
            state, batch, bg, cfg, spatial_lr_scale=1.0,
            tan_fovx=cams[0].tan_half_fovx, tan_fovy=cams[0].tan_half_fovy,
            width=W, height=H, sh_degree=0, max_per_tile=128,
            pair_budget_mult=8)
    res["dp_loss"], res["dp_xyz"] = float(loss), np.asarray(new.params.xyz)
    kw = dict(sh_degree=0, max_per_tile=128, pair_budget=8 * jp.capacity)
    res["orbit_rgb"] = np.asarray(
        jrp.render_views_sharded(jp, cams, bg, mesh, **kw).rgb)
    frame = jrp.render_frame_sharded(jp, JCamera.from_camera(cams[0]), bg,
                                     mesh, **kw)
    res["frame_rgb"], res["frame_pairs"] = (np.asarray(frame.rgb),
                                            int(frame.pairs))
    full = jrender(jp, JCamera.from_camera(cams[0]), bg, **kw)
    res["full_pairs"] = int(full.pairs)
    band_cam = jmake_camera(**spec["band"])
    st0 = jtrainer.init_state(jp)
    args = (st0, JCamera.from_camera(band_cam), jnp.asarray(band_cam.image),
            bg, cfg)
    b_state, b_m = jband.band_train_step(*args, spatial_lr_scale=1.0,
                                         mesh=mesh, max_per_tile=128,
                                         pair_budget_mult=8)
    res["band_loss"], res["band_xyz"] = (float(b_m.loss),
                                         np.asarray(b_state.params.xyz))
    res["band_pairs"] = int(b_m.pairs)
    z_state, z_m = jband.band_train_step(*args, spatial_lr_scale=1.0,
                                         mesh=mesh, max_per_tile=128,
                                         pair_budget_mult=8,
                                         zero_sharded=True)
    res["zero_loss"], res["zero_xyz"] = (float(z_m.loss),
                                         np.asarray(z_state.params.xyz))
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from multiview_inpaint_tpu.gs import gaussians as jgaussians
    from multiview_inpaint_tpu.utils import synthetic as jsynthetic

    root = str(tmp_path_factory.mktemp("parallel"))
    jsynthetic.make_colmap_scene(os.path.join(root, "scene"), n_views=3)
    ply = os.path.join(root, "gt.ply")
    jgaussians.save_ply(jsynthetic.make_gt_gaussians(n=48, seed=1), ply)
    for name in ("model_sharded", "model_plain", "model_one"):
        _model(root, name, ply)
    spec, jp = _spec()
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, 2, port, spec, root))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        want = _jax_paths(spec, jp)
    finally:
        for p in procs:
            p.join(TIMEOUT)
    for p in procs:
        assert not p.is_alive() and p.exitcode == 0, p.exitcode
    got = [dict(np.load(os.path.join(root, f"rank{r}.npz")))
           for r in range(2)]
    return got, want, root


def _rel(got, want, rtol):
    assert abs(float(got) - float(want)) <= rtol * abs(float(want))


def test_dp_train_step_matches_jax_mesh(runs):
    (got, _), want, _ = runs
    assert int(got["world"]) == 2
    _rel(got["dp_loss"], want["dp_loss"], 1e-6)
    np.testing.assert_allclose(got["dp_xyz"], want["dp_xyz"], rtol=3e-5,
                               atol=3e-6)


def test_orbit_render_sharded_with_padding_matches_jax(runs):
    (got, other), want, _ = runs
    assert got["orbit_rgb"].shape == (N_VIEWS, H, W, 3)
    np.testing.assert_array_equal(got["orbit_rgb"], other["orbit_rgb"])
    np.testing.assert_allclose(got["orbit_rgb"], want["orbit_rgb"],
                               atol=1e-6)


def test_band_sharded_frame_matches_jax(runs):
    (got, _), want, _ = runs
    np.testing.assert_allclose(got["frame_rgb"], want["frame_rgb"],
                               atol=2e-6)
    assert int(got["frame_pairs"]) == want["frame_pairs"] \
        == want["full_pairs"]


@pytest.mark.parametrize("kind", ["band", "zero"])
def test_band_train_step_matches_jax_mesh(runs, kind):
    (got, other), want, _ = runs
    _rel(got[f"{kind}_loss"], want[f"{kind}_loss"], 1e-6)
    np.testing.assert_allclose(got[f"{kind}_xyz"], want[f"{kind}_xyz"],
                               rtol=3e-5, atol=3e-6)
    # every rank ends with the same parameters
    np.testing.assert_array_equal(got[f"{kind}_xyz"], other[f"{kind}_xyz"])
    assert int(got["band_pairs"]) == want["band_pairs"]
    assert int(got[f"{kind}_nonfinite"]) == 0


def test_zero_step_holds_half_the_rows(runs):
    (got, other), _, _ = runs
    n = _tiny_scene(n=128, capacity=256).capacity
    for r in (got, other):
        assert list(r["zero_rows"]) == [n // 2] * 7
        assert bool(r["zero_moments_equal"])


def test_render_cli_shard_views_writes_the_same_pngs(runs):
    from multiview_inpaint_tpu_torch.pipelines import render as render_cli

    _, _, root = runs
    base = ["-s", os.path.join(root, "scene"), "--resolution", "1",
            "--skip_test", "--device", "cpu"]
    render_cli.main(base + ["-m", os.path.join(root, "model_plain")])
    render_cli.main(base + ["-m", os.path.join(root, "model_one"),
                            "--shard_views"])
    sub = os.path.join("train", "ours_7", "renders")
    want_dir = os.path.join(root, "model_plain", sub)
    names = sorted(os.listdir(want_dir))
    assert len(names) == 3
    for model in ("model_sharded", "model_one"):
        got_dir = os.path.join(root, model, sub)
        assert sorted(os.listdir(got_dir)) == names
        for n in names:
            with open(os.path.join(got_dir, n), "rb") as a, \
                    open(os.path.join(want_dir, n), "rb") as b:
                assert a.read() == b.read(), (model, n)
