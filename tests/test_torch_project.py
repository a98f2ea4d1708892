"""The projection's paths on the CPU: the K6 wrapper
(``project_cuda.project``) and ``api.project``, with and without a
gradient, against the plain version of the projection kernel (K6),
``project_cuda.project_ref``, which is ``api.project``'s computation
from before K6, bit for bit; the plain version of its backward (K7),
``project_cuda.project_bwd_ref``, against autograd through
``project_ref``; the autograd Function that joins them
(``project_cuda.project_grad``) with the plain versions, alone and in a
train step; and the choice ``api.project`` makes between the Function
and the plain ops, by the camera's gradient. K6 and K7 themselves run
only on the card (``tests/test_torch_cuda.py``). No JAX is imported.
"""

import dataclasses

import numpy as np
import pytest
import torch

import projection_cases as cases
from multiview_inpaint_tpu_torch import telemetry
from multiview_inpaint_tpu_torch.gs import cameras
from multiview_inpaint_tpu_torch.gs.gaussians import PARAM_FIELDS
from multiview_inpaint_tpu_torch.models import gs_trainer
from multiview_inpaint_tpu_torch.ops.rasterizer import (RenderCamera, api,
                                                        geometry,
                                                        project_cuda)
from multiview_inpaint_tpu_torch.utils import synthetic

FIELDS = geometry.ProjectedGaussians._fields
OUTS = [name for name, _ in project_cuda.COTANGENTS]


@pytest.fixture(autouse=True)
def fresh():
    telemetry.reset()
    yield
    telemetry.reset()


def _camera():
    return RenderCamera.from_camera(cases.camera(), "cpu")


def _leaf(p, field):
    return dataclasses.replace(
        p, **{field: getattr(p, field).clone().requires_grad_(True)})


def _detached(proj):
    return proj._replace(**{f: getattr(proj, f).detach() for f in FIELDS})


def _assert_same(got, want):
    for f in FIELDS:
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=0, equal_nan=True,
                                   msg=f"field {f}")


@pytest.mark.parametrize("scaling_modifier", [1.0, 0.6])
@pytest.mark.parametrize("sh_degree,max_sh_degree",
                         [(0, 0), (0, 3), (1, 3), (2, 3), (3, 3)])
def test_cpu_paths_give_the_plain_projection(sh_degree, max_sh_degree,
                                             scaling_modifier):
    p = cases.hard_scene(n=700, max_sh_degree=max_sh_degree)
    cam = _camera()
    want = project_cuda.project_ref(p, cam, sh_degree, scaling_modifier)
    _assert_same(project_cuda.project(p, cam, sh_degree, scaling_modifier),
                 want)
    with torch.no_grad():
        _assert_same(api.project(p, cam, sh_degree, scaling_modifier), want)
    grad = api.project(_leaf(p, "xyz"), cam, sh_degree, scaling_modifier)
    assert grad.means2d.requires_grad
    _assert_same(_detached(grad), want)
    assert telemetry.snapshot()["counters"]["project.plain"] == 3
    vis = want.radius > 0
    # The scene's special rows: culled (behind, in the camera's plane,
    # non-finite, dead) and kept (near-plane neighbours and clamped).
    assert not vis[[0, 4, 5, 6, 13, 14]].any()
    assert vis[[2, 3, 9, 11, 12]].all()
    assert bool(vis[15:700].any()) and not vis[700:].any()
    assert int(want.extent[10].abs().sum()) == 0    # opacity under 1/255


def test_api_project_counts_the_plain_path():
    p = cases.hard_scene(n=300)
    cam = _camera()
    with torch.no_grad():
        api.project(p, cam, 3)
    api.project(p, cam, 1)
    counters = telemetry.snapshot()["counters"]
    assert counters["project.plain"] == 2
    assert counters.get("launch.project", 0) == 0


def test_api_project_keeps_the_gradient_on_the_plain_path():
    p = cases.hard_scene(n=300)
    xyz = p.xyz.clone().requires_grad_(True)
    p = dataclasses.replace(p, xyz=xyz)
    offset = torch.zeros((p.capacity, 2), requires_grad=True)
    proj = api.project(p, _camera(), 2, means2d_offset=offset)
    vis = proj.radius > 0
    (proj.means2d[vis].sum() + proj.color[vis].sum()).backward()
    assert torch.isfinite(xyz.grad[vis]).all()
    assert xyz.grad[vis].abs().sum() > 0
    assert torch.equal(offset.grad[vis], torch.ones_like(offset.grad[vis]))


@pytest.mark.parametrize("grad,leaf,camera_leaf,offset,plain", [
    (False, False, False, False, False),
    (False, True, False, False, False),
    (False, False, True, False, False),
    (True, False, False, False, False),
    (True, True, False, False, False),
    (True, False, True, False, True),
    (True, False, False, True, False),
    (False, False, False, True, False),
], ids=["no_grad", "no_grad_leaf", "no_grad_camera_leaf", "grad_no_leaf",
        "grad_leaf", "grad_camera_leaf", "offset", "no_grad_offset"])
def test_camera_gradient_decides_the_path(grad, leaf, camera_leaf, offset,
                                          plain, kernels_as_plain):
    """``api.project`` takes the Function (K6 forward, its launch counted
    by the stand-in) in every case but a camera tensor that requires a
    gradient under autograd, which takes the plain ops; the outputs need
    a gradient where a parameter, the offset or the camera does."""
    p = cases.hard_scene(n=50)
    cam = _camera()
    if leaf:
        p = _leaf(p, "features_rest")
    if camera_leaf:
        cam = dataclasses.replace(
            cam, world_view=cam.world_view.clone().requires_grad_(True))
    off = (torch.zeros((p.capacity, 2), requires_grad=True) if offset
           else None)
    with torch.set_grad_enabled(grad):
        assert api.camera_grad(cam) is plain
        proj = api.project(p, cam, 1, means2d_offset=off)
    counters = telemetry.snapshot()["counters"]
    assert counters.get("project.plain", 0) == int(plain)
    assert counters.get("launch.project", 0) == int(not plain)
    assert proj.conic.requires_grad is (grad and (leaf or offset
                                                  or camera_leaf))


@pytest.mark.parametrize("fault", ["float64_xyz", "sh_degree", "live_dtype",
                                   "camera_dtype"])
def test_k6_wrapper_checks_its_inputs(fault):
    p = cases.hard_scene(n=50, max_sh_degree=2)
    cam = _camera()
    sh = 2
    if fault == "float64_xyz":
        p = dataclasses.replace(p, xyz=p.xyz.double())
    elif fault == "sh_degree":
        sh = 3
    elif fault == "live_dtype":
        p = dataclasses.replace(p, live=p.live.float())
    else:
        cam = dataclasses.replace(cam, campos=cam.campos.double())
    with pytest.raises(ValueError):
        project_cuda._check(p, cam, sh)


def test_k6_wrapper_refuses_other_devices():
    p = cases.hard_scene(n=50).to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        project_cuda.project(p, _camera(), 0)


def _leaves(p):
    """Leaf copies of the six fields and a zero offset leaf."""
    leaves = {f: getattr(p, f).clone().requires_grad_(True)
              for f in PARAM_FIELDS}
    offset = torch.zeros((p.capacity, 2), requires_grad=True)
    return dataclasses.replace(p, **leaves), leaves, offset


def _grads_agree(got, want, vis):
    """Culled rows exactly 0; visible rows NaN where ``want`` is NaN (the
    zero quaternion's rotation) and within 1e-5 of the field's largest
    finite entry (and 1e-4 relative) elsewhere. Row 15, whose scale of
    e^20 makes its gradients some 10^6 times the others', is held to its
    own largest entry, apart from the rest."""
    apart = torch.zeros_like(vis)
    apart[15] = True
    for f, g, w in zip(project_cuda.ProjectionGrads._fields, got, want):
        assert not g[~vis].any(), f
        for rows in (vis & ~apart, vis & apart):
            a, b = g[rows], w[rows]
            assert torch.equal(torch.isnan(a), torch.isnan(b)), f
            fin = torch.isfinite(b)
            if not fin.any():
                continue
            bar = 1e-5 * float(b[fin].abs().max())
            torch.testing.assert_close(a[fin], b[fin], rtol=1e-4, atol=bar,
                                       msg=f"field {f}")


@pytest.mark.parametrize("scaling_modifier", [1.0, 0.6])
@pytest.mark.parametrize("sh_degree,max_sh_degree",
                         [(0, 0), (0, 3), (1, 3), (2, 3), (3, 3)])
def test_k7_plain_version_matches_autograd(sh_degree, max_sh_degree,
                                           scaling_modifier):
    """``project_bwd_ref`` against ``torch.autograd.grad`` through
    ``project_ref`` with an offset, on rows culled (behind the camera,
    in its plane, non-finite, dead, a covariance that overflows), kept
    at the clamps and on a clamp's bound, with a zero quaternion, with
    the log-scale at 20, and with colours clamped at 0; under cotangents
    on every output, and on the colour alone (whose gradient into xyz is
    the view direction's, small beside the others)."""
    p = cases.grad_scene(n=500, max_sh_degree=max_sh_degree)
    cam = _camera()
    q, leaves, offset = _leaves(p)
    proj = project_cuda.project_ref(q, cam, sh_degree, scaling_modifier,
                                    offset)
    vis = proj.radius > 0
    assert vis[[2, 3, 9, 11, 12, 15, 17]].all()
    assert not vis[[0, 4, 5, 6, 13, 14]].any()
    assert bool((proj.color[vis] == 0).any())
    every = cases.cotangents(proj)
    colour = [torch.zeros_like(c) for c in every[:3]] + every[3:4] + [
        torch.zeros_like(every[4])]
    for cots in (colour, every):
        want = torch.autograd.grad([getattr(proj, f) for f in OUTS],
                                   [*leaves.values(), offset], cots,
                                   retain_graph=True)
        got = project_cuda.project_bwd_ref(p, cam, sh_degree,
                                           scaling_modifier, proj.radius,
                                           cots)
        _grads_agree(got, want, vis)
    # autograd's 0 * inf on culled rows, which K7 leaves at 0
    assert not all(bool(torch.isfinite(w).all()) for w in want)
    assert float(got.scaling[15, 2]) != 0.0     # half of the tie
    if sh_degree < max_sh_degree:
        assert not got.features_rest[:, (sh_degree + 1) ** 2 - 1:].any()


@pytest.mark.parametrize("sh_degree", [0, 3])
def test_projection_function_wires_the_plain_versions_on_cpu(sh_degree):
    """``project_grad`` on CPU tensors: its forward is ``project_ref``'s
    projection with the offset bit for bit, and its backward is
    ``project_bwd_ref``'s, also where only some outputs are used."""
    p = cases.grad_scene(n=300)
    cam = _camera()
    q, leaves, _ = _leaves(p)
    offset = (0.25 * torch.randn((p.capacity, 2))).requires_grad_(True)
    got = project_cuda.project_grad(q, cam, sh_degree, 0.8, offset)
    want = project_cuda.project_ref(p, cam, sh_degree, 0.8,
                                    offset.detach())
    _assert_same(_detached(got), want)
    assert type(got.means2d.grad_fn).__name__ == "_ProjectFnBackward"
    assert not got.radius.requires_grad and not got.extent.requires_grad
    cots = cases.cotangents(want, seed=1)
    grads = torch.autograd.grad([getattr(got, f) for f in OUTS],
                                [*leaves.values(), offset], cots,
                                retain_graph=True)
    ref = project_cuda.project_bwd_ref(p, cam, sh_degree, 0.8, want.radius,
                                       cots)
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True)
    vis = want.radius > 0
    (g_dc,) = torch.autograd.grad(got.color[vis].sum(),
                                  [leaves["features_dc"]])
    ref = project_cuda.project_bwd_ref(
        p, cam, sh_degree, 0.8, want.radius,
        (None, None, None, vis[:, None].float().expand(-1, 3), None))
    assert torch.equal(g_dc, ref.features_dc)


@pytest.fixture
def kernels_as_plain(monkeypatch):
    """``api.project`` as on a card: K6's and K7's wrappers run their
    plain versions while counting their launches as the kernels'
    wrappers do."""

    def k6(params, camera, sh_degree, scaling_modifier=1.0):
        telemetry.count("launch.project")
        return project_cuda.project_ref(params, camera, sh_degree,
                                        scaling_modifier)

    def k7(*args):
        telemetry.count("launch.project_bwd")
        return project_cuda.project_bwd_ref(*args)

    monkeypatch.setattr(project_cuda, "project", k6)
    monkeypatch.setattr(project_cuda, "project_bwd", k7)


@pytest.mark.parametrize("device,camera_leaf,fn", [
    ("cpu", False, True), ("card", False, True), ("cpu", True, False),
    ("card", True, False)],
    ids=["cpu", "card", "cpu_camera_leaf", "card_camera_leaf"])
def test_api_project_takes_the_function_by_device_and_camera_gradient(
        device, camera_leaf, fn, request):
    """The Function on both devices, its plain versions on the CPU (the
    forward counted ``project.plain`` by K6's wrapper) and the kernels'
    stand-ins on the card; a camera's gradient through the plain ops on
    the CPU, and refused off it (here on ``meta`` tensors, which no
    projection computes on)."""
    if device == "card":
        request.getfixturevalue("kernels_as_plain")
    p = _leaf(cases.hard_scene(n=200), "xyz")
    cam = _camera()
    if camera_leaf:
        cam = dataclasses.replace(
            cam, world_view=cam.world_view.clone().requires_grad_(True))
    if device == "card" and camera_leaf:
        with pytest.raises(ValueError, match="camera tensor requires"):
            api.project(p.to("meta"), cam.to("meta"), 1)
        counters = telemetry.snapshot()["counters"]
        assert counters.get("project.plain", 0) == 0
        assert counters.get("launch.project", 0) == 0
        return
    proj = api.project(p, cam, 1)
    assert (type(proj.means2d.grad_fn).__name__
            == "_ProjectFnBackward") is fn
    vis = proj.radius > 0
    (proj.means2d[vis].sum() + proj.color[vis].sum()
     + proj.depth[vis].sum()).backward()
    assert torch.isfinite(p.xyz.grad[vis]).all()
    if camera_leaf:     # the depths' sum moves one for one with t_z
        assert float(cam.world_view.grad[2, 3]) == float(vis.sum())
    counters = telemetry.snapshot()["counters"]
    card = device == "card"
    assert counters.get("project.plain", 0) == (0 if card else 1)
    assert counters.get("launch.project_bwd", 0) == (1 if card else 0)
    assert counters.get("launch.project", 0) == (1 if card else 0)


def test_cpu_train_step_through_the_function_gives_the_plain_state(
        monkeypatch):
    """One SH-3 ``train_step`` with the projection as the Function (its
    plain versions) against the plain graph's: the same loss and pairs,
    the gradient (Adam's first moment) and second moment within 1e-5 of
    each field's largest, the same densification statistics and, where
    the gradient is clear of rounding, the same parameters."""
    scene = synthetic.with_sh_rest(synthetic.make_gt_gaussians(
        300, seed=3, spread=1.0, device="cpu"), 3)
    g = torch.Generator().manual_seed(4)       # anisotropic, rotated
    scene = dataclasses.replace(
        scene, rotation=torch.randn(scene.rotation.shape, generator=g),
        scaling=scene.scaling + 0.5 * torch.randn(scene.scaling.shape,
                                                  generator=g))
    cam = RenderCamera.from_camera(cameras.make_camera(
        0, np.eye(3), np.array([0.0, 0.0, 3.0]), fovx=0.9, fovy=0.7,
        width=96, height=64), "cpu")
    gt = torch.from_numpy(np.random.default_rng(0).random(
        (64, 96, 3)).astype(np.float32))
    bg = torch.tensor([0.1, 0.2, 0.3])
    cfg = gs_trainer.OptimizationConfig()

    def step():
        return gs_trainer.train_step(gs_trainer.init_state(scene), cam, gt,
                                     bg, cfg, 1.0, sh_degree=3)

    with monkeypatch.context() as m:
        m.setattr(project_cuda, "project_grad", project_cuda.project_ref)
        plain, m_plain = step()
    telemetry.reset()
    fused, m_fused = step()
    assert telemetry.snapshot()["counters"].get("project.plain", 0) == 1
    assert float(m_fused.loss) == float(m_plain.loss)
    assert m_fused.pairs == m_plain.pairs > 0
    assert int(m_fused.nonfinite_grads) <= int(m_plain.nonfinite_grads)
    for f in PARAM_FIELDS:
        for moment in ("mu", "nu"):
            want = getattr(plain, moment)[f]
            bar = 1e-5 * float(want.abs().max())
            torch.testing.assert_close(getattr(fused, moment)[f], want,
                                       rtol=1e-4, atol=bar,
                                       msg=f"{moment} {f}")
        clear = plain.mu[f].abs() > 1e-3 * float(plain.mu[f].abs().max())
        torch.testing.assert_close(getattr(fused.params, f)[clear],
                                   getattr(plain.params, f)[clear],
                                   rtol=1e-6, atol=1e-7, msg=f)
    torch.testing.assert_close(fused.stats.grad_accum,
                               plain.stats.grad_accum, rtol=1e-4,
                               atol=1e-5 * float(
                                   plain.stats.grad_accum.abs().max()))
    assert torch.equal(fused.stats.denom, plain.stats.denom)
    assert torch.equal(fused.stats.max_radii2d, plain.stats.max_radii2d)
