"""The projection's two paths on the CPU: the K6 wrapper
(``project_cuda.project``) and both branches of ``api.project`` against
the plain version of the projection kernel (K6), ``project_cuda.
project_ref``, which is ``api.project``'s computation from before K6,
bit for bit; and the choice ``api.project`` makes between the wrapper
and the plain ops. K6 itself runs only on the card
(``tests/test_torch_cuda.py``). No JAX is imported.
"""

import dataclasses

import pytest
import torch

import projection_cases as cases
from multiview_inpaint_tpu_torch import telemetry
from multiview_inpaint_tpu_torch.ops.rasterizer import (RenderCamera, api,
                                                        geometry,
                                                        project_cuda)

FIELDS = geometry.ProjectedGaussians._fields


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


@pytest.mark.parametrize("grad,leaf,camera_leaf,offset,want", [
    (False, False, False, False, True),
    (False, True, False, False, True),
    (True, False, False, False, True),
    (True, True, False, False, False),
    (True, False, True, False, False),
    (True, False, False, True, False),
    (False, False, False, True, False),
], ids=["no_grad", "no_grad_leaf", "grad_no_leaf", "grad_leaf",
        "grad_camera_leaf", "offset", "no_grad_offset"])
def test_gradient_free_decides_the_path(grad, leaf, camera_leaf, offset,
                                        want):
    p = cases.hard_scene(n=50)
    cam = _camera()
    if leaf:
        p = _leaf(p, "features_rest")
    if camera_leaf:
        cam = dataclasses.replace(
            cam, world_view=cam.world_view.clone().requires_grad_(True))
    off = torch.zeros((p.capacity, 2)) if offset else None
    with torch.set_grad_enabled(grad):
        assert api.gradient_free(p, cam, off) is want


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
