"""Port parity, stage-2 scene helpers: ``diffusion.clip_vit.resize_bilinear``
(the grounder's crop resize), ``gs.scene.load_sd_ply`` and the inpaint
camera builders ``gs.scene.inpaint_cameras`` / ``inpaint_train_cameras``
against the JAX package on the CPU.

Bars:
- ``resize_bilinear`` (values in [0, 1]), up and down, odd sizes: within
  1e-6 of a float64 evaluation of ``jax.image.resize``'s own weights (the
  port reads 1.0e-7), and within 2e-5 of ``jax.image.resize(...,
  "bilinear")`` itself, whose f32 contraction is off that float64
  evaluation by up to 1.15e-5 when shrinking 300x211 to 224x224 (1.7e-6
  when enlarging; the bicubic resize shows the same, ROADMAP Queue 3);
- ``load_sd_ply`` given JAX's own box uniforms (``jax.random.uniform`` of
  ``jax.random.key(seed)``, what the JAX ``obb.sample_uniform`` draws):
  positions within 1e-6; every other field but the new rows' log-scales,
  and the capacity, exactly equal. Both packages take the mean squared
  3-NN distance d2 in the matmul form |q|^2 + |p|^2 - 2 q.p, whose f32
  rounding cancels to about eps |x|^2 (eps = 2^-24, |x| the largest
  point norm): a row's log-scale 0.5 log d2 may move by eps |x|^2 / d2.
  Each package lies within 4 eps |x|^2 / d2 of a float64 evaluation (the
  most seen: 1.2x for the port, 1.5x for JAX, also at 3,000 points in a
  0.15 box, ~1e-3 in log-scale), so port and JAX within 8 eps |x|^2 / d2
  of each other, row by row;
- the camera builders on a workspace the test writes (orbit poses,
  renders and box masks at 24x32, inpainted frames at 48x64, SAM masks,
  ``bds_train`` renders and masks), for ``ctrl_id`` 1 and the ``-1``
  directory fallback (whose ``x2`` has no inpainted frames, so its renders
  are taken as they are) and the three count-balancing cases: names, order,
  sizes, fov, poses, images and masks exactly equal.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multiview_inpaint_tpu.config import registries as jreg
from multiview_inpaint_tpu.gs import gaussians as jgaussians
from multiview_inpaint_tpu.gs import obb as jobb
from multiview_inpaint_tpu.gs import scene as jscene
from multiview_inpaint_tpu.gs import scene_io as jscene_io
from multiview_inpaint_tpu.utils import synthetic as jsynthetic
from multiview_inpaint_tpu_torch.config import registries as treg
from multiview_inpaint_tpu_torch.diffusion import clip_vit as tclip
from multiview_inpaint_tpu_torch.gs import gaussians as tgaussians
from multiview_inpaint_tpu_torch.gs import obb as tobb
from multiview_inpaint_tpu_torch.gs import scene as tscene
from multiview_inpaint_tpu_torch.utils import synthetic as tsynthetic

SCENE, SCENE_ID, ITER = "toy", "toy_case", 7
N_VIEWS = 4
SEQ_HW, INP_HW = (24, 32), (48, 64)
MODES = ("x2", "x1", "y1", "y2")


@pytest.mark.parametrize("shape,size", [
    ((2, 37, 53, 3), (224, 224)),     # up, odd
    ((1, 300, 211, 3), (224, 224)),   # down, odd
    ((3, 17, 64, 3), (9, 101)),       # down one axis, up the other
    ((1, 50, 50, 3), (50, 31)),       # one axis unchanged
])
def test_resize_bilinear_matches_jax(shape, size):
    x = np.random.default_rng(sum(shape)).uniform(size=shape).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(x), (shape[0],) + size + (3,),
                            "bilinear")
    got = tclip.resize_bilinear(torch.from_numpy(x), size)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    w_h, w_w = (tclip._resize_weights(n_in, n_out, "cpu", tclip._triangle)
                .double() for n_in, n_out in zip(shape[1:3], size))
    exact = torch.einsum("bhwc,hi,wj->bijc", torch.from_numpy(x).double(),
                         w_h, w_w)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), atol=1e-6)


@pytest.fixture(scope="module")
def bg_ply(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sd") / "del.ply")
    jgaussians.save_ply(jsynthetic.make_gt_gaussians(n=64, seed=4), path)
    obj = path.replace("del.ply", "box.obj")
    tsynthetic.write_cube_obj(obj, center=(0.15, -0.05, -0.75), half=0.3)
    return path, obj


@pytest.mark.parametrize("n,capacity", [(300, None), (257, 1000)])
def test_load_sd_ply_matches_jax(bg_ply, n, capacity):
    path, obj = bg_ply
    seed = 3
    want = jscene.load_sd_ply(path, jobb.load_obb(obj), n_samples=n,
                              capacity=capacity, seed=seed)
    u = np.array(jax.random.uniform(jax.random.key(seed), (n, 3)))
    got = tscene.load_sd_ply(path, tobb.load_obb(obj), n_samples=n,
                             capacity=capacity, u=torch.from_numpy(u),
                             device="cpu")
    assert got.capacity == want.capacity == (capacity or int(1.5 * (64 + n)))
    for f in tgaussians.FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.shape == b.shape, f
        if f == "xyz":
            np.testing.assert_allclose(a, b, atol=1e-6)
        elif f == "scaling":
            new = slice(64, 64 + n)
            np.testing.assert_array_equal(np.delete(a, new, 0),
                                          np.delete(b, new, 0))
            exact, cancel = _log_scale64(got.xyz[new])
            a, b = a[new], b[new]
            for new, bar in ((a, 4 * cancel), (b, 4 * cancel),
                             (a - b + exact[:, None], 8 * cancel)):
                assert (np.abs(new - exact[:, None])
                        <= bar[:, None]).all(), f
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def _log_scale64(xyz):
    """(float64 log-scale of each point, eps |x|^2 / d2 of each point)."""
    x = xyz.double()
    d2 = torch.cdist(x, x, compute_mode="donot_use_mm_for_euclid_dist")
    d2 = d2.square().fill_diagonal_(float("inf"))
    d2 = torch.topk(d2, 3, largest=False).values.mean(1).clamp(min=1e-7)
    cancel = 2.0 ** -24 * float((x * x).sum(1).max()) / d2
    return torch.log(torch.sqrt(d2)).numpy(), cancel.numpy()


def test_load_sd_ply_draws_inside_the_box(bg_ply):
    path, obj = bg_ply
    box = tobb.load_obb(obj)
    a = tscene.load_sd_ply(path, box, n_samples=200, seed=5, device="cpu")
    b = tscene.load_sd_ply(path, box, n_samples=200, seed=5, device="cpu")
    c = tscene.load_sd_ply(path, box, n_samples=200, seed=6, device="cpu")
    new = a.xyz[64:264]
    assert torch.equal(new, b.xyz[64:264])
    assert not torch.equal(new, c.xyz[64:264])
    assert bool(tobb.contains(box, new).all())


def _write_tree(root, n_mode, frames, ctrl_dir, with_x2_inpainted, seed):
    """Seq poses, renders and box masks at SEQ_HW, SAM masks, inpainted
    frames at INP_HW (none for x2 unless ``with_x2_inpainted``) and the
    ``bds_train`` renders and masks of every train view."""
    rng = np.random.default_rng(seed)
    inp = os.path.join(root, "inpaint")

    def png(path, hw, gray=False):
        arr = rng.uniform(size=hw if gray else hw + (3,))
        if gray:
            arr = (arr > 0.5).astype(np.float32)
        jscene_io.save_image(path, arr)

    for mode in MODES[:n_mode]:
        seq = os.path.join(inp, "seq", SCENE_ID, mode, f"ours_{ITER}")
        poses = np.tile(np.eye(4), (frames, 1, 1))
        poses[:, :3, 3] = rng.normal(size=(frames, 3))
        poses[:, :3, :3] = np.linalg.qr(rng.normal(size=(frames, 3, 3)))[0]
        os.makedirs(seq)
        np.save(os.path.join(seq, "poses.npy"), poses)
        mask_dir = os.path.join(inp, "sam_mask", SCENE_ID, ctrl_dir, mode)
        inp_dir = os.path.join(inp, "inpainted", SCENE_ID, ctrl_dir, mode)
        for i in range(frames):
            png(os.path.join(seq, "renders", f"{i:02d}.png"), SEQ_HW)
            png(os.path.join(mask_dir, f"{i:02d}.png"), SEQ_HW, gray=True)
            if mode != "x2" or with_x2_inpainted:
                png(os.path.join(inp_dir, f"{i:02d}.png"), INP_HW)
    train = os.path.join(inp, "seq", SCENE_ID, "bds_train", f"ours_{ITER}")
    for v in range(N_VIEWS):
        png(os.path.join(train, "renders", f"view{v:02d}.png"), (48, 64))
        png(os.path.join(train, "mask", f"view{v:02d}.png"), (48, 64),
            gray=True)


@pytest.fixture(scope="module")
def colmap(tmp_path_factory):
    saved = {m: dict(m.FRONT_VIEWS) for m in (jreg, treg)}
    src = str(tmp_path_factory.mktemp("colmap") / "dataset" / SCENE)
    tsynthetic.make_colmap_scene(src, n_views=N_VIEWS, device="cpu")
    for m in (jreg, treg):
        m.FRONT_VIEWS[SCENE] = "view00"
    yield src
    for m, d in saved.items():
        m.FRONT_VIEWS.clear()
        m.FRONT_VIEWS.update(d)


def _scenes(src, root):
    model = os.path.join(root, "output", SCENE)
    j = jscene.Scene(src, model, resolution=1, shuffle=False,
                     workspace=jscene.Workspace(root), load_gaussians=False)
    t = tscene.Scene(src, model, resolution=1, shuffle=False,
                     workspace=tscene.Workspace(root), load_gaussians=False,
                     device="cpu")
    j.scene_name = t.scene_name = SCENE_ID
    return j, t


def _assert_same_cameras(got, want):
    assert [c.image_name for c in got] == [c.image_name for c in want]
    for a, b in zip(got, want):
        for f in ("uid", "image_name", "width", "height", "fovx", "fovy",
                  "inpainted", "colmap_id"):
            assert getattr(a, f) == getattr(b, f), (a.image_name, f)
        for f in ("world_view", "image", "mask"):
            x, y = getattr(a, f), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype and np.array_equal(x, y), (
                a.image_name, f)


# (n_mode, frames) -> seq views 7/9 >= 2 x 4 train; 4 train >= 2 x 2 seq;
# 3 and 5 seq: neither.
@pytest.mark.parametrize("n_mode,frames,case", [
    (2, 5, "seq >= 2 train"), (1, 2, "train >= 2 seq"),
    (2, 2, "neither"), (4, 2, "neither")])
@pytest.mark.parametrize("ctrl_id", [1, -1])
def test_inpaint_cameras_match_jax(colmap, tmp_path, n_mode, frames, case,
                                   ctrl_id):
    root = str(tmp_path)
    # ctrl_id -1 reads <sam_mask|inpainted>/<scene>/ctrl_0/<mode>: the
    # fallback's dirname(...) of ctrl 0's directory keeps "ctrl_0"
    _write_tree(root, n_mode, frames, f"ctrl_{max(ctrl_id, 0)}",
                with_x2_inpainted=ctrl_id >= 0, seed=n_mode * 10 + frames)
    js, ts = _scenes(colmap, root)
    kw = dict(n_mode=n_mode, ctrl_id=ctrl_id, frames=frames, iteration=ITER)
    seq_t = tscene.inpaint_cameras(ts, **kw)
    _assert_same_cameras(seq_t, jscene.inpaint_cameras(js, **kw))
    assert len(seq_t) == frames + (n_mode - 1) * (frames - 1)
    sizes = {(c.height, c.width) for c in seq_t}
    assert (INP_HW in sizes) == (ctrl_id >= 0 or n_mode > 1)
    assert (SEQ_HW in sizes) == (ctrl_id < 0)
    got = tscene.inpaint_train_cameras(ts, **kw)
    _assert_same_cameras(got, jscene.inpaint_train_cameras(js, **kw))
    n_seq = len(seq_t)
    n_train = sum(not c.inpainted for c in got)
    assert n_train == (N_VIEWS * (n_seq // N_VIEWS)
                       if case == "seq >= 2 train" else N_VIEWS)
    assert sum(c.inpainted for c in got) == (
        n_seq * (N_VIEWS // n_seq) if case == "train >= 2 seq" else n_seq)
    # the order is random.Random(seed)'s shuffle: another seed, another
    # order of the same cameras
    other = tscene.inpaint_train_cameras(ts, seed=1, **kw)
    names = [(c.inpainted, c.image_name) for c in got]
    assert sorted(names) == sorted((c.inpainted, c.image_name)
                                   for c in other)
    unshuffled = tscene.inpaint_train_cameras(ts, shuffle=False, **kw)
    _assert_same_cameras(unshuffled, jscene.inpaint_train_cameras(
        js, shuffle=False, **kw))
