"""Port parity, the distributed SVD paths: the frame-sharded forward and
sampler (``parallel/svd_inference_parallel``), the ControlNet DDP step
(``svd_data_parallel.make_dp_train_step``), ``svd_test --shard_frames``
and ``svd_train --devices N``, over ``torch.distributed`` (gloo, two CPU
processes), against the JAX package's functions on a 2-device mesh
(``make_mesh(2)``) and against the port without a process group.

One spawn of two ranks runs every port path (the process start-up is paid
once), then rank 0 runs them again without a process group, while this
process runs the JAX ones; the results go through npz files. The weights
are the port's tiny engines with every parameter moved by a seeded draw,
carried to JAX through ``checkpoint.state_dict_to_jax`` (no JAX engine is
initialised).
Bars:
- the frame-sharded forward on the JAX test's engine (4 frames, 8x8
  latents: 2 rows per rank, each video split between the ranks) and a
  3-step guided Euler-EDM through the sharded denoiser (8 rows, 4 per
  rank) against the JAX ones: 1e-4 of max|out|, the denoiser bar of
  ``test_torch_svd.py``;
- the port at world 2 against the port without a process group: 1e-5 of
  max|out|, at 8x8 latents and at 6x6, whose 3x3 second level puts 5 + 4
  positions on the ranks (one padded, left out of the temporal
  GroupNorms' statistics);
- the plain DP step (one video per rank) against JAX's
  ``make_dp_train_step`` on the mesh with JAX's draws injected: loss 1e-6
  relative, parameters and EMA under ``test_torch_svd_train.py``'s Adam
  rule (|g| >= 1e-6 within 1e-3 lr, the rest counted); the warp and
  pose_cond steps of ``__graft_entry__.dryrun_multichip`` against the
  port's one-process step (whose JAX parity ``test_torch_svd_train.py``
  holds) under the same bars;
- ``svd_test --shard_frames`` at world 2 against world 1 (where it prints
  that it is ignored): frames within 1 uint8 level; ``svd_train --devices
  2 --batch_size 2`` against ``--devices 1`` in one process: the
  checkpoint under the Adam rule, |g| read off the world-1 step's
  displacement.
"""

import contextlib
import dataclasses
import io
import multiprocessing
import os
import socket

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict
from PIL import Image

from multiview_inpaint_tpu.diffusion import edm as jedm
from multiview_inpaint_tpu.diffusion import engine as jengine
from multiview_inpaint_tpu.diffusion import samplers as jsamplers
from multiview_inpaint_tpu.diffusion.clip_vit import TINY_VIT as JTINY_VIT
from multiview_inpaint_tpu.diffusion.guiders import (
    LinearPredictionGuider as JGuider)
from multiview_inpaint_tpu.diffusion.unet import UNetConfig as JUNetConfig
from multiview_inpaint_tpu.diffusion.vae import VAEConfig as JVAEConfig
from multiview_inpaint_tpu.parallel import make_mesh
from multiview_inpaint_tpu.parallel import svd_data_parallel as jdp
from multiview_inpaint_tpu.parallel import svd_inference_parallel as jsp
from multiview_inpaint_tpu.pipelines import svd_train as jsvd_train
from multiview_inpaint_tpu_torch.diffusion import checkpoint
from multiview_inpaint_tpu_torch.parallel import mesh as tmesh
from multiview_inpaint_tpu_torch.utils import synthetic

from test_torch_diffusion import nested
from test_torch_svd_train import (LAT, SIZE, T, _args, _cond, _f32,
                                  _jax_draws, _moved)

FS_T, FS_HW = 4, ((8, 8), (6, 6))    # the frame-sharded engine's frames
DP_LR, DP_DECAY, DP_B = 1e-3, 0.9, 2
CLI_T, CLI_STEPS = 4, 2
COMPONENTS = ("unet", "controlnet", "vae", "clip")
TIMEOUT = 300


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small ops on one intra-op thread, as in the other SVD
    parity files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fs_cfg(pkg):
    """The frame-sharded engine of ``tests/test_svd_inference_parallel.py``
    in either package."""
    if pkg == "jax":
        from multiview_inpaint_tpu.diffusion.engine import EngineConfig
        unet, vae, vit = JUNetConfig, JVAEConfig, JTINY_VIT
    else:
        from multiview_inpaint_tpu_torch.diffusion.clip_vit import TINY_VIT
        from multiview_inpaint_tpu_torch.diffusion.engine import EngineConfig
        from multiview_inpaint_tpu_torch.diffusion.unet import UNetConfig
        from multiview_inpaint_tpu_torch.diffusion.vae import VAEConfig
        unet, vae, vit = UNetConfig, VAEConfig, TINY_VIT
    return EngineConfig(
        unet=unet(in_channels=8, model_channels=32, out_channels=4,
                  num_res_blocks=1, attention_resolutions=(1,),
                  channel_mult=(1, 2), num_head_channels=16, context_dim=16,
                  adm_in_channels=768),
        vae=vae(ch=16, ch_mult=(1, 2), num_res_blocks=1, z_channels=4),
        vit=dataclasses.replace(vit, output_dim=16), num_frames=FS_T,
        num_steps=3)


def _port_engine(cfg, seed=60):
    from multiview_inpaint_tpu_torch.diffusion import engine
    eng = engine.init_engine(cfg, device="cpu")
    _moved(eng, seed)
    return eng


def _fs_cond(rows, hw, rng):
    h, w = hw
    return {"concat": rng.normal(0, 1, (rows, h, w, 4)),
            "crossattn": rng.normal(0, 1, (rows, 1, 16)),
            "vector": rng.normal(0, 1, (rows, 768)),
            "control_hint": rng.normal(0, 1, (rows, 8 * h, 8 * w, 7))}


def _spec():
    """Every input, as numpy, for both packages and both processes."""
    rng = np.random.default_rng(0)
    fs = {}
    for hw in FS_HW:
        fs[hw] = dict(x=rng.normal(0, 1, (FS_T,) + hw + (4,)),
                      t=np.full((FS_T,), 0.7), cond=_fs_cond(FS_T, hw, rng))
    fs = {hw: {k: _f32(v) if isinstance(v, dict) else v.astype(np.float32)
               for k, v in d.items()} for hw, d in fs.items()}
    sample = dict(x0=np.asarray(jax.random.normal(
        jax.random.key(2), (FS_T, 8, 8, 4))),
        cond=_f32(_fs_cond(FS_T, (8, 8), rng)),
        uc=_f32(_fs_cond(FS_T, (8, 8), rng)),
        sigmas=np.asarray(jnp.concatenate([jedm.edm_sigmas(3, 0.002, 80.0),
                                           jnp.zeros((1,))])))
    key = jax.random.key(66)
    sig, noise = _jax_draws(key, DP_B)
    dp = dict(lat=rng.normal(size=(DP_B, T) + LAT + (4,)).astype(np.float32),
              cond=_f32(_cond(DP_B, 65)), sigmas=sig, noise=noise)
    hw = LAT[0] * LAT[1]
    warp = dict(dp, cond=dict(
        _f32(_cond(DP_B, 67)),
        control_hint=rng.uniform(size=(DP_B, T) + SIZE + (3,)).astype(
            np.float32),
        hit_map=(rng.random((DP_B, T - 1) + LAT) > 0.3).astype(np.float32),
        uv_ind=rng.integers(0, hw, (DP_B, T - 1, 4, hw)).astype(np.int32)))
    pose = dict(dp, cond=dict(_f32(_cond(DP_B, 68)), vector=rng.normal(
        size=(DP_B, T, 256 * 6)).astype(np.float32)))
    return dict(fs=fs, sample=sample, dp=dp, warp=warp, pose=pose)


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _guider():
    from multiview_inpaint_tpu_torch.diffusion.guiders import (
        LinearPredictionGuider)
    return LinearPredictionGuider(max_scale=2.5, min_scale=1.0,
                                  num_frames=FS_T)


def _dp_step(kind, spec, sharded):
    """One DP step of 2 videos on the tiny train engine of ``kind``
    (plain, warp, pose); sharded: this rank's video through
    ``make_dp_train_step``, else both through ``make_train_step``.
    Returns loss, params, Adam's mu and the EMA, in the JAX ControlNet
    layout."""
    from multiview_inpaint_tpu_torch.parallel import svd_data_parallel as tdp
    from multiview_inpaint_tpu_torch.pipelines import svd_train
    s = spec[{"plain": "dp", "warp": "warp", "pose": "pose"}[kind]]
    eng = _port_engine(svd_train._engine_config(_args(
        warp_loss=kind == "warp", pose_cond=kind == "pose")))
    params = tdp.trainable_params(eng)
    opt = tdp.build_optimizer(DP_LR)
    state = opt.init(params)
    ema = {k: p.detach().clone() for k, p in params.items()}
    lat, cond = torch.from_numpy(s["lat"]), _t(s["cond"])
    draws = dict(sigmas=torch.from_numpy(s["sigmas"]),
                 noise=torch.from_numpy(s["noise"]))
    if sharded:
        lat, cond = tdp.shard_svd_batch(lat, cond)
        step = tdp.make_dp_train_step(eng, opt, params, DP_DECAY)
    else:
        step = tdp.make_train_step(eng, opt, params, DP_DECAY)
    loss = step(state, ema, lat, cond, **draws)

    def jx(tree):
        return checkpoint.state_dict_to_jax(
            {k: v.detach() for k, v in tree.items()}, "controlnet")

    return dict(loss=float(loss), params=jx(params), mu=jx(state["mu"]),
                ema=jx(ema))


def _cli_dirs(root):
    return dict(gs=os.path.join(root, "gs"), est=os.path.join(root, "est"),
                resume=os.path.join(root, "moved_controlnet.npz"))


def _write_resume(path):
    """The ControlNet of ``svd_train --tiny_model`` with every parameter
    moved, so that the zero convs pass gradients to the trunk."""
    from multiview_inpaint_tpu_torch.pipelines import svd_train
    eng = _port_engine(svd_train._engine_config(_args()), seed=62)
    checkpoint.save_params(path, checkpoint.state_dict_to_jax(
        eng.reference_state_dict(), "controlnet"))


def _svd_test(root, out, logdir, shard):
    from multiview_inpaint_tpu_torch.pipelines import svd_test
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        svd_test.main(["--data_root", _cli_dirs(root)["gs"], "--tiny_model",
                       "--num_frames", str(CLI_T), "--num_steps",
                       str(CLI_STEPS), "--size", str(SIZE[0]), str(SIZE[1]),
                       "--modes", "x1", "--out", out, "--logdir", logdir,
                       "--device", "cpu"] + (["--shard_frames"] if shard
                                             else []))
    return buf.getvalue()


def _svd_train(root, logdir, devices):
    from multiview_inpaint_tpu_torch.pipelines import svd_train
    svd_train.main(["--data_root", _cli_dirs(root)["est"], "--logdir",
                    logdir, "--resume", _cli_dirs(root)["resume"],
                    "--tiny_model", "--epochs", "1", "--devices",
                    str(devices), "--batch_size", "2", "--num_frames",
                    str(T), "--size", str(SIZE[0]), str(SIZE[1]),
                    "--ckpt_every", "1", "--log_interval", "1", "--device",
                    "cpu"])


def _port_paths(spec, root):
    """Every port path at this process's rank (without a process group:
    the one-process references); the results as numpy."""
    from multiview_inpaint_tpu_torch.diffusion import samplers
    from multiview_inpaint_tpu_torch.parallel.svd_inference_parallel import (
        frame_sharded_apply_model, make_frame_sharded_denoiser)

    sharded = tmesh.world() > 1
    res = {"world": tmesh.world()}
    eng = _port_engine(_fs_cfg("torch"))
    with torch.no_grad():
        for hw, d in spec["fs"].items():
            args = (torch.from_numpy(d["x"]), torch.from_numpy(d["t"]),
                    _t(d["cond"]))
            out = (frame_sharded_apply_model(eng, *args) if sharded
                   else eng.apply_model(*args))
            res[f"fs_{hw[0]}x{hw[1]}"] = out.numpy()
        s = spec["sample"]
        denoise = (make_frame_sharded_denoiser(eng) if sharded
                   else eng.denoise_fn())
        res["sample"] = samplers.euler_edm_sample(
            denoise, torch.from_numpy(s["x0"]), _t(s["cond"]), _t(s["uc"]),
            torch.from_numpy(s["sigmas"]), guider=_guider()).numpy()
    for kind in ("plain", "warp", "pose"):
        for k, v in _dp_step(kind, spec, sharded).items():
            res[f"{kind}_{k}"] = v
    tag = "w2" if sharded else "w1"
    res["svd_test_stdout"] = _svd_test(
        root, os.path.join(root, f"frames_{tag}"),
        os.path.join(root, f"logs_test_{tag}"), shard=True)
    _svd_train(root, os.path.join(root, f"logs_train_{tag}"),
               devices=2 if sharded else 1)
    return res


def _flat(res):
    """The results as one level of numpy arrays (dicts joined by '/')."""
    out = {}
    for k, v in res.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": np.asarray(vv) for kk, vv in v.items()})
        else:
            out[k] = np.asarray(v)
    return out


def _worker(rank, world, port, spec, root):
    """The port's paths at world 2, then on rank 0 without a process group
    (the one-process references)."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    tmesh.init(rank, world, f"tcp://127.0.0.1:{port}", "cpu")
    try:
        res = _port_paths(spec, root)
        np.savez(os.path.join(root, f"rank{rank}.npz"), **_flat(res))
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.savez(os.path.join(root, "one.npz"),
                 **_flat(_port_paths(spec, root)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_state(teng, heads):
    flat = checkpoint.state_dict_to_jax(teng.reference_state_dict(),
                                        clip_heads=heads)
    return jengine.EngineState(**{
        c: nested({k[len(c) + 1:]: v for k, v in flat.items()
                   if k.startswith(c + "/")}) for c in COMPONENTS})


def _jax_paths(spec):
    """The JAX package's frame-sharded forward, sampler and DP step on a
    2-device mesh."""
    mesh = make_mesh(2)
    cfg = _fs_cfg("jax")
    eng = jengine.SVDEngine(cfg)
    state = _jax_state(_port_engine(_fs_cfg("torch")), cfg.vit.heads)
    d = spec["fs"][(8, 8)]
    jc = {k: jnp.asarray(v) for k, v in d["cond"].items()}
    res = {"fs_8x8": np.asarray(jsp.frame_sharded_apply_model(
        eng, state, mesh, jnp.asarray(d["x"]), jnp.asarray(d["t"]), jc))}
    s = spec["sample"]
    res["sample"] = np.asarray(jsamplers.euler_edm_sample(
        jsp.make_frame_sharded_denoiser(eng, state, mesh),
        jnp.asarray(s["x0"]), {k: jnp.asarray(v) for k, v in
                               s["cond"].items()},
        {k: jnp.asarray(v) for k, v in s["uc"].items()},
        jnp.asarray(s["sigmas"]),
        guider=JGuider(max_scale=2.5, min_scale=1.0, num_frames=FS_T),
        key=jax.random.key(3)))

    from multiview_inpaint_tpu_torch.pipelines import svd_train
    tcfg = jsvd_train._engine_config(_args())
    jeng = jengine.SVDEngine(tcfg)
    tstate = _jax_state(_port_engine(svd_train._engine_config(_args())),
                        tcfg.vit.heads)
    opt = jdp.build_optimizer(DP_LR)
    tr = jdp.trainable_params(tstate)
    copy = lambda t: jax.tree_util.tree_map(jnp.copy, t)  # noqa: E731
    step = jdp.make_dp_train_step(jeng, opt, ema_decay=DP_DECAY)
    dp = spec["dp"]
    with mesh:
        lat, cond = jdp.shard_svd_batch(
            jnp.asarray(dp["lat"]),
            {k: jnp.asarray(v) for k, v in dp["cond"].items()}, mesh)
        new, opt_state, ema, loss = step(
            jdp.replicate_state(copy(tstate), mesh),
            jdp.replicate_state(opt.init(tr), mesh),
            jdp.replicate_state(copy(tr), mesh), jax.random.key(66), lat,
            cond)
    res["plain_loss"] = float(loss)
    res["plain_params"] = {k: np.asarray(v) for k, v in flatten_dict(
        new.controlnet, sep="/").items()}
    res["plain_mu"] = {k: np.asarray(v) for k, v in flatten_dict(
        opt_state[0].mu["controlnet"], sep="/").items()}
    res["plain_ema"] = {k: np.asarray(v) for k, v in flatten_dict(
        ema["controlnet"], sep="/").items()}
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("svd_parallel"))
    dirs = _cli_dirs(root)
    synthetic.write_gs_tree(dirs["gs"], frames=CLI_T, size=SIZE)
    synthetic.write_est_tree(dirs["est"], scenes=2, frames=T, size=SIZE)
    _write_resume(dirs["resume"])
    spec = _spec()
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, 2, port, spec, root))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        want = _jax_paths(spec)
    finally:
        for p in procs:
            p.join(TIMEOUT)
    for p in procs:
        assert not p.is_alive() and p.exitcode == 0, p.exitcode
    got = [dict(np.load(os.path.join(root, f"{name}.npz")))
           for name in ("rank0", "rank1", "one")]
    return got[:2], got[2], _flat(want), root


def _close(got, want, rel, what):
    err = float(np.abs(got - want).max())
    bar = rel * float(np.abs(want).max())
    assert err <= bar, f"{what}: max abs err {err:.3g} > {bar:.3g}"


def _adam_close(got, want, mu, keys):
    """Parameters after one Adam step: within 1e-3 lr where |g| >= 1e-6
    (|mu| = 0.1 |g|); the rest counted, a minority. Returns how many."""
    small = total = 0
    for k in keys:
        big = np.abs(mu[k]) >= 1e-7
        err = np.abs(got[k] - want[k])[big].max(initial=0)
        assert err <= 1e-3 * DP_LR, (k, err)
        small += int((~big).sum())
        total += big.size
    assert small < total // 4, (small, total)
    return small


def _keys(res, prefix):
    return sorted(k[len(prefix) + 1:] for k in res if k.startswith(
        prefix + "/"))


def _sub(res, prefix):
    return {k: res[f"{prefix}/{k}"] for k in _keys(res, prefix)}


def test_frame_sharded_forward_and_sampler_match_jax_mesh(runs):
    (got, other), _, want, _ = runs
    assert int(got["world"]) == 2
    for key in ("fs_8x8", "sample"):
        _close(got[key], want[key], 1e-4, key)
        np.testing.assert_array_equal(got[key], other[key])


@pytest.mark.parametrize("key", ["fs_8x8", "fs_6x6", "sample"])
def test_frame_sharded_port_matches_one_process(runs, key):
    (got, _), one, _, _ = runs
    assert int(one["world"]) == 1
    _close(got[key], one[key], 1e-5, key)


def test_dp_step_matches_jax_mesh(runs):
    (got, other), _, want, _ = runs
    np.testing.assert_allclose(float(got["plain_loss"]),
                               want["plain_loss"], rtol=1e-6)
    mu = _sub(want, "plain_mu")
    keys = sorted(mu)
    assert keys == _keys(got, "plain_params")
    for what in ("params", "ema"):
        _adam_close(_sub(got, f"plain_{what}"), _sub(want, f"plain_{what}"),
                    mu, keys)
        for k in keys:      # every rank ends with the same trainable set
            np.testing.assert_array_equal(got[f"plain_{what}/{k}"],
                                          other[f"plain_{what}/{k}"])


@pytest.mark.parametrize("kind", ["warp", "pose"])
def test_dp_step_variants_match_one_process(runs, kind):
    (got, other), one, _, _ = runs
    np.testing.assert_allclose(float(got[f"{kind}_loss"]),
                               float(one[f"{kind}_loss"]), rtol=1e-6)
    mu = _sub(one, f"{kind}_mu")
    for what in ("params", "ema"):
        _adam_close(_sub(got, f"{kind}_{what}"), _sub(one, f"{kind}_{what}"),
                    mu, sorted(mu))
    for k in mu:
        np.testing.assert_array_equal(got[f"{kind}_params/{k}"],
                                      other[f"{kind}_params/{k}"])


def test_svd_test_shard_frames_world2_matches_world1(runs):
    (got, other), one, _, root = runs
    assert "sequence-parallel sampling: 4 frames over 2 devices" in str(
        got["svd_test_stdout"])
    assert "shard_frames ignored" in str(one["svd_test_stdout"])
    assert str(other["svd_test_stdout"]) == ""   # rank 1 prints, writes none
    sub = os.path.join("scene_case", "ctrl_0", "x1")
    w2, w1 = (os.path.join(root, f"frames_{t}", sub) for t in ("w2", "w1"))
    names = sorted(os.listdir(w1))
    assert len(names) == CLI_T and sorted(os.listdir(w2)) == names
    differ = 0
    for n in names:
        with Image.open(os.path.join(w2, n)) as a, \
                Image.open(os.path.join(w1, n)) as b:
            a, b = (np.asarray(im, np.int16) for im in (a, b))
        assert a.shape == (SIZE[0], SIZE[1], 3)
        assert np.abs(a - b).max() <= 1, n
        differ += int((a != b).sum())
    print(f"svd_test --shard_frames at world 2 against world 1: {differ} "
          f"of {CLI_T * SIZE[0] * SIZE[1] * 3} values differ by 1 level")


def test_svd_train_devices2_matches_devices1(runs):
    _, _, _, root = runs
    path = os.path.join("checkpoints", "epoch=000000.npz")
    w2, w1 = (checkpoint.load_params(os.path.join(
        root, f"logs_train_{t}", path)) for t in ("w2", "w1"))
    p0 = checkpoint.load_params(_cli_dirs(root)["resume"])
    assert sorted(w2) == sorted(w1) == sorted(p0)
    lr = 1e-4                          # the CLI's default
    small = total = 0
    for k in w1:
        a, b = np.asarray(w2[k]), np.asarray(w1[k])
        big = np.abs(b - p0[k]) >= 0.98 * lr       # |g| >= 1e-6
        assert np.abs(a - b)[big].max(initial=0) <= 1e-3 * lr, k
        small += int((~big).sum())
        total += big.size
    assert small < total // 4, (small, total)


def test_frame_devices_rule():
    assert tmesh.frame_devices(14, 4) == 2
    assert tmesh.frame_devices(14, 8) == 7
    assert tmesh.frame_devices(14, 1) == 1
    assert tmesh.frame_devices(4, 2) == 2
