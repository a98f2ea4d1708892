"""Data-parallel ControlNet training for the SVD inpainter: trainable
sets, an optax-equivalent Adam with its schedules and gradient
accumulation, EMA, and the step across ranks.

Counterpart of ``multiview_inpaint_tpu/parallel/svd_data_parallel.py``.
The JAX step vmaps the per-video loss over a video batch sharded on a
mesh; here a rank's videos go through one ``[(B T)]`` forward with one
sigma per video, and the loss is the mean over videos (the same number).
``make_train_step`` is the step on one card; ``make_dp_train_step`` runs it
on each rank's B / w videos (``shard_svd_batch``) and sums the trainable
gradients over the ranks (DDP), one flat buffer per type, divided by w:
the gradient of the mean over all B videos, as JAX's ``jnp.mean`` over the
sharded batch gives. The whole batch's sigmas and noise are drawn on every
rank from the same generator and each rank keeps its rows, so a step at
world w equals the step at world 1 up to the all-reduce's rounding.

``build_optimizer`` reproduces ``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8,
eps_root 0) step for step, in its order of operations and types: the
moments live in the parameter type (bf16 at full width), python constants
are rounded to that type as JAX's weakly typed scalars are, the bias
corrections are computed in f32 and cast, the update is p + (-lr) *
mu_hat / (sqrt(nu_hat) + eps). The schedules are optax's ``constant``,
``linear_schedule(lr, 0, total, warmup)`` and
``warmup_cosine_decay_schedule(0, lr, warmup, total)``, computed in f32;
``accumulate > 1`` is ``optax.MultiSteps``: a running mean of k gradients
(Welford's update, as optax's), the Adam step applied on every k-th call
only, Adam's count advancing only then. ``torch.optim.Adam`` rounds
differently and is not used.

Adam and the EMA update run as ``torch._foreach_*`` ops over the tensors
of each type: the same operations in the same order, each rounded to the
parameter type as the per-tensor ops would be, in a few launches per
operation instead of one per tensor (the ControlNet has ~670). The rounded
constants are 0-dim CPU tensors, made once per type and step: PyTorch
hands a CPU scalar tensor to a CUDA kernel as an argument, where a 0-dim
CUDA tensor would cost one pageable host-to-device copy per use.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ..diffusion import losses
from ..diffusion.checkpoint import PREFIXES
from . import mesh

B1, B2, EPS, EPS_ROOT = 0.9, 0.999, 1e-8, 0.0


def trainable_params(engine, train_label_emb: bool = False
                     ) -> Dict[str, torch.nn.Parameter]:
    """Open the trainable set to gradients and freeze the rest of the
    engine; returns it by reference torch key: the ControlNet (sd_locked),
    plus the UNet's label embedding with ``train_label_emb``."""
    engine.requires_grad_(False)
    params = {PREFIXES["controlnet"] + k: p
              for k, p in engine.controlnet.named_parameters()}
    if train_label_emb:
        params.update({PREFIXES["unet"] + "label_emb." + k: p for k, p in
                       engine.unet.label_emb.named_parameters()})
    for p in params.values():
        p.requires_grad_(True)
    return params


@torch.no_grad()
def apply_trainable(params: Dict[str, torch.Tensor],
                    values: Dict[str, torch.Tensor]) -> None:
    """Copy ``values`` (e.g. the EMA) into the trainable parameters."""
    for k, p in params.items():
        p.copy_(values[k])


def _f32(x) -> np.float32:
    return np.float32(x)


def _consts(dtype: torch.dtype, *values) -> list:
    """Python numbers rounded to ``dtype`` (JAX's weakly typed scalars) as
    0-dim CPU tensors."""
    return [torch.tensor(float(v), dtype=dtype) for v in values]


def _by_dtype(tensors: Dict[str, torch.Tensor]) -> Dict:
    """The keys of ``tensors`` grouped by their type."""
    groups: Dict = {}
    for k, t in tensors.items():
        groups.setdefault(t.dtype, []).append(k)
    return groups


def _schedule(lr: float, schedule: str, warmup_steps: int, total_steps: int):
    """count -> learning rate, in f32 as optax computes it."""
    if schedule == "constant":
        return None

    def poly(init, end, steps, begin=0):
        if steps <= 0:
            return lambda count: _f32(init)

        def f(count):
            c = min(max(count - begin, 0), steps)
            frac = _f32(1) - _f32(c) / _f32(steps)
            return _f32(init - end) * frac + _f32(end)
        return f

    if schedule == "linear":
        return poly(lr, 0.0, total_steps, warmup_steps)
    if schedule == "warmup_cosine":
        decay = total_steps - warmup_steps
        if decay <= 0:
            raise ValueError("warmup_cosine needs total_steps > warmup_steps")
        warm = poly(0.0, lr, warmup_steps)

        def cosine(count):
            c = _f32(min(count, decay))
            cos = _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * c
                                                / _f32(decay)))
            return _f32(lr) * cos

        return lambda count: (warm(count) if count < warmup_steps
                              else cosine(count - warmup_steps))
    raise ValueError(f"unknown schedule {schedule!r}")


class Optimizer:
    """``optax.adam(schedule, b1, b2)``, wrapped in
    ``optax.MultiSteps`` when ``accumulate > 1``, over a dict of
    parameters updated in place."""

    def __init__(self, lr: float = 1e-4, schedule: str = "constant",
                 warmup_steps: int = 0, total_steps: int = 100_000,
                 accumulate: int = 1, b1: float = B1, b2: float = B2):
        self.lr = lr
        self.b1, self.b2 = b1, b2
        self.schedule = _schedule(lr, schedule, warmup_steps, total_steps)
        self.accumulate = accumulate

    def learning_rate(self, count: int) -> float:
        """The learning rate of Adam's update number ``count`` (from 0)."""
        return float(_f32(self.lr) if self.schedule is None
                     else self.schedule(count))

    def init(self, params: Dict[str, torch.Tensor]) -> Dict:
        zeros = {k: torch.zeros_like(p) for k, p in params.items()}
        state = {"count": 0, "mu": zeros,
                 "nu": {k: torch.zeros_like(p) for k, p in params.items()}}
        if self.accumulate > 1:
            state.update(mini_step=0, acc={k: torch.zeros_like(p)
                                           for k, p in params.items()})
        return state

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], state: Dict) -> bool:
        """One optimizer call; returns whether the parameters moved (with
        accumulation, on every k-th call only)."""
        if self.accumulate > 1:
            n = state["mini_step"]
            for k, g in grads.items():
                acc = state["acc"][k]
                acc.add_((g - acc) / torch.tensor(n + 1, dtype=acc.dtype))
            if n + 1 < self.accumulate:
                state["mini_step"] = n + 1
                return False
            state["mini_step"] = 0
            grads = {k: a.clone() for k, a in state["acc"].items()}
            for a in state["acc"].values():
                a.zero_()
        self._adam(params, grads, state)
        return True

    def _adam(self, params, grads, state):
        count = state["count"] + 1
        bc1 = _f32(1) - _f32(self.b1) ** _f32(count)
        bc2 = _f32(1) - _f32(self.b2) ** _f32(count)
        lr = (_f32(self.lr) if self.schedule is None
              else self.schedule(state["count"]))
        for dt, keys in _by_dtype(params).items():
            a1, b1, a2, b2, c1, c2, er, eps, nlr = _consts(
                dt, 1 - self.b1, self.b1, 1 - self.b2, self.b2, bc1, bc2,
                EPS_ROOT, EPS, -lr)
            p = [params[k] for k in keys]
            g = [grads[k] for k in keys]
            mu = [state["mu"][k] for k in keys]
            nu = [state["nu"][k] for k in keys]
            # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
            torch._foreach_copy_(mu, torch._foreach_add(
                torch._foreach_mul(g, a1), torch._foreach_mul(mu, b1)))
            torch._foreach_copy_(nu, torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(g, g), a2),
                torch._foreach_mul(nu, b2)))
            # p = p + (-lr) (mu / bc1) / (sqrt(nu / bc2 + eps_root) + eps)
            den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_add(
                torch._foreach_div(nu, c2), er)), eps)
            upd = torch._foreach_div(torch._foreach_div(mu, c1), den)
            torch._foreach_copy_(p, torch._foreach_add(
                p, torch._foreach_mul(upd, nlr)))
        state["count"] = count


def build_optimizer(lr: float = 1e-4, schedule: str = "constant",
                    warmup_steps: int = 0, total_steps: int = 100_000,
                    accumulate: int = 1) -> Optimizer:
    """Reference knobs: base lr 1e-4, LambdaLinear/WarmUpCosine schedules
    (sgm/lr_scheduler.py), accumulate_grad_batches."""
    return Optimizer(lr, schedule, warmup_steps, total_steps, accumulate)


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor],
               params: Dict[str, torch.Tensor], decay: float) -> None:
    """e <- decay e + (1 - decay) p, constants in each leaf's type (as
    JAX's weakly typed scalars: in bf16, 0.9999 rounds to 1.0)."""
    for dt, keys in _by_dtype(ema).items():
        d, d1 = _consts(dt, decay, 1 - decay)
        e = [ema[k] for k in keys]
        torch._foreach_copy_(e, torch._foreach_add(
            torch._foreach_mul(e, d),
            torch._foreach_mul([params[k] for k in keys], d1)))


def flatten_videos(latents_b: torch.Tensor, cond_b: Dict):
    """``[B, T, ...]`` latents and conditioning -> ``[(B T), ...]``, the
    warp maps (``hit_map``, ``uv_ind``) split off into their own dict."""
    lat = latents_b.reshape((-1,) + tuple(latents_b.shape[2:]))
    cond = {k: v.reshape((-1,) + tuple(v.shape[2:]))
            for k, v in cond_b.items() if k not in ("hit_map", "uv_ind")}
    warp = ({"hit_map": cond_b["hit_map"], "uv_ind": cond_b["uv_ind"]}
            if "hit_map" in cond_b else None)
    return lat, cond, warp


def make_train_step(engine, optimizer: Optimizer,
                    params: Dict[str, torch.nn.Parameter],
                    ema_decay: Optional[float] = None, reduce_grads=None):
    """Returns ``step(opt_state, ema, latents_b, cond_b, sigmas=None,
    noise=None, generator=None) -> loss``.

    latents_b ``[B, T, h, w, 4]``; every leaf of cond_b has the leading
    video dim B (``[B, T, ...]`` per frame; ``hit_map`` ``[B, T-1, h, w]``
    and ``uv_ind`` ``[B, T-1, 4, h*w]`` turn on the warp-consistency
    term). ``sigmas`` ``[B]`` and ``noise`` (the latents' shape) are drawn
    from ``generator`` unless given. The step updates ``params`` (the
    trainable set) and ``ema`` in place; ``reduce_grads`` (a list of
    gradients to a list) runs between the backward pass and Adam."""
    names = list(params)

    def step(opt_state, ema, latents_b, cond_b, sigmas=None, noise=None,
             generator=None):
        lat, cond, warp = flatten_videos(latents_b, cond_b)
        if noise is not None:
            noise = noise.reshape(lat.shape)
        loss = engine.loss(lat, cond, warp=warp, sigmas=sigmas, noise=noise,
                           generator=generator)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        if reduce_grads is not None:
            grads = reduce_grads(grads)
        optimizer.step(params, dict(zip(names, grads)), opt_state)
        if ema_decay is not None:
            ema_update(ema, params, ema_decay)
        return loss.detach()

    return step


def all_reduce_mean_flat(tensors) -> list:
    """The mean of each tensor over the ranks: one flat buffer per type,
    all-reduced once and divided by the world size; returns views into
    the buffers in the order of ``tensors``."""
    out = list(tensors)
    w = mesh.world()
    for dt, idx in _by_dtype(dict(enumerate(tensors))).items():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        mesh.all_reduce_sum(flat).div_(w)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def batch_draws(latents_b: torch.Tensor, sigmas=None, noise=None,
                generator=None):
    """This rank's sigmas ``[B / w]`` and noise ``[(B / w) T, h, w, c]``
    out of the whole batch's (B = w times the rank's ``latents_b``
    videos): drawn on every rank from ``generator`` in the loss's order,
    or given as ``sigmas`` ``[B]`` and ``noise`` of B videos."""
    w, r = mesh.world(), mesh.rank()
    nb, t = latents_b.shape[:2]
    frame = tuple(latents_b.shape[2:])
    sigmas, noise = losses.draws(nb * w, (nb * w * t,) + frame,
                                 latents_b.dtype, latents_b.device,
                                 sigmas=sigmas, noise=noise,
                                 generator=generator)
    noise = noise.reshape((nb * w, t) + frame)[r * nb:(r + 1) * nb]
    return sigmas[r * nb:(r + 1) * nb], noise.reshape((-1,) + frame)


def make_dp_train_step(engine, optimizer: Optimizer,
                       params: Dict[str, torch.nn.Parameter],
                       ema_decay: Optional[float] = None):
    """``make_train_step`` on this rank's videos of a batch sharded over
    the ranks: returns ``step(opt_state, ema, latents_b, cond_b,
    sigmas=None, noise=None, generator=None) -> loss``, latents_b and
    cond_b this rank's B / w videos (``shard_svd_batch``), ``sigmas``
    ``[B]`` and ``noise`` of the whole batch when given (see
    ``batch_draws``). The trainable gradients are
    averaged over the ranks (``all_reduce_mean_flat``) before Adam, so
    Adam, its accumulation and the EMA run identically on every rank; the
    loss returned is the mean over all B videos. Without a process group
    this is ``make_train_step``."""
    reduce = (all_reduce_mean_flat if torch.distributed.is_initialized()
              else None)
    one = make_train_step(engine, optimizer, params, ema_decay, reduce)

    def step(opt_state, ema, latents_b, cond_b, sigmas=None, noise=None,
             generator=None):
        sig, eps = batch_draws(latents_b, sigmas, noise, generator)
        loss = one(opt_state, ema, latents_b, cond_b, sigmas=sig, noise=eps)
        return mesh.all_reduce_sum(loss.clone()) / mesh.world()

    return step


def shard_svd_batch(latents_b, cond_b):
    """This rank's videos of a batch: the leading video dim B of the
    latents and of every conditioning leaf cut into w blocks (B must
    divide by the world size, as the JAX sharding requires)."""
    return mesh.shard_batch(latents_b), mesh.shard_batch(cond_b)


def replicate_state(state):
    """Rank 0's values in every tensor of ``state`` (a module, or a
    tensor tree: the optimizer state, the EMA), broadcast in place;
    returns ``state``."""
    tensors = (list(state.state_dict().values())
               if isinstance(state, torch.nn.Module) else state)
    mesh.replicate(tensors)
    return state
