"""Frame-sharded (sequence-parallel) SVD inference over
``torch.distributed``.

Counterpart of ``multiview_inpaint_tpu/parallel/svd_inference_parallel.py``.
The JAX module shards the leading ``(b t)`` axis of the latents and of
every per-frame conditioning leaf over the mesh and lets GSPMD insert the
all-to-alls where the temporal layers transpose ``(b t) s c -> (b s) t c``.
PyTorch has no partitioner, so each collective sits by hand at a layer
that mixes frames:

- the temporal transformer blocks (``VideoTransformerBlock``) and the
  (3, 1, 1) temporal ResBlocks (``VideoResBlock.time_stack``): one
  ``all_to_all`` swaps this rank's rows at every position for every row at
  1/w of the positions (padded to a multiple of w), the block runs there,
  and a second swaps back;
- the temporal ResBlocks' GroupNorms, whose statistics span a video's
  frames and positions: each rank's per-video, per-group mean and
  variance of its real positions are gathered and combined
  (``PositionShare.moments``, ``layers.GroupNorm32``);
- frame 0's cross-attention context of each video, the time positional
  embedding's frame index of each row and every frame's time embedding
  come from the whole batch's inputs, which every rank holds.

Rank r computes the r-th contiguous block of the ``(b t)`` rows, as the JAX
sharding ``P("data")`` of that axis places it, and every per-frame leaf
(x, concat, crossattn, vector, control_hint, the noise levels) is cut the
same way: a leaf whose leading dimension divides by the world size, as
``_shard_frame_leaves`` picks them. The sampler stays replicated, as the
JAX sampler runs on global arrays: only the network forward is sharded and
its output rows are all-gathered, so every sampler of
``diffusion.samplers`` takes the denoiser unchanged. Inside a process
group the collectives run at every world size, 1 included; without one
every collective is the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..diffusion import edm
from . import mesh


class PositionShare(NamedTuple):
    """The positions of one level over the ranks: ``reals[q]`` of rank
    q's positions are real, a prefix of them (the rest pad the level to a
    multiple of the world size); ``gather`` stacks every rank's rows
    (``mesh.all_gather_rows`` over the group)."""
    reals: Tuple[int, ...]
    rank: int
    gather: Any

    def moments(self, x: torch.Tensor):
        """The mean and (biased) variance over dims 2 and 3 of x [b, g, m,
        p], this rank's positions on its last axis, taken over every
        rank's real positions: each rank's moments of its own, in f32,
        combined by Chan's rule after one gather; two [b, g] tensors."""
        m, k = x.shape[2], self.reals[self.rank]
        if k:
            var, mean = torch.var_mean(x[..., :k].float(), dim=(2, 3),
                                       correction=0)
        else:
            var = mean = x.new_zeros(x.shape[:2], dtype=torch.float32)
        got = self.gather(torch.stack([mean, var])[None])   # [w, 2, b, g]
        counts = [(q, r * m) for q, r in enumerate(self.reals) if r]
        total = sum(n for _, n in counts)
        mean = sum(n * got[q, 0] for q, n in counts) / total
        var = sum(n * (got[q, 1] + (got[q, 0] - mean) ** 2)
                  for q, n in counts) / total
        return mean, var


@dataclasses.dataclass(frozen=True)
class FrameShard:
    """One rank's share of a frame-sharded forward of ``rows`` ``(b t)``
    rows of ``frames``-frame videos over ``group`` (``world`` ranks): rows
    ``[rank * n, (rank + 1) * n)``, n = rows / world. ``bind`` adds every
    row's inputs that the frame-mixing layers read; each network adds its
    time embedding of every row (``with_emb``)."""
    rows: int
    frames: int
    world: int
    rank: int
    group: Any = None
    video_context: Optional[torch.Tensor] = None  # frame 0's [b, tok, C]
    timesteps: Optional[torch.Tensor] = None      # [(b t)]
    y: Optional[torch.Tensor] = None              # [(b t), adm]
    emb: Optional[torch.Tensor] = None            # [(b t), E]

    @classmethod
    def of(cls, rows: int, frames: int, group=None) -> "FrameShard":
        w = mesh.world(group)
        if rows % frames or rows % w:
            raise ValueError(f"{rows} rows of {frames}-frame videos do not "
                             f"split over {w} ranks")
        return cls(rows, frames, w, mesh.rank(group), group)

    @property
    def local_rows(self) -> int:
        return self.rows // self.world

    def local(self, a):
        """This rank's block of the leading dimension of ``a`` when it
        divides by the world size (a per-frame leaf); ``a`` otherwise."""
        if a is None or a.ndim == 0 or a.shape[0] % self.world:
            return a
        m = a.shape[0] // self.world
        return a[self.rank * m:(self.rank + 1) * m]

    def bind(self, context, timesteps, y) -> "FrameShard":
        """The shard with every row's crossattn ``context`` (of which
        frame 0's per video is kept), noise levels and vector."""
        return dataclasses.replace(
            self, timesteps=timesteps, y=y,
            video_context=None if context is None
            else context[::self.frames])

    def with_emb(self, emb: torch.Tensor) -> "FrameShard":
        return dataclasses.replace(self, emb=emb)

    def frame_index(self, device) -> torch.Tensor:
        """[n]: the frame of each of this rank's rows."""
        n = self.local_rows
        return (self.rank * n + torch.arange(n, device=device)) % self.frames

    def span(self, s: int) -> int:
        """Positions per rank of a level with ``s`` positions."""
        return -(-s // self.world)

    def positions(self, s: int) -> PositionShare:
        p = self.span(s)
        return PositionShare(
            tuple(min(p, max(0, s - q * p)) for q in range(self.world)),
            self.rank, lambda x: mesh.all_gather_rows(x, self.group))

    def to_positions(self, x: torch.Tensor) -> torch.Tensor:
        """x [n, s, c], this rank's rows -> [rows, p, c]: every row at this
        rank's p = span(s) positions (s zero-padded to world * p)."""
        n, s, c = x.shape
        p = self.span(s)
        if p * self.world != s:
            x = F.pad(x, (0, 0, 0, p * self.world - s))
        blocks = x.reshape(n, self.world, p, c).transpose(0, 1)
        return mesh.all_to_all_rows(blocks, self.group).reshape(
            self.rows, p, c)

    def to_rows(self, x: torch.Tensor, s: int) -> torch.Tensor:
        """The inverse of ``to_positions``: [rows, p, c] -> [n, s, c]."""
        n, p, c = self.local_rows, x.shape[1], x.shape[2]
        got = mesh.all_to_all_rows(x.reshape(self.world, n, p, c),
                                   self.group)
        return got.transpose(0, 1).reshape(n, self.world * p, c)[:, :s]


def replicate_engine_state(engine, group=None):
    """Every parameter and buffer of ``engine`` set to the group's rank
    0's, in place; returns the engine."""
    mesh.replicate(list(engine.state_dict().values()), group)
    return engine


def _sharded_net(engine, cond: Dict, group):
    def net(x_scaled, c_noise):
        shard = FrameShard.of(x_scaled.shape[0], engine.cfg.num_frames,
                              group)
        out = engine.apply_model(x_scaled, c_noise, cond, frame_shard=shard)
        return mesh.all_gather_rows(out, group)
    return net


def make_frame_sharded_denoiser(engine, group=None):
    """A drop-in replacement for ``engine.denoise_fn()`` whose UNet +
    ControlNet forward runs frame-sharded over ``group`` (the default
    group when None); its output holds every row on every rank."""
    def denoise(x, sigmas, cond):
        return edm.denoise(_sharded_net(engine, cond, group), x, sigmas,
                           scaling=engine.cfg.scaling)
    return denoise


@torch.no_grad()
def frame_sharded_apply_model(engine, x: torch.Tensor,
                              t_noise: torch.Tensor, cond: Dict,
                              group=None) -> torch.Tensor:
    """One frame-sharded UNet + ControlNet forward of every (b t) row (see
    the module doc); every rank returns all rows."""
    return _sharded_net(engine, cond, group)(x, t_noise)
