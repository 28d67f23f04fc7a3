"""GPipe pipeline parallelism over a ``torch.distributed`` group (port of
``repro/distributed/pipeline.py``).

The layer stack is split into ``P`` contiguous stages, one per rank of the
group (the pipe axis: across pods, the links carry exactly ONE (mb, seq,
d) activation per tick).  Schedule is plain GPipe: M microbatches, T = M +
P - 1 ticks, bubble fraction (P-1)/T.

Implementation: the reference's masked SPMD form.  Every rank runs every
tick: stage 0 selects microbatch t's embedding with ``torch.where``, every
rank runs its blocks, the last stage adds the loss of microbatch t - P + 1,
and every rank pushes its output one rank on around the ring
(``batch_isend_irecv``).  The push is an autograd Function whose backward
is the reverse exchange, so the same function trains; since every pushed
buffer feeds the next tick's ``where`` on every rank (stage 0's with a zero
gradient), every push's backward runs, in the same order on every rank,
and each send meets its receive.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch import nn


def stage_slice(blocks, stage: int, n_stages: int, n_layers: int):
    """One stage's contiguous layers of the per-layer ``nn.ModuleList``
    (a ``ModuleList``) or list of per-layer trees (a list)."""
    per = n_layers // n_stages
    return blocks[stage * per:(stage + 1) * per]


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _geometry(group):
    """(P, this rank's stage, group): P = 1 without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0, None
    group = group or dist.group.WORLD
    return dist.get_world_size(group), dist.get_rank(group), group


def _exchange(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` ``step`` ranks on around the group's ring and receive
    the buffer of the rank ``step`` back."""
    p, r = dist.get_world_size(group), dist.get_rank(group)
    out = torch.empty_like(x)
    to = dist.get_global_rank(group, (r + step) % p)
    frm = dist.get_global_rank(group, (r - step) % p)
    for work in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x.contiguous(), to, group),
            dist.P2POp(dist.irecv, out, frm, group)]):
        work.wait()
    return out


class _RingPush(torch.autograd.Function):
    """Forward: to rank + 1, from rank - 1.  Backward: the reverse pairs
    (the gradient of what was sent comes back from rank + 1)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, -1), None


class _GroupSum(torch.autograd.Function):
    """Sum over the group.  Every rank seeds the backward of its own copy
    of the (replicated) sum, so the gradient of each rank's term is the
    output's gradient as it is: identity."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrad(torch.autograd.Function):
    """Identity whose backward sums the gradient over the group: a
    replicated input used by some ranks only (the reference gets the same
    sum from the ``shard_map`` transpose of its ``P()`` inputs)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _IoCall(nn.Module):
    """Holds ``io_params`` (a module, or a dict of modules) so that
    ``torch.func.functional_call`` can hand ``fn`` the same tree over
    other tensors."""

    def __init__(self, io):
        super().__init__()
        self.io = nn.ModuleDict(io) if isinstance(io, dict) else io

    def forward(self, fn, *args):
        io = dict(self.io.items()) if isinstance(self.io, nn.ModuleDict) \
            else self.io
        return fn(io, *args)


def _micro(batch, i: int):
    return {k: v[i] for k, v in batch.items()}


def _flag(value: bool, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.bool, device=like.device)


def gpipe_loss(block_fn: Callable, embed_fn: Callable, head_loss_fn: Callable,
               group=None):
    """Build a pipelined loss:  f(stage_blocks, io_params, batch) -> loss.

    block_fn(stage_blocks, x)      — run this stage's layer slice
    embed_fn(io_params, mb_batch)  — tokens -> x (stage 0 only)
    head_loss_fn(io_params, x, mb_batch) — final norm+CE (last stage only)

    stage_blocks: this rank's layers (:func:`stage_slice`).  io_params
    (the embedding and final norm: a module or a dict of modules) are
    replicated — small next to the blocks; their gradients come back
    summed over the group.  batch: dict of tensors with leading axis M.
    ``group``: the pipe axis (default: the world; no process group: one
    stage).  Every rank returns the mean loss over the M microbatches.
    """

    def loss_fn(stage_blocks, io_params, batch):
        p, sid, grp = _geometry(group)
        m = next(iter(batch.values())).shape[0]
        t_total = m + p - 1

        call = _IoCall(io_params)
        io = dict(call.named_parameters())
        if p > 1 and torch.is_grad_enabled():
            io = {k: _SumGrad.apply(v, grp) for k, v in io.items()}

        def run(fn, *args):
            return torch.func.functional_call(call, io, (fn, *args))

        x0 = run(embed_fn, _micro(batch, 0))
        buf = torch.zeros_like(x0)
        loss_sum = torch.zeros((), dtype=torch.float32, device=x0.device)
        for t in range(t_total):
            mb = _micro(batch, min(t, m - 1))
            # stage 0 ingests microbatch t (if still in range)
            x_in = torch.where(_flag(sid == 0 and t < m, buf),
                               run(embed_fn, mb), buf)
            y = block_fn(stage_blocks, x_in)
            # last stage: microbatch (t - p + 1) completes this tick
            mb_out = _micro(batch, min(max(t - (p - 1), 0), m - 1))
            mb_loss = run(head_loss_fn, y, mb_out)
            take = _flag(sid == p - 1 and t >= p - 1, y)
            loss_sum = loss_sum + torch.where(take, mb_loss, 0.0)
            # push the boundary activation to the next stage (ring; the
            # wrap edge P-1 -> 0 delivers a buffer that stage 0 replaces
            # with the next microbatch's embedding).  The last tick's push
            # would feed nothing: no rank makes it.
            if p > 1 and t < t_total - 1:
                buf = _RingPush.apply(y, grp)
            else:
                buf = y
        # everyone returns the last stage's mean loss
        mine = torch.where(_flag(sid == p - 1, loss_sum), loss_sum, 0.0)
        return (_GroupSum.apply(mine, grp) if p > 1 else mine) / m

    return loss_fn
