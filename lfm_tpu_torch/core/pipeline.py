"""Pipeline parallelism over the ``pipe`` axis of the ranks (port of
lfm_tpu/core/pipeline.py).

A network's repeated blocks are split into stages over the ranks of the
pipe group; microbatches of the local batch flow from stage to stage, one
neighbour a tick (``ppermute``). ``pipeline_blocks`` is both of JAX's
schedules: at ``num_chunks`` 1 GPipe's fill-drain (JAX's
``pipeline_blocks``), M microbatches over S stages in M + S - 1 ticks;
above it the interleaved one (JAX's ``pipeline_blocks_interleaved``),
which gives each rank ``num_chunks`` (v) non-contiguous slices, virtual
stages d, S + d, ..., (v - 1) S + d, so an activation goes round the ring
v times in v M + S - 1 ticks. JAX's tick formulas decide which microbatch
and chunk a rank works on at each tick (GPipe's are their v = 1 case).

JAX runs every stage at every tick, the ticks in the fill and drain bubble
on values that are never read, because its schedule is one branch-free
``lax.scan``. Here a rank skips those ticks: it applies its blocks only to
real microbatches, so each rank evaluates each of its blocks exactly M
times a forward, and passes whatever it holds on at the others. Every
rank still takes part in every tick's exchange, in the same order.

The last stage's output reaches every rank of the group (JAX's psum
broadcast). Under autograd the schedule is one ``torch.autograd.Function``:
its forward keeps each real tick's graph, and its backward walks the ticks
in reverse, each rank back-propagating its real ticks and passing the
input gradients one neighbour back, so the collectives run in one order
on every rank. The output's gradient is taken from the last stage (every
rank of the group computes the same function of the output, as JAX's
``out_specs`` replicated over pipe state); the gradients of the input
tokens and of the conditioning are summed over the group, so every rank's
replicated layers get the whole gradient, and each block's parameters get
theirs on the rank that holds it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from lfm_tpu_torch.core.sharding import _group_size, ppermute

__all__ = ["pipeline_blocks", "schedule"]


def schedule(t: int, d: int, n_stages: int, num_chunks: int, m: int):
    """(real, chunk, microbatch) of stage ``d`` at tick ``t`` (JAX's
    formulas: u = (t - d) mod vS, g = (t - d) // vS, chunk u // S,
    microbatch gS + u mod S)."""
    vs = num_chunks * n_stages
    u, g = (t - d) % vs, (t - d) // vs
    mb = g * n_stages + u % n_stages
    return t - d >= 0 and mb < m, u // n_stages, mb


def _forward(apply_chunk, xs, cs, group, num_chunks, keep_graph):
    """The forward ticks. Returns the last stage's outputs (on that rank;
    zeros elsewhere) and, with ``keep_graph``, each real tick's
    (tick, input leaf, conditioning leaf, output)."""
    size = _group_size(group)
    d = 0 if group is None else dist.get_rank(group)
    m = xs.shape[0]
    outs = torch.zeros_like(xs)
    held = torch.zeros_like(xs[0])
    ticks = []
    n_ticks = num_chunks * m + size - 1
    for t in range(n_ticks):
        real, k, mb = schedule(t, d, size, num_chunks, m)
        out = held
        if real:
            inp = xs[mb] if d == 0 and k == 0 else held
            c_mb = cs[mb]
            if keep_graph:
                inp = inp.detach().requires_grad_()
                c_mb = c_mb.detach().requires_grad_()
                with torch.enable_grad():
                    out = apply_chunk(k, inp, c_mb)
                ticks.append((t, inp, c_mb, out))
                out = out.detach()
            else:
                out = apply_chunk(k, inp, c_mb)
            if d == size - 1 and k == num_chunks - 1:
                outs[mb] = out
        if t + 1 < n_ticks:
            held = ppermute(out, group, 1)
    return outs, ticks


def _broadcast_last(outs: torch.Tensor, group) -> torch.Tensor:
    """The last stage's ``outs`` on every rank of the group, as bytes (a
    broadcast of any dtype, on either backend)."""
    if _group_size(group) == 1:
        return outs
    raw = outs.contiguous().reshape(-1).view(torch.uint8)
    dist.broadcast(raw, src=dist.get_global_rank(group, dist.get_world_size(group) - 1),
                   group=group)
    return raw.view(outs.dtype).view(outs.shape)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs, cs, apply_chunk, group, num_chunks):
        outs, ticks = _forward(apply_chunk, xs, cs, group, num_chunks, keep_graph=True)
        ctx.ticks, ctx.group, ctx.num_chunks = ticks, group, num_chunks
        ctx.m = xs.shape[0]
        return _broadcast_last(outs, group)

    @staticmethod
    def backward(ctx, g_outs):
        group, v, m = ctx.group, ctx.num_chunks, ctx.m
        size = _group_size(group)
        d = 0 if group is None else dist.get_rank(group)
        by_tick = {t: rest for t, *rest in ctx.ticks}
        ctx.ticks = None
        dxs = torch.zeros_like(g_outs)
        dcs = None
        g_held = torch.zeros_like(g_outs[0])
        n_ticks = v * m + size - 1
        for t in reversed(range(n_ticks)):
            real, k, mb = schedule(t, d, size, v, m)
            g = g_held
            if real:
                inp, c_mb, out = by_tick.pop(t)
                if d == size - 1 and k == v - 1:
                    g = g + g_outs[mb].to(g.dtype)
                torch.autograd.backward(out, g.to(out.dtype))
                g = torch.zeros_like(g) if inp.grad is None else inp.grad
                if c_mb.grad is not None:
                    if dcs is None:
                        dcs = torch.zeros((m,) + c_mb.shape, dtype=c_mb.dtype,
                                          device=c_mb.device)
                    dcs[mb] += c_mb.grad
                if d == 0 and k == 0:  # a fresh injection: its gradient is x's
                    dxs[mb] += g.to(dxs.dtype)
                    g = torch.zeros_like(g)
            if t > 0:
                g_held = ppermute(g, group, -1)
        if size > 1:
            if dcs is None:  # this rank ran no tick, which no schedule gives
                raise RuntimeError("a pipeline stage ran no microbatch")
            dxs, dcs = (_sum_f32(a, group) for a in (dxs, dcs))
        return dxs, dcs, None, None, None


def _sum_f32(a: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``a`` over the group, taken in f32 (as JAX sums a bf16
    cotangent over the axis) and returned in a's dtype."""
    s = a.float()
    dist.all_reduce(s, group=group)
    return s.to(a.dtype)


def pipeline_blocks(apply_chunk: Callable, x: torch.Tensor, c: torch.Tensor, group,
                    num_chunks: int = 1, num_microbatches: Optional[int] = None
                    ) -> torch.Tensor:
    """Run this rank's chunks of a block stack pipelined over ``group``.

    ``apply_chunk(k, x_mb, c_mb)`` applies this rank's chunk k (virtual
    stage k S + d); x: (B, T, D) tokens and c: (B, ...) conditioning, the
    same on every rank of the group. Returns the whole (B, T, D) output on
    every rank. ``num_microbatches`` (M) defaults to S and must divide B;
    with more than one chunk it must be a multiple of S (microbatches are
    injected in groups of S)."""
    size = _group_size(group)
    v = int(num_chunks)
    if v < 1:
        raise ValueError(f"num_chunks={v}")
    m = int(num_microbatches) if num_microbatches else size
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by {m} microbatches")
    if v > 1 and m % size:
        raise ValueError(f"interleaved schedule injects in groups of {size} stages; "
                         f"microbatches {m} must be a multiple")
    xs = x.reshape(m, b // m, *x.shape[1:])
    cs = c.reshape(m, b // m, *c.shape[1:])
    if torch.is_grad_enabled() and (x.requires_grad or c.requires_grad):
        outs = _Pipeline.apply(xs, cs, apply_chunk, group, v)
    else:
        outs, _ = _forward(apply_chunk, xs, cs, group, v, keep_graph=False)
        outs = _broadcast_last(outs, group)
    return outs.reshape(b, *x.shape[1:])

