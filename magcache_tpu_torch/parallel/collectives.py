"""Explicit collectives over the (dp, sp, tp) grid: the counterpart of
``magcache_tpu.parallel.collectives``.

Every function here is a rank program: it takes this rank's shard and the
rank's ``MeshPlan`` and calls the group's collectives.

- ``split_sequence`` / ``gather_sequence``: keep this rank's rows of a whole
  tensor / all-gather the shards back;
- ``all_to_all_switch``: swap which of two axes is sharded with one
  all-to-all (the reference's DSP switch);
- ``ulysses_attention``: all-to-all scatters heads and gathers the sequence,
  each rank runs full-sequence attention (K1b) on ``H/sp`` heads, and the
  inverse all-to-all restores the sequence shards. With ``kv_replicated``
  (cross-attention: the short context is whole on every rank) only q is
  sharded and no collective runs. ``whole_prefix`` rows that every rank
  holds whole (FLUX's text tokens) enter it once;
- ``ring_attention``: each rank keeps its q shard while the k/v shards go
  round the ring; every step is one partial attention with its softmax state
  (K1c), merged in f32.

The spatial-temporal trunks (STDiT3, Latte) under a plan:

- ``VideoShards``: a ``[rows, T, S, d]`` video's two layouts on a rank. The
  frames layout (spatial blocks) holds ``rows/dp`` rows and ``T/sp`` whole
  frames: the spatial kernels' batch of ``rows * T`` frames over ``dp x
  sp``. The tokens layout (temporal blocks, and every block of the
  unpacked composition) holds ``rows/dp`` rows and ``S/sp`` of each
  frame's tokens: the temporal groups over ``dp``, their tokens over
  ``sp``. Uneven counts are padded with zero rows, frames and tokens, which
  never enter a computation that is kept (exact). One ``all_to_all`` over
  sp switches between the layouts.
- The ``sharded_*`` kernel wrappers (JAX ``sharded_grouped_attention_
  fused_qkv``, ``sharded_lnmod_matmul``, ``sharded_matmul_gated_residual``,
  ``sharded_fused_cross_attention``) run K5, K7, K8 and K6 on such a shard.
  The kernels are per token or per group, and a group never crosses a
  shard, so at tp 1 they run on whole weights with no collective. At
  ``tp > 1`` a rank holds ``H/tp`` heads (each of q, k and v sliced by
  heads, ``parallel.shard``; the JAX package's head-major pack is not
  ported, so K5 keeps its layout on ``H/tp`` heads), and the row-parallel
  projections end in the f32 all-reduce over tp, the JAX package's
  composed path there.
"""

from __future__ import annotations

from typing import Optional

import torch

from magcache_tpu_torch.ops.attention import (KERNEL_HEAD_DIM, attention,
                                              flash_attention_bhsd, flash_attention_bhsd_aux,
                                              fused_cross_attention,
                                              grouped_attention_fused_qkv)
from magcache_tpu_torch.ops.fused_prologue import lnmod_matmul, matmul_gated_residual
from magcache_tpu_torch.parallel.mesh import MeshPlan
from magcache_tpu_torch.parallel.shard import SegmentedLinear, row_parallel

__all__ = ["split_sequence", "gather_sequence", "all_to_all_switch",
           "ulysses_attention", "ring_attention", "VideoShards", "tp_out",
           "sharded_grouped_attention_fused_qkv", "sharded_lnmod_matmul",
           "sharded_matmul_gated_residual", "sharded_fused_cross_attention"]


def split_sequence(x: torch.Tensor, plan: MeshPlan, dim: int = 1) -> torch.Tensor:
    """This rank's contiguous ``1/sp`` of ``x`` along ``dim`` (a view)."""
    n = plan.shard_len(x.shape[dim], f"split_sequence: dim {dim}")
    return x.narrow(dim, plan.rank * n, n)


def gather_sequence(x: torch.Tensor, plan: MeshPlan, dim: int = 1) -> torch.Tensor:
    """All-gather of the ranks' shards along ``dim``, in rank order."""
    return plan.group.all_gather(x, dim)


def all_to_all_switch(x: torch.Tensor, plan: MeshPlan, scatter_dim: int,
                      gather_dim: int) -> torch.Tensor:
    """Reshard from ``gather_dim``-sharded to ``scatter_dim``-sharded with
    one all-to-all: this rank's shard is cut along ``scatter_dim``, and the
    pieces it receives are concatenated along ``gather_dim``."""
    return plan.group.all_to_all(x, scatter_dim, gather_dim)


def _kernel_heads(scale, *ts):
    """q, k and v zero-padded to K1b's head dim of 128 on a CUDA tensor
    (exact: zero lanes add 0 to every score and fill only output lanes that
    are dropped), the head dim to slice back to, and the softmax scale:
    ``scale``, or ``1/sqrt(D)`` of the unpadded head dim."""
    d = ts[0].shape[-1]
    if ts[0].is_cuda and d < KERNEL_HEAD_DIM:
        ts = tuple(torch.nn.functional.pad(t, (0, KERNEL_HEAD_DIM - d)) for t in ts)
    return ts, d, d ** -0.5 if scale is None else scale


def _local_full_attention(q, k, v, *, scale, kv_len, fixed_max):
    """Attention of local ``[B, S, h, D]`` q over the whole local k/v: K1b on
    head-major views (no transpose copies; o comes back in q's layout)."""
    (q, k, v), d, scale = _kernel_heads(scale, q, k, v)
    out = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), scale=scale, kv_len=kv_len,
                               fixed_max=fixed_max)
    return out.transpose(1, 2)[..., :d]


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      plan: MeshPlan, *, scale: Optional[float] = None,
                      kv_len: Optional[int] = None, kv_replicated: bool = False,
                      fixed_max: Optional[float] = None,
                      whole_prefix: int = 0) -> torch.Tensor:
    """Sequence-parallel attention over this rank's ``[B, S/sp, H, D]`` q
    (and k, v unless ``kv_replicated``). Heads must divide by ``sp``.
    Returns this rank's ``[B, S/sp, H, D]`` rows of the output.

    ``whole_prefix`` rows lead q, k and v whole on every rank (FLUX's text
    tokens): each rank takes its ``H/sp`` heads of them locally, ahead of
    the gathered shards, so they enter the attention once, and their output
    is all-gathered over the heads afterwards."""
    sp = plan.sp
    if kv_replicated or sp == 1:
        # q stays sequence-sharded; attention over the whole local k/v
        return _local_full_attention(q, k, v, scale=scale, kv_len=kv_len,
                                     fixed_max=fixed_max)
    if q.shape[2] % sp:
        raise ValueError(f"ulysses_attention: {q.shape[2]} heads do not divide "
                         f"by sp = {sp}")
    # heads -> sp groups, sequence gathered in rank order
    g, p = plan.group, whole_prefix
    hl = q.shape[2] // sp

    def gather(t):
        got = g.all_to_all(t[:, p:], 2, 1)
        return torch.cat([t[:, :p, g.rank * hl:(g.rank + 1) * hl], got], 1) if p else got

    og = _local_full_attention(gather(q), gather(k), gather(v), scale=scale,
                               kv_len=kv_len, fixed_max=fixed_max)
    # inverse: sequence -> sp shards, heads gathered
    out = g.all_to_all(og[:, p:], 1, 2)
    return torch.cat([g.all_gather(og[:, :p], 2), out], 1) if p else out


def _partial_attention(q, k, v, *, scale):
    """Attention of ``[B, S, H, D]`` q over one k/v shard with its softmax
    state: ``(o [B, S, H, D], m, l [B, H, S])`` from K1c."""
    (q, k, v), d, scale = _kernel_heads(scale, q, k, v)
    o, m, l = flash_attention_bhsd_aux(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), scale=scale)
    return o.transpose(1, 2)[..., :d], m, l


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   plan: MeshPlan, *, scale: Optional[float] = None,
                   whole_prefix: int = 0) -> torch.Tensor:
    """Ring attention over ``sp``: the k/v shards rotate (shard j goes to
    rank j + 1) while each rank keeps its ``[B, S/sp, H, D]`` q; the ``sp``
    partial results merge through their (m, l) state. The merge runs in f32
    with natural-base ``exp``; ``o`` is rounded to the activation dtype at
    each of the ``sp - 1`` merges and ``l`` carries ``w1 + w2``, as in the
    JAX function. Sequence memory stays ``1/sp`` with no gather, at the cost
    of ``sp`` sequential steps.

    ``whole_prefix`` rows lead q, k and v whole on every rank (FLUX's text
    tokens, a count that divides by sp): rank r queries its ``1/sp`` of
    them beside its shard, their keys join rank r's first step only, only
    the shards rotate, and their output is all-gathered over the ranks."""
    g, p = plan.group, whole_prefix
    kc, vc = k[:, p:], v[:, p:]
    if p:
        if p % plan.sp:
            raise ValueError(f"ring_attention: {p} whole rows do not divide by "
                             f"sp = {plan.sp}")
        pl = p // plan.sp
        q = torch.cat([q[:, g.rank * pl:(g.rank + 1) * pl], q[:, p:]], 1)
    o, m, l = _partial_attention(q, k, v, scale=scale)
    for _ in range(plan.sp - 1):
        kc, vc = g.ring_shift(kc), g.ring_shift(vc)
        o2, m2, l2 = _partial_attention(q, kc, vc, scale=scale)
        m_new = torch.maximum(m, m2)
        w1 = l * torch.exp(m - m_new)
        w2 = l2 * torch.exp(m2 - m_new)
        tot = w1 + w2
        wt1 = (w1 / tot).transpose(1, 2)[..., None]       # [B, S, H, 1]
        wt2 = (w2 / tot).transpose(1, 2)[..., None]
        o = (o.float() * wt1 + o2.float() * wt2).to(o.dtype)
        m, l = m_new, tot
    return torch.cat([g.all_gather(o[:, :pl], 1), o[:, pl:]], 1) if p else o


def _pad(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` with zeros appended along ``dim`` up to length ``n``."""
    if x.shape[dim] == n:
        return x
    shape = list(x.shape)
    shape[dim] = n - x.shape[dim]
    return torch.cat([x, x.new_zeros(shape)], dim)


class VideoShards:
    """This rank's layouts of a ``[rows, T*S, d]`` video trunk (module
    docstring): ``frames`` ``[rows/dp, T/sp, S, d]`` and ``tokens``
    ``[rows/dp, T, S/sp, d]``, each count rounded up (zero padding)."""

    def __init__(self, plan: MeshPlan, rows: int, t: int, s: int):
        self.plan, self.rows, self.t, self.s = plan, rows, t, s
        self.rl = -(-rows // plan.dp)
        self.tl = -(-t // plan.sp)
        self.sl = -(-s // plan.sp)

    def rows_of(self, x: torch.Tensor) -> torch.Tensor:
        """This dp rank's rows of a per-row tensor (zero rows past the end)."""
        p = self.plan
        if p.dp == 1:
            return x
        return _pad(x, 0, self.rl * p.dp).narrow(0, p.dp_rank * self.rl, self.rl)

    def mine(self, x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """This sp rank's ``n`` entries of ``x`` along ``dim`` (padded)."""
        return _pad(x, dim, n * self.plan.sp).narrow(dim, self.plan.rank * n, n)

    def frames(self, h: torch.Tensor) -> torch.Tensor:
        """The frames layout of the whole ``h``."""
        return self.mine(self.rows_of(h).reshape(self.rl, self.t, self.s, -1), 1, self.tl)

    def tokens(self, h: torch.Tensor) -> torch.Tensor:
        """The tokens layout of the whole ``h``."""
        return self.mine(self.rows_of(h).reshape(self.rl, self.t, self.s, -1), 2, self.sl)

    def frames_to_tokens(self, hf: torch.Tensor) -> torch.Tensor:
        """One all-to-all over sp: each rank sends every rank its share of
        its frames' tokens and keeps the real frames."""
        if self.plan.sp == 1:
            return hf
        ht = all_to_all_switch(_pad(hf, 2, self.sl * self.plan.sp), self.plan, 2, 1)
        return ht[:, :self.t]

    def tokens_to_frames(self, ht: torch.Tensor) -> torch.Tensor:
        """The inverse all-to-all: each rank gets its frames' real tokens."""
        if self.plan.sp == 1:
            return ht
        hf = all_to_all_switch(_pad(ht, 1, self.tl * self.plan.sp), self.plan, 1, 2)
        return hf[:, :, :self.s]

    def _whole(self, h: torch.Tensor) -> torch.Tensor:
        p = self.plan
        if p.dp > 1:
            h = p.dp_group.all_gather(h, 0)
        return h[:self.rows].reshape(self.rows, self.t * self.s, -1)

    def gather_frames(self, hf: torch.Tensor) -> torch.Tensor:
        """The whole ``[rows, T*S, d]`` from every rank's frames."""
        if self.plan.sp > 1:
            hf = self.plan.group.all_gather(hf, 1)[:, :self.t]
        return self._whole(hf)

    def gather_tokens(self, ht: torch.Tensor) -> torch.Tensor:
        """The whole ``[rows, T*S, d]`` from every rank's tokens."""
        if self.plan.sp > 1:
            ht = self.plan.group.all_gather(ht, 2)[:, :, :self.s]
        return self._whole(ht)


def tp_out(lin, x: torch.Tensor, plan: Optional[MeshPlan]) -> torch.Tensor:
    """A row-parallel projection: ``lin(x)`` on one tp rank, else the f32
    all-reduce over tp of the rank's partial product (``row_parallel``)."""
    if plan is None or plan.tp == 1:
        return lin(x)
    return row_parallel(lin, x, plan.tp_group)


def _fused(lin):
    """(weight, bias) of a linear that one kernel can read: an ``nn.Linear``
    or a column ``SegmentedLinear`` held as one contiguous tensor."""
    if isinstance(lin, SegmentedLinear):
        if len(lin.weights) != 1:
            raise ValueError("a fused kernel needs the rank's segments as one tensor "
                             "(slice with contiguous fused weights)")
        return lin.weights[0], None if lin.biases is None else lin.biases[0]
    return lin.weight, lin.bias


def _tp(plan: Optional[MeshPlan]) -> int:
    return 1 if plan is None else plan.tp


def sharded_grouped_attention_fused_qkv(qkv: torch.Tensor, heads: int,
                                        plan: Optional[MeshPlan], *, group: int,
                                        **kw) -> torch.Tensor:
    """K5 (K5r) on a rank's shard (JAX ``sharded_grouped_attention_fused_
    qkv``): ``qkv`` ``[B, N, 3*(H/tp)*D]`` holds whole groups, a frames
    shard's frames (spatial) or a tokens shard's groups of T (temporal), and
    the rank's ``H/tp`` heads of each of q, k and v. No collective. ``plan``
    None: one rank, all ``heads``."""
    tp = _tp(plan)
    if heads % tp:
        raise ValueError(f"tp = {tp}: {heads} heads do not divide by tp")
    return grouped_attention_fused_qkv(qkv, heads // tp, group=group, **kw)


def sharded_lnmod_matmul(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, lin,
                         plan: Optional[MeshPlan], *, act: Optional[str] = None,
                         eps: float = 1e-6,
                         batch_repeat: int = 1) -> torch.Tensor:
    """K7 on a rank's token shard (JAX ``sharded_lnmod_matmul``) with the
    rows' modulation: LayerNorm is per token, so no collective. ``lin`` is
    whole, or a column-parallel rank's slice (its output features)."""
    w, b = _fused(lin)
    return lnmod_matmul(x, scale, shift, w, b, act=act, eps=eps, batch_repeat=batch_repeat)


def sharded_matmul_gated_residual(x: torch.Tensor, lin, gate: torch.Tensor,
                                  resid: Optional[torch.Tensor], plan: Optional[MeshPlan],
                                  *, rows_out: Optional[int] = None,
                                  batch_repeat: int = 1) -> torch.Tensor:
    """K8 on a rank's token shard at tp 1 or on one rank (JAX ``sharded_
    matmul_gated_residual``: whole weights, no collective). At ``tp > 1``
    ``lin`` is row-parallel: the f32 all-reduce over tp of the rank's
    partial product, the bias once, one rounding, then the f32 gate (row
    ``b // batch_repeat`` of ``gate`` for batch ``b``) and the residual, as
    the JAX composed path rounds."""
    if _tp(plan) == 1:
        return matmul_gated_residual(x, lin.weight, lin.bias, gate, resid,
                                     rows_out=rows_out, batch_repeat=batch_repeat)
    a = row_parallel(lin, x, plan.tp_group)
    g = gate.float().repeat_interleave(batch_repeat, 0)[:, None]
    out = (g * a.float()).to(x.dtype)
    return out if resid is None else resid + out


def sharded_fused_cross_attention(x: torch.Tensor, q_lin, k: torch.Tensor, v: torch.Tensor,
                                  o_lin, heads: int, plan: Optional[MeshPlan], *,
                                  scale: Optional[float] = None,
                                  true_d: Optional[int] = None,
                                  residual: bool = False) -> torch.Tensor:
    """Cross-attention of a rank's query tokens to the whole caption (JAX
    ``sharded_fused_cross_attention``): K6 with whole weights at tp 1 and on
    one rank. At
    ``tp > 1`` the rank's ``H/tp`` heads: its ``q_lin`` columns, ``k`` and
    ``v`` its heads' (``[B, L, (H/tp)*D]``), K1b over them (the context is
    whole on every rank, so no sp collective) and ``o_lin`` row-parallel
    with the f32 all-reduce over tp."""
    if _tp(plan) == 1:
        return fused_cross_attention(x, q_lin.weight, q_lin.bias, k, v, o_lin.weight,
                                     o_lin.bias, heads, scale=scale, true_d=true_d,
                                     residual=residual)
    hl = heads // plan.tp
    o = attention(q_lin(x).unflatten(-1, (hl, -1)), k.unflatten(-1, (hl, -1)),
                  v.unflatten(-1, (hl, -1)), scale=scale, plan=plan, kv_replicated=True)
    c = row_parallel(o_lin, o.flatten(-2), plan.tp_group)
    return x + c if residual else c
