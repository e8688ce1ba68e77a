"""Explicit collectives over ``sp``: the counterpart of
``magcache_tpu.parallel.collectives`` for the sequence-parallel Wan path.

Every function here is a rank program: it takes this rank's shard and the
rank's ``MeshPlan`` and calls the group's collectives.

- ``split_sequence`` / ``gather_sequence``: keep this rank's rows of a whole
  tensor / all-gather the shards back;
- ``all_to_all_switch``: swap which of two axes is sharded with one
  all-to-all;
- ``ulysses_attention``: all-to-all scatters heads and gathers the sequence,
  each rank runs full-sequence attention (K1b) on ``H/sp`` heads, and the
  inverse all-to-all restores the sequence shards. With ``kv_replicated``
  (cross-attention: the short context is whole on every rank) only q is
  sharded and no collective runs;
- ``ring_attention``: each rank keeps its q shard while the k/v shards go
  round the ring; every step is one partial attention with its softmax state
  (K1c), merged in f32.

The ``sharded_*`` kernel wrappers of the JAX module (STDiT3, Latte and OSP
under ``sp``) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from magcache_tpu_torch.ops.attention import flash_attention_bhsd, flash_attention_bhsd_aux
from magcache_tpu_torch.parallel.mesh import MeshPlan

__all__ = ["split_sequence", "gather_sequence", "all_to_all_switch",
           "ulysses_attention", "ring_attention"]


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


def _local_full_attention(q, k, v, *, scale, kv_len, fixed_max):
    """Attention of local ``[B, S, h, D]`` q over the whole local k/v: K1b on
    head-major views (no transpose copies; o comes back in q's layout)."""
    out = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), scale=scale, kv_len=kv_len,
                               fixed_max=fixed_max)
    return out.transpose(1, 2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      plan: MeshPlan, *, scale: Optional[float] = None,
                      kv_len: Optional[int] = None, kv_replicated: bool = False,
                      fixed_max: Optional[float] = None) -> torch.Tensor:
    """Sequence-parallel attention over this rank's ``[B, S/sp, H, D]`` q
    (and k, v unless ``kv_replicated``). Heads must divide by ``sp``.
    Returns this rank's ``[B, S/sp, H, D]`` rows of the output."""
    sp = plan.sp
    if kv_replicated or sp == 1:
        # q stays sequence-sharded; attention over the whole local k/v
        return _local_full_attention(q, k, v, scale=scale, kv_len=kv_len,
                                     fixed_max=fixed_max)
    if q.shape[2] % sp:
        raise ValueError(f"ulysses_attention: {q.shape[2]} heads do not divide "
                         f"by sp = {sp}")
    # heads -> sp groups, sequence gathered in rank order
    g = plan.group
    qg, kg, vg = (g.all_to_all(t, 2, 1) for t in (q, k, v))
    og = _local_full_attention(qg, kg, vg, scale=scale, kv_len=kv_len,
                               fixed_max=fixed_max)
    # inverse: sequence -> sp shards, heads gathered
    return g.all_to_all(og, 1, 2)


def _partial_attention(q, k, v, *, scale):
    """Attention of ``[B, S, H, D]`` q over one k/v shard with its softmax
    state: ``(o [B, S, H, D], m, l [B, H, S])`` from K1c."""
    o, m, l = flash_attention_bhsd_aux(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), scale=scale)
    return o.transpose(1, 2), m, l


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   plan: MeshPlan, *, scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention over ``sp``: the k/v shards rotate (shard j goes to
    rank j + 1) while each rank keeps its ``[B, S/sp, H, D]`` q; the ``sp``
    partial results merge through their (m, l) state. The merge runs in f32
    with natural-base ``exp``; ``o`` is rounded to the activation dtype at
    each of the ``sp - 1`` merges and ``l`` carries ``w1 + w2``, as in the
    JAX function. Sequence memory stays ``1/sp`` with no gather, at the cost
    of ``sp`` sequential steps."""
    g = plan.group
    o, m, l = _partial_attention(q, k, v, scale=scale)
    kc, vc = k, v
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
    return o
