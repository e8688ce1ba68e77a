"""Tensor-parallel weight slices: the counterpart of the JAX package's
Megatron specs (``magcache_tpu.parallel.mesh``: ``_COL_PAT`` / ``_ROW_PAT``,
``_param_spec``, ``param_shardings``, ``shard_params``).

The same two patterns classify a parameter by the module that holds it:

- column-parallel (the output features split over ``tp``): q, k, v,
  cross_q / k / v, cross_k_img / cross_v_img, ffn1 (and the other families'
  qkv and MLP-in names); ``nn.Linear``'s ``[out, in]`` weight splits on dim
  0, and its bias with it;
- row-parallel (the input features split): o, cross_o, ffn2 (and the other
  families' projections and MLP-out names); the weight splits on dim 1, and
  the bias stays whole: it is added once, after the all-reduce over ``tp``;
- everything else (norm gains, modulation tables, embeddings, the head) is
  replicated.

A port parameter's name reads as the JAX path of the same leaf once its
block indices are dropped and ``weight`` / ``bias`` read ``w`` / ``b``
(``blocks.3.q.weight`` is ``blocks/q/w``), so ``param_kind`` gives every
Wan leaf the JAX package's own classification.

``slice_wan`` applies it to a ``WanModel``: a tp rank's model holds its
slices of every ``WanBlock`` (the trunk's and VACE's). VACE's
``before_proj`` and ``after_proj``, which the JAX specs lay out
row-parallel, stay whole in the port: their inputs and outputs are the
activations between blocks, which every tp rank holds whole, so slicing
them would add an all-reduce per hint to save a ``dim x dim`` weight. Local
ranks take views of one model (the weights sit on the card once); a
``torchrun`` process copies its own slices and keeps nothing else
(``copy=True``), and ``wan_from_state_dict`` cuts a checkpoint's state
dict on the host so that only a rank's slices reach its device.

FLUX (``slice_flux``, ``flux_from_state_dict``) takes the same patterns, but
four of its projections are fused: ``img_qkv`` / ``txt_qkv`` write
``[q | k | v]``, ``lin1`` ``[q | k | v | mlp]``, and ``lin2`` reads ``[o |
gelu(mlp)]``. The JAX package shards them declaratively, so a contiguous
``1/tp`` of the fused features is right there; here a rank computes with its
slice, so it must take its heads of each of q, k and v and its ``1/tp`` of
the MLP segment (``flux_segments``). A fused projection becomes a
``SegmentedLinear``: one view per segment on local ranks, one contiguous
copy of the rank's segments with ``copy``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["COL", "ROW", "jax_path", "param_kind", "tp_dim", "tp_sliced",
           "slice_tensor", "slice_wan", "wan_from_state_dict", "check_tp_split",
           "f32_product", "row_parallel", "tp_row_sums", "SegmentedLinear",
           "slice_segments", "flux_segments", "flux_tp_sliced", "check_flux_split",
           "slice_flux", "flux_from_state_dict", "slice_videosys"]

COL, ROW = "col", "row"

# the JAX package's patterns (magcache_tpu/parallel/mesh.py:142-151), as they are
_COL_PAT = re.compile(
    r"(q|k|v|cross_q|cross_k|cross_v|cross_k_img|cross_v_img|ffn1|"
    r"img_qkv|txt_qkv|lin1|img_mlp1|txt_mlp1|qkv|"
    r"qt|kt|vt|qc|ff1|ffc1|w1|w3)$")
_ROW_PAT = re.compile(
    r"(o|cross_o|ffn2|img_proj|txt_proj|lin2|img_mlp2|txt_mlp2|"
    r"ot|oc|add_out|add_out_t|ff2|ffc2|w2|(?<!cap_)proj)$")
_LEAF = {"weight": "w", "bias": "b"}


def jax_path(name: str) -> str:
    """The JAX path of a port parameter: block indices dropped, ``weight``
    / ``bias`` as ``w`` / ``b``, joined with ``/``."""
    parts = [p for p in name.split(".") if not p.isdigit()]
    parts[-1] = _LEAF.get(parts[-1], parts[-1])
    return "/".join(parts)


def param_kind(name: str, ndim: int) -> Optional[str]:
    """``COL``, ``ROW`` or None (replicated) for a port parameter of ``ndim``
    dims: the JAX ``_param_spec`` rules over ``jax_path(name)``. ``ROW``
    names only the weight: a row-parallel bias is replicated."""
    parts = jax_path(name).split("/")
    leaf = parts[-1]
    parent = parts[-2] if len(parts) >= 2 else ""
    if leaf == "w" and ndim >= 2:
        if _COL_PAT.search(parent):
            return COL
        if _ROW_PAT.search(parent):
            return ROW
    if leaf == "b" and _COL_PAT.search(parent):
        return COL
    if parent == "blocks" and ndim >= 2:
        # the JAX package's stacked bare-leaf layout (its UMT5)
        if leaf in ("q", "k", "v", "wi0", "wi1"):
            return COL
        if leaf in ("o", "wo"):
            return ROW
    return None


def tp_dim(name: str, ndim: int) -> Optional[int]:
    """The dim of the port's tensor that splits over tp: 0 for a
    column-parallel weight or bias (``[out, in]`` and ``[out]``), 1 for a
    row-parallel weight, None when replicated."""
    kind = param_kind(name, ndim)
    if kind == COL:
        return 0
    if kind == ROW:
        return 1
    return None


def tp_sliced(name: str, ndim: int) -> Optional[int]:
    """``tp_dim`` where the port slices the parameter (a ``WanBlock``'s, in
    the trunk or VACE's stack), else None."""
    if not (name.startswith("blocks.") or name.startswith("vace.blocks.")):
        return None
    return tp_dim(name, ndim)


def slice_tensor(t: torch.Tensor, dim: Optional[int], rank: int, tp: int,
                 what: str = "tensor") -> torch.Tensor:
    """Rank ``rank``'s ``1/tp`` of ``t`` along ``dim`` (a view; ``t`` itself
    when ``dim`` is None). Raises when the dim does not divide by ``tp``."""
    if dim is None or tp == 1:
        return t
    n = t.shape[dim]
    if n % tp:
        raise ValueError(f"{what}: dim {dim} of {tuple(t.shape)} does not divide by tp = {tp}")
    return t.narrow(dim, rank * (n // tp), n // tp)


def _set_param(root: nn.Module, name: str, t: torch.Tensor) -> None:
    *path, leaf = name.split(".")
    mod = root
    for p in path:
        mod = getattr(mod, p)
    setattr(mod, leaf, nn.Parameter(t, requires_grad=False))


def check_tp_split(cfg, tp: int, sp: int = 1, ring: bool = False) -> None:
    """Raises unless the Wan config's heads and FFN width split over the
    grid: ``tp`` ranks of ``heads / tp`` heads, and under Ulysses
    ``heads / (sp * tp)`` heads a rank after the all-to-all (the ring needs
    ``heads / tp`` only), as the JAX package requires."""
    if cfg.heads % tp or cfg.ffn_dim % tp:
        raise ValueError(f"tp = {tp}: {cfg.heads} heads and an FFN of {cfg.ffn_dim} must "
                         f"divide by tp")
    if not ring and (cfg.heads // tp) % sp:
        raise ValueError(f"sp {sp} x tp {tp}: {cfg.heads} heads over {sp * tp} ranks leave "
                         f"{cfg.heads / (sp * tp):g} a rank; Ulysses needs heads / (sp * tp) "
                         f"whole (the ring needs heads / tp)")


def _sliced_wan(cfg, params: Mapping[str, torch.Tensor], rank: int, tp: int,
               copy: bool, device) -> nn.Module:
    from magcache_tpu_torch.models.wan import WanModel

    check_tp_split(cfg, tp)
    out = WanModel(cfg, device="meta")
    for name, p in params.items():
        v = slice_tensor(p.detach(), tp_sliced(name, p.ndim), rank, tp, name)
        if copy:
            v = v.to(device, copy=True).contiguous()
        _set_param(out, name, v)
    left = [n for n, p in out.named_parameters() if p.is_meta]
    if left:
        raise ValueError(f"the Wan weights lack {left[:4]}")
    out.tp_slice = (rank, tp)
    return out.eval()


def slice_wan(model: nn.Module, rank: int, tp: int, *, copy: bool = False,
              device=None) -> nn.Module:
    """Rank ``rank``'s ``WanModel`` of ``tp``: a model built on the meta
    device whose parameters are ``model``'s, sliced (``tp_sliced``): views
    of ``model`` (local ranks: one copy of the weights on the card), or with
    ``copy`` contiguous copies on ``device`` (default the model's), so that
    a process may drop the whole model. The result carries ``tp_slice =
    (rank, tp)``."""
    params = dict(model.named_parameters())
    if device is None:
        device = next(iter(params.values())).device
    return _sliced_wan(model.cfg, params, rank, tp, copy, device)


def wan_from_state_dict(cfg, sd: Mapping[str, torch.Tensor], rank: int, tp: int,
                        device) -> nn.Module:
    """Rank ``rank``'s ``WanModel`` of ``tp`` from a whole state dict on the
    host (a checkpoint's, memory-mapped where the reader maps it): only the
    rank's slices and the replicated tensors are copied to ``device``."""
    return _sliced_wan(cfg, sd, rank, tp, True, device)


def f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` in f32, unrounded: ``[..., in] x [out, in] -> [..., out]``.
    On the card a bf16 GEMM with an f32 output (cuBLAS accumulates in f32
    either way; the single-rank ``nn.Linear`` rounds that to bf16 once), on
    the CPU the f32 product of the upcast operands. ``w`` may be a strided
    row-parallel slice."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda and x.dtype != torch.float32:
        out = torch.mm(x2, w.t(), out_dtype=torch.float32)
    else:
        out = x2.float() @ w.float().t()
    return out.reshape(*lead, w.shape[0])


def row_parallel(lin: nn.Module, x, group) -> torch.Tensor:
    """A row-parallel projection over a tp ``group``: this rank's f32
    partial product of its input slice ``x`` with its weight slice, summed
    over the group in f32, the whole bias added once, rounded to x's dtype
    once, as the single-rank GEMM rounds. ``lin`` is an ``nn.Linear`` or a
    row ``SegmentedLinear``, whose ``x`` is the list of its segments'
    inputs."""
    if isinstance(lin, SegmentedLinear):
        part, dtype = lin.partial(x), x[0].dtype
    else:
        part, dtype = f32_product(x, lin.weight), x.dtype
    out = group.all_reduce_sum(part)
    if lin.bias is not None:
        out = out + lin.bias.float()
    return out.to(dtype)


def tp_row_sums(group, tensors) -> list:
    """Each tensor's rows' f32 sums of squares (``[B, S_i]``, K2's
    statistics pass on the card) summed over the tp ``group`` in one
    all-reduce: the statistic of the whole rows, of which each rank holds
    a slice."""
    from magcache_tpu_torch.ops.fused_prologue import row_sumsq

    sums = [row_sumsq(t) for t in tensors]
    tot = group.all_reduce_sum(torch.cat([v.reshape(-1) for v in sums]))
    return [part.reshape(v.shape) for part, v in
            zip(tot.split([v.numel() for v in sums]), sums)]


class SegmentedLinear(nn.Module):
    """A tp rank's slices of a fused projection, whose output features
    (``dim`` 0, column-parallel) or input features (``dim`` 1, row-parallel)
    are a concatenation of segments each split over tp.

    ``weights``: the rank's slice of each segment (views of the whole
    weight), or one contiguous tensor of them all; a column projection's
    ``biases`` likewise, a row projection's ``bias`` is whole (added once,
    after the all-reduce). A column projection's ``forward`` returns the
    segments' outputs side by side, in the whole projection's order; a row
    projection's ``partial`` takes its segments' inputs and returns this
    rank's f32 share of the product."""

    def __init__(self, weights: Sequence[torch.Tensor], dim: int,
                 biases: Optional[Sequence[torch.Tensor]] = None,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.dim = dim
        self.weights = nn.ParameterList(nn.Parameter(w, requires_grad=False)
                                        for w in weights)
        self.biases = (None if biases is None else
                       nn.ParameterList(nn.Parameter(b, requires_grad=False) for b in biases))
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bs = [None] * len(self.weights) if self.biases is None else list(self.biases)
        outs = [F.linear(x, w, b) for w, b in zip(self.weights, bs)]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)

    def partial(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(self.weights) == 1 and len(xs) > 1:
            xs = [torch.cat(list(xs), dim=-1)]
        if len(xs) != len(self.weights):
            raise ValueError(f"SegmentedLinear: {len(xs)} inputs for "
                             f"{len(self.weights)} segments")
        out = f32_product(xs[0], self.weights[0])
        for x, w in zip(xs[1:], self.weights[1:]):
            out = out + f32_product(x, w)
        return out


def slice_segments(t: torch.Tensor, dim: int, sizes: Sequence[int], rank: int,
                   tp: int, what: str = "tensor") -> List[torch.Tensor]:
    """Rank ``rank``'s ``1/tp`` of each segment of ``t`` along ``dim``,
    where ``sizes`` are the segments' lengths in order (views)."""
    if sum(sizes) != t.shape[dim]:
        raise ValueError(f"{what}: segments {tuple(sizes)} do not cover dim {dim} of "
                         f"{tuple(t.shape)}")
    out, off = [], 0
    for n in sizes:
        out.append(slice_tensor(t.narrow(dim, off, n), dim, rank, tp, what))
        off += n
    return out


# FLUX's fused projections and the segments of their split features
_FLUX_FUSED = ("img_qkv", "txt_qkv", "lin1", "lin2")


def flux_segments(name: str, cfg) -> Tuple[int, ...]:
    """The segment lengths of a FLUX parameter's split features: ``[q | k |
    v]`` for ``img_qkv`` / ``txt_qkv``, ``[q | k | v | mlp]`` for ``lin1``'s
    outputs, ``[o | mlp]`` for ``lin2``'s inputs; one segment otherwise."""
    module = name.split(".")[-2] if "." in name else ""
    d, m = cfg.hidden, cfg.mlp_ratio * cfg.hidden
    return {"img_qkv": (d, d, d), "txt_qkv": (d, d, d), "lin1": (d, d, d, m),
            "lin2": (d, m)}.get(module, ())


def check_flux_split(cfg, tp: int, sp: int = 1, ring: bool = False) -> None:
    """Raises unless FLUX's heads and MLP split over the grid: ``heads / tp``
    heads a tp rank, and under Ulysses ``heads / (sp * tp)`` a rank after the
    all-to-all (the ring needs ``heads / tp`` only)."""
    mlp = cfg.mlp_ratio * cfg.hidden
    if cfg.heads % tp or mlp % tp:
        raise ValueError(f"tp = {tp}: FLUX's {cfg.heads} heads and MLP of {mlp} must "
                         f"divide by tp")
    if not ring and (cfg.heads // tp) % sp:
        raise ValueError(f"sp {sp} x tp {tp}: FLUX's {cfg.heads} heads over {sp * tp} "
                         f"ranks leave {cfg.heads / (sp * tp):g} a rank; Ulysses needs "
                         f"heads / (sp * tp) whole (the ring needs heads / tp)")


def _sliced(model_cls, cfg, params: Mapping[str, torch.Tensor], rank: int, tp: int,
            copy: bool, device, sliced, segments, fused_names, join_fused: bool) -> nn.Module:
    """A ``model_cls(cfg)`` built on the meta device holding rank ``rank``'s
    slices of ``params``: ``sliced(name, ndim)`` gives a parameter's split
    dim (None: whole), ``segments(name)`` the segment lengths of a fused
    projection's split features, whose modules (named in ``fused_names``)
    become ``SegmentedLinear``s: one view a segment, or one contiguous
    tensor of the rank's segments with ``copy`` or ``join_fused``."""
    out = model_cls(cfg, device="meta")

    def own(v: torch.Tensor) -> torch.Tensor:
        return v.to(device, copy=True).contiguous() if copy else v

    fused: Dict[str, dict] = {}
    for name, p in params.items():
        p = p.detach()
        dim = sliced(name, p.ndim)
        module, _, leaf = name.rpartition(".")
        if not (name.startswith(sliced.prefixes) and module.split(".")[-1] in fused_names):
            _set_param(out, name, own(slice_tensor(p, dim, rank, tp, name)))
        elif dim is None:           # a fused row projection's whole bias
            fused.setdefault(module, {})["bias"] = own(p)
        else:
            parts = slice_segments(p, dim, segments(name), rank, tp, name)
            if copy or join_fused:  # the rank's segments, one contiguous tensor
                parts = [torch.cat(parts, dim=dim).to(device, copy=True).contiguous()]
            fused.setdefault(module, {})[leaf] = (dim, parts)
    for module, got in fused.items():
        dim, weights = got["weight"]
        seg = SegmentedLinear(weights, dim, biases=got["bias"][1] if dim == 0 else None,
                              bias=got.get("bias") if dim == 1 else None)
        parent, attr = module.rsplit(".", 1)
        setattr(out.get_submodule(parent), attr, seg)
    left = [n for n, p in out.named_parameters() if p.is_meta]
    if left:
        raise ValueError(f"the {model_cls.__name__} weights lack {left[:4]}")
    out.tp_slice = (rank, tp)
    return out.eval()


class _BlockParams:
    """``tp_dim`` for the parameters under ``prefixes`` (a model's blocks),
    None elsewhere."""

    def __init__(self, *prefixes: str):
        self.prefixes = prefixes

    def __call__(self, name: str, ndim: int) -> Optional[int]:
        return tp_dim(name, ndim) if name.startswith(self.prefixes) else None


flux_tp_sliced = _BlockParams("double_blocks.", "single_blocks.")


def _sliced_flux(cfg, params, rank, tp, copy, device) -> nn.Module:
    from magcache_tpu_torch.models.flux import FluxModel

    check_flux_split(cfg, tp)
    return _sliced(FluxModel, cfg, params, rank, tp, copy, device, flux_tp_sliced,
                   lambda name: flux_segments(name, cfg), _FLUX_FUSED, False)


def slice_flux(model: nn.Module, rank: int, tp: int, *, copy: bool = False,
               device=None) -> nn.Module:
    """Rank ``rank``'s ``FluxModel`` of ``tp`` (``slice_wan``'s contract):
    its blocks' linears sliced by ``flux_tp_sliced``, the fused ones into
    ``SegmentedLinear`` modules (``flux_segments``); views of ``model``, or
    with ``copy`` contiguous copies on ``device``. Carries ``tp_slice``."""
    params = dict(model.named_parameters())
    if device is None:
        device = next(iter(params.values())).device
    return _sliced_flux(model.cfg, params, rank, tp, copy, device)


def flux_from_state_dict(cfg, sd: Mapping[str, torch.Tensor], rank: int, tp: int,
                         device) -> nn.Module:
    """Rank ``rank``'s ``FluxModel`` of ``tp`` from a whole state dict on the
    host: only the rank's slices and the replicated tensors reach
    ``device``."""
    return _sliced_flux(cfg, sd, rank, tp, True, device)


# the VideoSys trunks' blocks and their fused projections ([q | k | v] and
# cross-attention's [k | v])
_VIDEOSYS_BLOCKS = {"STDiT3Model": ("spatial.", "temporal."),
                    "LatteModel": ("spatial.", "temporal."), "OSPModel": ("blocks.",)}


def slice_videosys(model: nn.Module, rank: int, tp: int) -> nn.Module:
    """Rank ``rank``'s STDiT3, Latte or Open-Sora-Plan v1.2 model of ``tp``
    by the JAX package's patterns (STDiT3's ``mlp1`` / ``mlp2`` match none,
    so its MLP stays whole, as in JAX): views of ``model``, but the fused
    ``qkv`` and ``cross_kv`` as one contiguous copy of the rank's heads of
    each of q, k, v (k, v), the weight a fused kernel (K7) reads. The heads
    must divide by tp."""
    kind = type(model).__name__
    cfg = model.cfg
    if cfg.heads % tp:
        raise ValueError(f"tp = {tp}: {kind}'s {cfg.heads} heads do not divide by tp")
    d = cfg.hidden

    def segments(name):
        return (d, d, d) if name.split(".")[-2] == "qkv" else (d, d)

    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    return _sliced(type(model), cfg, params, rank, tp, False, device,
                   _BlockParams(*_VIDEOSYS_BLOCKS[kind]), segments, ("qkv", "cross_kv"), True)
