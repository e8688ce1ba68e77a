"""Parameter conversion into the port's modules.

``wan_params_from_numpy`` turns the JAX package's Wan parameter pytree, with
its leaves as numpy arrays, into a ``WanModel`` state dict. Two layout rules:
the JAX block weights are depth-stacked ``[L, ...]`` (one entry per block
here), and JAX's ``linear`` is ``x @ w`` with ``w: [d_in, d_out]`` while
``nn.Linear`` keeps ``[d_out, d_in]``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from magcache_tpu_torch.models.wan import WanConfig

_BLOCK_LINEARS = ("q", "k", "v", "o", "cross_q", "cross_k", "cross_v",
                  "cross_o", "ffn1", "ffn2")
_BLOCK_VECTORS = ("modulation", "norm_q", "norm_k", "cross_norm_q",
                  "cross_norm_k", "norm3_w", "norm3_b")


def wan_params_from_numpy(tree: dict, cfg: WanConfig, device=None,
                          dtype: Optional[torch.dtype] = None
                          ) -> Dict[str, torch.Tensor]:
    """State dict for ``WanModel(cfg)`` from a numpy Wan pytree.

    ``dtype`` is the dtype of the patch embedding and the block linears
    (default ``cfg.torch_dtype``); every other parameter is f32.
    """
    if cfg.model_type != "t2v" or cfg.vace_layers:
        raise NotImplementedError("only the t2v Wan parameters are ported")
    dtype = cfg.torch_dtype if dtype is None else dtype
    sd: Dict[str, torch.Tensor] = {}

    def put(name, arr, dt=torch.float32):
        sd[name] = torch.from_numpy(np.array(arr, np.float32)).to(
            device=device, dtype=dt)

    def put_linear(name, p, dt=torch.float32):
        put(f"{name}.weight", np.asarray(p["w"]).T, dt)
        put(f"{name}.bias", p["b"], dt)

    put_linear("patch_embedding", tree["patch_embedding"], dtype)
    for grp in ("text_embedding", "time_embedding"):
        for io in ("in", "out"):
            put_linear(f"{grp}.{io}", tree[grp][io])
    put_linear("time_projection", tree["time_projection"])
    blocks = tree["blocks"]
    for i in range(cfg.layers):
        for name in _BLOCK_LINEARS:
            put_linear(f"blocks.{i}.{name}",
                       {"w": blocks[name]["w"][i], "b": blocks[name]["b"][i]},
                       dtype)
        for name in _BLOCK_VECTORS:
            put(f"blocks.{i}.{name}", blocks[name][i])
    put("head.modulation", tree["head"]["modulation"])
    put_linear("head.out", tree["head"]["out"])
    return sd
