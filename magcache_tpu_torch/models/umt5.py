"""UMT5 text encoder (umt5-xxl, Wan's text conditioning): the names of
``magcache_tpu.models.umt5``'s port, and its checkpoint loading.

UMT5 is the T5-family encoder of ``models/t5.py`` with a relative-position
bias in every layer (``UMT5Config.per_layer_bias``); ``UMT5Encoder`` encodes
prompts with it. Given a path (a Wan ``ckpt_dir`` holding
``models_t5_umt5-xxl-enc-*.pth``, an HF directory, or one weights file) in
place of a config, ``T5Encoder`` loads the weights (``load_umt5_encoder``)
and, as no tokenizer files are read here, tokenizes with
``FallbackHashTokenizer`` (which warns).

Two key layouts (``convert_umt5_state_dict``): HF ``UMT5EncoderModel``
(``shared.weight``, ``encoder.block.N.layer.0.SelfAttention.{q,k,v,o,
relative_attention_bias}``, ``layer.1.DenseReluDense.{wi_0,wi_1,wo}``) and
the wan package's own (``token_embedding.weight``, ``blocks.N.{norm1,norm2}``,
``blocks.N.attn.{q,k,v,o}``, ``blocks.N.pos_embedding.embedding``,
``blocks.N.ffn.{gate.0,fc1,fc2}``, ``norm.weight``).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Optional, Tuple

import torch

from magcache_tpu_torch.models.checkpoint import (load_safetensors_dir, torch_load_flat,
                                                  vec)
from magcache_tpu_torch.models.t5 import (UMT5_XXL, T5Model, UMT5Config,
                                          relative_position_buckets, t5_encode)
from magcache_tpu_torch.models.text import T5Encoder

__all__ = ["UMT5Config", "UMT5Model", "UMT5Encoder", "UMT5_XXL", "umt5_encode",
           "relative_position_buckets", "convert_umt5_state_dict", "sniff_umt5_config",
           "load_umt5_state_dict", "load_umt5_encoder"]

UMT5Model = T5Model
UMT5Encoder = T5Encoder           # a path as its config loads the checkpoint
umt5_encode = t5_encode


def convert_umt5_state_dict(sd: Dict[str, torch.Tensor], cfg: UMT5Config) -> dict:
    """A UMT5 encoder state dict (either layout) as the JAX UMT5 tree,
    blocks as per-block lists."""
    def blocks(fmt, transpose=False):
        out = [vec(sd, fmt.format(i)) for i in range(cfg.layers)]
        return [w.T for w in out] if transpose else out

    if "token_embedding.weight" in sd:          # the wan package's naming
        b, names = "blocks.{}.", ("norm1.weight", "attn.q.weight", "attn.k.weight",
                                  "attn.v.weight", "attn.o.weight",
                                  "pos_embedding.embedding.weight", "norm2.weight",
                                  "ffn.gate.0.weight", "ffn.fc1.weight", "ffn.fc2.weight")
        embed, final = "token_embedding.weight", "norm.weight"
    else:
        b = "encoder.block.{}.layer."
        names = ("0.layer_norm.weight", "0.SelfAttention.q.weight",
                 "0.SelfAttention.k.weight", "0.SelfAttention.v.weight",
                 "0.SelfAttention.o.weight", "0.SelfAttention.relative_attention_bias.weight",
                 "1.layer_norm.weight", "1.DenseReluDense.wi_0.weight",
                 "1.DenseReluDense.wi_1.weight", "1.DenseReluDense.wo.weight")
        embed, final = "shared.weight", "encoder.final_layer_norm.weight"
    ours = ("ln1", "q", "k", "v", "o", "rel", "ln2", "wi0", "wi1", "wo")
    linears = {"q", "k", "v", "o", "wi0", "wi1", "wo"}
    return {"embed": vec(sd, embed), "final_ln": vec(sd, final),
            "blocks": {o: blocks(b + n, o in linears) for o, n in zip(ours, names)}}


def sniff_umt5_config(sd: Dict[str, torch.Tensor], config_json: Optional[dict] = None,
                      dtype: str = "float32") -> UMT5Config:
    """A ``UMT5Config`` from a ``config.json`` (when given), filled in and
    cross-checked from the weights' shapes."""
    kw: dict = {}
    for src, dst in (("vocab_size", "vocab_size"), ("d_model", "d_model"), ("d_kv", "d_kv"),
                     ("d_ff", "d_ff"), ("num_layers", "layers"), ("num_heads", "heads"),
                     ("relative_attention_num_buckets", "rel_buckets"),
                     ("relative_attention_max_distance", "rel_max_distance")):
        if config_json and src in config_json:
            kw[dst] = int(config_json[src])
    hf = "shared.weight" in sd
    emb = "shared.weight" if hf else "token_embedding.weight"
    if emb in sd:
        kw["vocab_size"], kw["d_model"] = map(int, sd[emb].shape)
    rel0 = ("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight" if hf
            else "blocks.0.pos_embedding.embedding.weight")
    if rel0 in sd:
        kw["rel_buckets"], kw["heads"] = map(int, sd[rel0].shape)
    q0 = "encoder.block.0.layer.0.SelfAttention.q.weight" if hf else "blocks.0.attn.q.weight"
    if q0 in sd and "heads" in kw:
        kw["d_kv"] = int(sd[q0].shape[0]) // kw["heads"]
    ff0 = "encoder.block.0.layer.1.DenseReluDense.wo.weight" if hf else "blocks.0.ffn.fc2.weight"
    if ff0 in sd:
        kw["d_ff"] = int(sd[ff0].shape[1])
    pat = "encoder.block.{}.layer.0.layer_norm.weight" if hf else "blocks.{}.norm1.weight"
    n = 0
    while pat.format(n) in sd:
        n += 1
    if n:
        kw["layers"] = n
    return UMT5Config(dtype=dtype, **kw)


def load_umt5_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A UMT5 state dict from a Wan ``ckpt_dir`` (its ``*umt5*.pth`` wins over
    the DiT's safetensors beside it), an HF directory, or one file."""
    if os.path.isdir(path):
        named = sorted(glob.glob(os.path.join(path, "*umt5*.pth")))
        if named:
            path = named[0]
        elif glob.glob(os.path.join(path, "*.safetensors")):
            return load_safetensors_dir(path)
        else:
            pths = sorted(glob.glob(os.path.join(path, "*.pth")))
            if not pths:
                raise FileNotFoundError(f"no safetensors or .pth under {path}")
            path = pths[0]
    if path.endswith((".pth", ".pt", ".bin")):
        return torch_load_flat(path)
    return load_safetensors_dir(path)


def load_umt5_encoder(path: str, device="cuda", dtype: str = "float32"
                      ) -> Tuple[UMT5Config, T5Model]:
    """``(config, model)`` of a UMT5 checkpoint (``config.json`` beside it
    is read when present); the model's weights in ``dtype`` on ``device``."""
    from magcache_tpu_torch.models.convert import umt5_params_from_numpy

    sd = load_umt5_state_dict(path)
    base = path if os.path.isdir(path) else os.path.dirname(path)
    cj = os.path.join(base, "config.json")
    cfg_json = None
    if os.path.exists(cj):
        with open(cj) as f:
            cfg_json = json.load(f)
    cfg = sniff_umt5_config(sd, cfg_json, dtype=dtype)
    model = T5Model(cfg, torch.device(device))
    model.load_state_dict(umt5_params_from_numpy(convert_umt5_state_dict(sd, cfg), cfg,
                                                 device))
    return cfg, model
