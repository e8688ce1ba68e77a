"""Published DiT checkpoints into the port's models.

The counterparts of ``magcache_tpu.models.convert``'s converters and
loaders. Each ``convert_<family>_state_dict(sd, cfg)`` maps a published state
dict (torch tensors, e.g. from ``checkpoint.load_safetensors_dir``) onto the
JAX package's parameter tree for ``cfg``, its leaves torch views in the JAX
dtypes (depth-stacked leaves as per-block lists);
``load_<family>_checkpoint(path, cfg, device=)`` reads the files and lays
that tree out as the port model's state dict through ``models/convert.py``'s
``*_params_from_numpy``, its tensors on ``device`` (default: the CPU, the
file's pages mapped). A missing key raises ``KeyError``;
``load_state_dict`` then checks every name and shape.

Key layouts (published naming):

- Wan2.1 / 2.2: ``patch_embedding`` (conv3d ``[d, C, 1, 2, 2]``, flattened in
  ``(c, pt, ph, pw)`` order), ``text_embedding.{0,2}``, ``time_embedding.{0,2}``,
  ``time_projection.1``, ``blocks.N.{self_attn,cross_attn}.{q,k,v,o,norm_q,
  norm_k}``, ``blocks.N.{norm3,ffn.0,ffn.2,modulation [1, 6, d]}``, i2v's
  ``cross_attn.{k_img,v_img,norm_k_img}`` and ``img_emb.proj.{1,3}``,
  ``head.head``, ``head.modulation [1, 2, d]``;
- FLUX: black-forest-labs naming (``double_blocks.N.img_attn.qkv``,
  ``single_blocks.N.linear1``, ``final_layer.adaLN_modulation.1``);
- HunyuanVideo: hyvideo naming (``img_in.proj``, ``txt_in.*`` refiner,
  ``double_blocks.N.img_attn_qkv``), an optional ``model.`` / ``module.``
  prefix stripped;
- Qwen-Image, CogVideoX, Latte, Open-Sora-Plan, Vchitect-XL, OmniGen2:
  diffusers naming (``transformer_blocks.N.attn.to_q`` ...); STDiT3: the
  Open-Sora 1.2 naming (``spatial_blocks.N.attn.qkv`` ...).

``load_flux_checkpoint`` and ``load_omnigen2_checkpoint`` take ``lora_path``
and merge an adapter into the published names before conversion
(``models/lora.py``). OmniGen2's configuration comes from the tensors and
``config.json`` (``sniff_omnigen2_config``, ``omnigen2_config_from_json``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, Optional, Tuple

import torch

from magcache_tpu_torch.models import convert
from magcache_tpu_torch.models.checkpoint import (cat_lin, conv_as_linear, lin,
                                                  load_safetensors_dir, stack, vec)
from magcache_tpu_torch.models.cogvideox import CogVideoXConfig
from magcache_tpu_torch.models.flux import FluxConfig
from magcache_tpu_torch.models.hunyuan import HunyuanConfig
from magcache_tpu_torch.models.latte import LatteConfig
from magcache_tpu_torch.models.omnigen2 import OmniGen2Config
from magcache_tpu_torch.models.open_sora_plan import OpenSoraPlanConfig
from magcache_tpu_torch.models.qwen_image import QwenImageConfig
from magcache_tpu_torch.models.stdit3 import STDiT3Config
from magcache_tpu_torch.models.vchitect import VchitectConfig
from magcache_tpu_torch.models.wan import WanConfig

Sd = Dict[str, torch.Tensor]
F32 = torch.float32


def _rows(sd: Sd, key: str, rows: int) -> torch.Tensor:
    """A modulation table ``[1, rows, d]`` as ``[rows, d]`` f32."""
    return vec(sd, key).reshape(rows, -1)


def _lora(sd: Sd, lora_path: Optional[str], lora_scale: float, device) -> Sd:
    """``sd`` with the adapter at ``lora_path`` merged on ``device``."""
    if not lora_path:
        return sd
    from magcache_tpu_torch.models.lora import load_lora_file, merge_lora_state_dict

    sd, n = merge_lora_state_dict(sd, load_lora_file(lora_path), scale=lora_scale,
                                  device=device)
    print(f"merged LoRA adapter {lora_path} into {n} layers")
    return sd


# ---- Wan --------------------------------------------------------------------

def convert_wan_state_dict(sd: Sd, cfg: WanConfig) -> dict:
    """A Wan2.1 / 2.2 DiT state dict (t2v, or i2v with the CLIP branch) as
    the JAX Wan tree. The VACE blocks are not converted (nor in JAX)."""
    if cfg.vace_layers:
        raise NotImplementedError("the published VACE layout is not converted (nor in "
                                  "the JAX package)")
    dt, L = cfg.torch_dtype, cfg.layers

    def blocks(name, dtype):
        return stack([lin(sd, f"blocks.{i}.{name}", dtype) for i in range(L)])

    def gains(name):
        return [vec(sd, f"blocks.{i}.{name}") for i in range(L)]

    tree = {
        "patch_embedding": conv_as_linear(sd, "patch_embedding", dt),
        "text_embedding": {"in": lin(sd, "text_embedding.0", F32),
                           "out": lin(sd, "text_embedding.2", F32)},
        "time_embedding": {"in": lin(sd, "time_embedding.0", F32),
                           "out": lin(sd, "time_embedding.2", F32)},
        "time_projection": lin(sd, "time_projection.1", F32),
        "head": {"modulation": _rows(sd, "head.modulation", 2),
                 "out": lin(sd, "head.head", dt)},
    }
    b = {"modulation": [_rows(sd, f"blocks.{i}.modulation", 6) for i in range(L)],
         "norm3_w": gains("norm3.weight"), "norm3_b": gains("norm3.bias")}
    for ours, theirs in (("q", "self_attn.q"), ("k", "self_attn.k"), ("v", "self_attn.v"),
                         ("o", "self_attn.o"), ("cross_q", "cross_attn.q"),
                         ("cross_k", "cross_attn.k"), ("cross_v", "cross_attn.v"),
                         ("cross_o", "cross_attn.o"), ("ffn1", "ffn.0"), ("ffn2", "ffn.2")):
        b[ours] = blocks(theirs, dt)
    for ours, theirs in (("norm_q", "self_attn.norm_q"), ("norm_k", "self_attn.norm_k"),
                         ("cross_norm_q", "cross_attn.norm_q"),
                         ("cross_norm_k", "cross_attn.norm_k")):
        b[ours] = gains(f"{theirs}.weight")
    if cfg.has_clip:
        b["cross_k_img"] = blocks("cross_attn.k_img", dt)
        b["cross_v_img"] = blocks("cross_attn.v_img", dt)
        b["cross_norm_k_img"] = gains("cross_attn.norm_k_img.weight")
        tree["img_emb"] = {"in": lin(sd, "img_emb.proj.1", F32),
                           "out": lin(sd, "img_emb.proj.3", F32)}
    tree["blocks"] = b
    return tree


def load_wan_checkpoint(ckpt_dir: str, cfg: WanConfig, device=None) -> Sd:
    """``WanModel(cfg)``'s state dict from a Wan ``ckpt_dir`` (the DiT's
    ``*.safetensors``, sharded or not, beside the encoder's and VAE's
    ``.pth`` files, which are skipped)."""
    tree = convert_wan_state_dict(load_safetensors_dir(ckpt_dir), cfg)
    return convert.wan_params_from_numpy(tree, cfg, device)


# ---- FLUX --------------------------------------------------------------------

def convert_flux_state_dict(sd: Sd, cfg: FluxConfig) -> dict:
    """A black-forest-labs FLUX state dict as the JAX FLUX tree."""
    dt, L2, L1 = cfg.torch_dtype, cfg.depth_double, cfg.depth_single

    def mlp(name):
        return {"in": lin(sd, f"{name}.in_layer", F32), "out": lin(sd, f"{name}.out_layer", F32)}

    def qk(prefix):
        return torch.stack([vec(sd, f"{prefix}.norm.query_norm.scale"),
                            vec(sd, f"{prefix}.norm.key_norm.scale")])

    tree = {"img_in": lin(sd, "img_in", dt), "txt_in": lin(sd, "txt_in", dt),
            "time_in": mlp("time_in"), "vector_in": mlp("vector_in"),
            "final_mod": lin(sd, "final_layer.adaLN_modulation.1", F32),
            "final_out": lin(sd, "final_layer.linear", dt)}
    if cfg.guidance_embed and "guidance_in.in_layer.weight" in sd:
        tree["guidance_in"] = mlp("guidance_in")

    def dbl(name, dtype):
        return stack([lin(sd, f"double_blocks.{i}.{name}", dtype) for i in range(L2)])

    tree["double"] = {
        "img_mod": dbl("img_mod.lin", F32), "txt_mod": dbl("txt_mod.lin", F32),
        "img_qkv": dbl("img_attn.qkv", dt), "txt_qkv": dbl("txt_attn.qkv", dt),
        "img_qk_scale": [qk(f"double_blocks.{i}.img_attn") for i in range(L2)],
        "txt_qk_scale": [qk(f"double_blocks.{i}.txt_attn") for i in range(L2)],
        "img_proj": dbl("img_attn.proj", dt), "txt_proj": dbl("txt_attn.proj", dt),
        "img_mlp1": dbl("img_mlp.0", dt), "img_mlp2": dbl("img_mlp.2", dt),
        "txt_mlp1": dbl("txt_mlp.0", dt), "txt_mlp2": dbl("txt_mlp.2", dt)}

    def sgl(name, dtype):
        return stack([lin(sd, f"single_blocks.{i}.{name}", dtype) for i in range(L1)])

    tree["single"] = {"mod": sgl("modulation.lin", F32), "lin1": sgl("linear1", dt),
                      "lin2": sgl("linear2", dt),
                      "qk_scale": [qk(f"single_blocks.{i}") for i in range(L1)]}
    return tree


def load_flux_checkpoint(ckpt_dir: str, cfg: FluxConfig, device=None,
                         lora_path: Optional[str] = None, lora_scale: float = 1.0) -> Sd:
    """``FluxModel(cfg)``'s state dict from a FLUX checkpoint, with a LoRA
    adapter merged on ``device`` first when ``lora_path`` is given (the
    merge-once translation of the reference's runtime ``lora_scale``)."""
    sd = _lora(load_safetensors_dir(ckpt_dir), lora_path, lora_scale, device)
    return convert.flux_params_from_numpy(convert_flux_state_dict(sd, cfg), cfg, device)


# ---- HunyuanVideo -------------------------------------------------------------

def convert_hunyuan_state_dict(sd: Sd, cfg: HunyuanConfig) -> dict:
    """A hyvideo HunyuanVideo transformer state dict as the JAX Hunyuan tree
    (``txt_in`` the identity: the refiner's output feeds the trunk). The
    FramePack clean-latent projections are not in this layout."""
    if cfg.framepack:
        raise NotImplementedError("the published FramePack layout (its clean-latent "
                                  "projections) is not converted (nor in the JAX package)")
    dt, d = cfg.torch_dtype, cfg.hidden
    L2, L1, LR = cfg.depth_double, cfg.depth_single, cfg.refiner_depth
    for pre in ("model.", "module."):
        if any(k.startswith(pre) for k in sd):
            sd = {k[len(pre):] if k.startswith(pre) else k: v for k, v in sd.items()}

    def group(fmt, n, dtype):
        return stack([lin(sd, fmt.format(i), dtype) for i in range(n)])

    def qk(prefix):
        return torch.stack([vec(sd, f"{prefix}_q_norm.weight"),
                            vec(sd, f"{prefix}_k_norm.weight")])

    r = "txt_in.individual_token_refiner.blocks.{}."
    tree = {
        "img_in": conv_as_linear(sd, "img_in.proj", dt),
        "txt_in": {"w": torch.eye(d, dtype=dt), "b": torch.zeros((d,), dtype=dt)},
        "time_in": {"in": lin(sd, "time_in.mlp.0", F32), "out": lin(sd, "time_in.mlp.2", F32)},
        "vector_in": {"in": lin(sd, "vector_in.in_layer", F32),
                      "out": lin(sd, "vector_in.out_layer", F32)},
        "final_mod": lin(sd, "final_layer.adaLN_modulation.1", F32),
        "final_out": lin(sd, "final_layer.linear", dt),
        "refiner": {
            "in": lin(sd, "txt_in.input_embedder", F32),
            "t_embed": {"in": lin(sd, "txt_in.t_embedder.mlp.0", F32),
                        "out": lin(sd, "txt_in.t_embedder.mlp.2", F32)},
            "c_embed": {"in": lin(sd, "txt_in.c_embedder.linear_1", F32),
                        "out": lin(sd, "txt_in.c_embedder.linear_2", F32)},
            "blocks": {
                "qkv": group(r + "self_attn_qkv", LR, dt),
                "proj": group(r + "self_attn_proj", LR, dt),
                "mlp1": group(r + "mlp.fc1", LR, dt), "mlp2": group(r + "mlp.fc2", LR, dt),
                "mod": group(r + "adaLN_modulation.1", LR, F32),
                **{f"{n}_{p[0]}": [vec(sd, (r + f"{n}.{p}").format(i)) for i in range(LR)]
                   for n in ("norm1", "norm2") for p in ("weight", "bias")},
            },
        },
        "double": {
            "img_mod": group("double_blocks.{}.img_mod.linear", L2, F32),
            "txt_mod": group("double_blocks.{}.txt_mod.linear", L2, F32),
            "img_qkv": group("double_blocks.{}.img_attn_qkv", L2, dt),
            "txt_qkv": group("double_blocks.{}.txt_attn_qkv", L2, dt),
            "img_qk_scale": [qk(f"double_blocks.{i}.img_attn") for i in range(L2)],
            "txt_qk_scale": [qk(f"double_blocks.{i}.txt_attn") for i in range(L2)],
            "img_proj": group("double_blocks.{}.img_attn_proj", L2, dt),
            "txt_proj": group("double_blocks.{}.txt_attn_proj", L2, dt),
            "img_mlp1": group("double_blocks.{}.img_mlp.fc1", L2, dt),
            "img_mlp2": group("double_blocks.{}.img_mlp.fc2", L2, dt),
            "txt_mlp1": group("double_blocks.{}.txt_mlp.fc1", L2, dt),
            "txt_mlp2": group("double_blocks.{}.txt_mlp.fc2", L2, dt),
        },
        "single": {
            "mod": group("single_blocks.{}.modulation.linear", L1, F32),
            "lin1": group("single_blocks.{}.linear1", L1, dt),
            "lin2": group("single_blocks.{}.linear2", L1, dt),
            "qk_scale": [torch.stack([vec(sd, f"single_blocks.{i}.q_norm.weight"),
                                      vec(sd, f"single_blocks.{i}.k_norm.weight")])
                         for i in range(L1)],
        },
    }
    if cfg.guidance_embed and "guidance_in.mlp.0.weight" in sd:
        tree["guidance_in"] = {"in": lin(sd, "guidance_in.mlp.0", F32),
                               "out": lin(sd, "guidance_in.mlp.2", F32)}
    return tree


def load_hunyuan_checkpoint(ckpt_dir: str, cfg: HunyuanConfig, device=None) -> Sd:
    """``HunyuanModel(cfg)``'s state dict from a HunyuanVideo checkpoint
    (``mp_rank_00_model_states.pt``'s ``module`` unwrapped)."""
    tree = convert_hunyuan_state_dict(load_safetensors_dir(ckpt_dir), cfg)
    return convert.hunyuan_params_from_numpy(tree, cfg, device)


# ---- Qwen-Image ----------------------------------------------------------------

def convert_qwen_image_state_dict(sd: Sd, cfg: QwenImageConfig) -> dict:
    """A diffusers Qwen-Image transformer state dict as the JAX Qwen-Image
    tree (the FLUX tree with ``txt_norm`` and no single blocks)."""
    f = cfg.to_flux()
    dt, d, L = f.torch_dtype, f.hidden, f.depth_double

    def blk(i, name, dtype):
        return lin(sd, f"transformer_blocks.{i}.{name}", dtype)

    def group(name, dtype):
        return stack([blk(i, name, dtype) for i in range(L)])

    def qkv(names):
        return stack([cat_lin(sd, [f"transformer_blocks.{i}.attn.{n}" for n in names], dt)
                      for i in range(L)])

    def qk(qn, kn):
        return [torch.stack([vec(sd, f"transformer_blocks.{i}.attn.{qn}.weight"),
                             vec(sd, f"transformer_blocks.{i}.attn.{kn}.weight")])
                for i in range(L)]

    zeros = lambda *s, dtype=dt: torch.zeros(s, dtype=dtype)   # noqa: E731
    return {
        "txt_norm": vec(sd, "txt_norm.weight"),
        "img_in": lin(sd, "img_in", dt), "txt_in": lin(sd, "txt_in", dt),
        "time_in": {"in": lin(sd, "time_text_embed.timestep_embedder.linear_1", F32),
                    "out": lin(sd, "time_text_embed.timestep_embedder.linear_2", F32)},
        "vector_in": {"in": {"w": zeros(f.vec_dim, d, dtype=F32), "b": zeros(d, dtype=F32)},
                      "out": {"w": zeros(d, d, dtype=F32), "b": zeros(d, dtype=F32)}},
        "final_mod": lin(sd, "norm_out.linear", F32),
        "final_out": lin(sd, "proj_out", dt),
        "double": {
            "img_mod": group("img_mod.1", F32), "txt_mod": group("txt_mod.1", F32),
            "img_qkv": qkv(["to_q", "to_k", "to_v"]),
            "txt_qkv": qkv(["add_q_proj", "add_k_proj", "add_v_proj"]),
            "img_qk_scale": qk("norm_q", "norm_k"),
            "txt_qk_scale": qk("norm_added_q", "norm_added_k"),
            "img_proj": group("attn.to_out.0", dt), "txt_proj": group("attn.to_add_out", dt),
            "img_mlp1": group("img_mlp.net.0.proj", dt), "img_mlp2": group("img_mlp.net.2", dt),
            "txt_mlp1": group("txt_mlp.net.0.proj", dt), "txt_mlp2": group("txt_mlp.net.2", dt),
        },
        "single": {},                    # depth_single 0
    }


def load_qwen_image_checkpoint(ckpt_dir: str, cfg: QwenImageConfig, device=None) -> Sd:
    """``QwenImageModel(cfg)``'s state dict from a Qwen-Image checkpoint."""
    tree = convert_qwen_image_state_dict(load_safetensors_dir(ckpt_dir), cfg)
    return convert.qwen_image_params_from_numpy(tree, cfg, device)


# ---- CogVideoX -------------------------------------------------------------------

def convert_cogvideox_state_dict(sd: Sd, cfg: CogVideoXConfig) -> dict:
    """A diffusers CogVideoX transformer state dict as the JAX CogVideoX tree."""
    dt, L = cfg.torch_dtype, cfg.layers
    tb = "transformer_blocks.{}."

    def group(name, dtype=dt):
        return stack([lin(sd, (tb + name).format(i), dtype) for i in range(L)])

    def gains(name):
        return [vec(sd, (tb + name).format(i)) for i in range(L)]

    return {
        "patch_embed": conv_as_linear(sd, "patch_embed.proj", dt),
        "text_proj": lin(sd, "patch_embed.text_proj", dt),
        "time": {"in": lin(sd, "time_embedding.linear_1", F32),
                 "out": lin(sd, "time_embedding.linear_2", F32)},
        "blocks": {
            "mod1": group("norm1.linear"), "mod2": group("norm2.linear"),
            "ln1_w": gains("norm1.norm.weight"), "ln1_b": gains("norm1.norm.bias"),
            "ln2_w": gains("norm2.norm.weight"), "ln2_b": gains("norm2.norm.bias"),
            "qkv": stack([cat_lin(sd, [f"transformer_blocks.{i}.attn1.to_{n}" for n in "qkv"],
                                  dt) for i in range(L)]),
            "q_norm_w": gains("attn1.norm_q.weight"), "q_norm_b": gains("attn1.norm_q.bias"),
            "k_norm_w": gains("attn1.norm_k.weight"), "k_norm_b": gains("attn1.norm_k.bias"),
            "proj": group("attn1.to_out.0"), "ff1": group("ff.net.0.proj"),
            "ff2": group("ff.net.2"),
        },
        "norm_final_w": vec(sd, "norm_final.weight"), "norm_final_b": vec(sd, "norm_final.bias"),
        "norm_out_w": vec(sd, "norm_out.norm.weight"), "norm_out_b": vec(sd, "norm_out.norm.bias"),
        "final_mod": lin(sd, "norm_out.linear", F32),
        "final_out": lin(sd, "proj_out", dt),
    }


def load_cogvideox_checkpoint(ckpt_dir: str, cfg: CogVideoXConfig, device=None) -> Sd:
    """``CogVideoXModel(cfg)``'s state dict from a CogVideoX checkpoint."""
    tree = convert_cogvideox_state_dict(load_safetensors_dir(ckpt_dir), cfg)
    return convert.cogvideox_params_from_numpy(tree, cfg, device)


# ---- STDiT3 (Open-Sora 1.2) ---------------------------------------------------------

def convert_stdit3_state_dict(sd: Sd, cfg: STDiT3Config) -> dict:
    """An Open-Sora 1.2 STDiT3 state dict as the JAX STDiT3 tree."""
    dt, L = cfg.torch_dtype, cfg.depth

    def group(prefix):
        def g(name, dtype=dt):
            return stack([lin(sd, f"{prefix}.{i}.{name}", dtype) for i in range(L)])

        out = {"scale_shift": [vec(sd, f"{prefix}.{i}.scale_shift_table") for i in range(L)],
               "qkv": g("attn.qkv"), "proj": g("attn.proj"),
               "cross_q": g("cross_attn.q_linear"), "cross_kv": g("cross_attn.kv_linear"),
               "cross_o": g("cross_attn.proj"), "mlp1": g("mlp.fc1"), "mlp2": g("mlp.fc2")}
        if cfg.qk_norm:
            for n in ("q_norm", "k_norm"):
                out[n] = [vec(sd, f"{prefix}.{i}.attn.{n}.weight") for i in range(L)]
        return out

    return {
        "y_null": vec(sd, "y_embedder.y_embedding"),
        "patch_embed": conv_as_linear(sd, "x_embedder.proj", F32),
        "t_embed": {"in": lin(sd, "t_embedder.mlp.0", F32),
                    "out": lin(sd, "t_embedder.mlp.2", F32)},
        "fps_embed": {"in": lin(sd, "fps_embedder.mlp.0", F32),
                      "out": lin(sd, "fps_embedder.mlp.2", F32)},
        "t_block": lin(sd, "t_block.1", F32),
        "y_embed": {"in": lin(sd, "y_embedder.y_proj.fc1", F32),
                    "out": lin(sd, "y_embedder.y_proj.fc2", F32)},
        "spatial": group("spatial_blocks"), "temporal": group("temporal_blocks"),
        "final": {"scale_shift": vec(sd, "final_layer.scale_shift_table"),
                  "out": lin(sd, "final_layer.linear", F32)},
    }


def load_stdit3_checkpoint(ckpt_dir: str, cfg: STDiT3Config, device=None) -> Sd:
    """``STDiT3Model(cfg)``'s state dict from an Open-Sora 1.2 checkpoint."""
    tree = convert_stdit3_state_dict(load_safetensors_dir(ckpt_dir), cfg)
    return convert.stdit3_params_from_numpy(tree, cfg, device)


# ---- Latte, Open-Sora-Plan, Vchitect-XL -----------------------------------------------

def _pixart_embedders(sd: Sd) -> dict:
    return {"caption": {"in": lin(sd, "caption_projection.linear_1", F32),
                        "out": lin(sd, "caption_projection.linear_2", F32)},
            "time": {"in": lin(sd, "adaln_single.emb.timestep_embedder.linear_1", F32),
                     "out": lin(sd, "adaln_single.emb.timestep_embedder.linear_2", F32)},
            "adaln_single": lin(sd, "adaln_single.linear", F32),
            "final_mod": vec(sd, "scale_shift_table"),
            "final_out": lin(sd, "proj_out", F32)}


def convert_latte_state_dict(sd: Sd, cfg) -> dict:
    """A Latte-1 transformer state dict (also Open-Sora-Plan v1.1's) as the
    JAX Latte tree."""
    dt, L = cfg.torch_dtype, cfg.depth

    def group(prefix, cross):
        def g(name):
            return stack([lin(sd, f"{prefix}.{i}.{name}", dt) for i in range(L)])

        def cat(names):
            return stack([cat_lin(sd, [f"{prefix}.{i}.{n}" for n in names], dt)
                          for i in range(L)])

        out = {"scale_shift": [vec(sd, f"{prefix}.{i}.scale_shift_table") for i in range(L)],
               "qkv": cat(["attn1.to_q", "attn1.to_k", "attn1.to_v"]),
               "proj": g("attn1.to_out.0"), "ff1": g("ff.net.0.proj"), "ff2": g("ff.net.2")}
        if cross:
            out.update(cross_q=g("attn2.to_q"), cross_kv=cat(["attn2.to_k", "attn2.to_v"]),
                       cross_o=g("attn2.to_out.0"))
        return out

    return {"patch_embed": conv_as_linear(sd, "pos_embed.proj", dt), **_pixart_embedders(sd),
            "temp_pos": None, "spatial": group("transformer_blocks", True),
            "temporal": group("temporal_transformer_blocks", False)}


def load_latte_checkpoint(ckpt_dir: str, cfg: LatteConfig, device=None) -> Sd:
    """``LatteModel(cfg)``'s state dict from a Latte-1 ``transformer/`` dir."""
    tree = convert_latte_state_dict(load_safetensors_dir(ckpt_dir), cfg)
    return convert.latte_params_from_numpy(tree, cfg, device)


def convert_osp_state_dict(sd: Sd, cfg: OpenSoraPlanConfig) -> dict:
    """An Open-Sora-Plan v1.2 ``OpenSoraT2V`` state dict as the JAX OSP tree
    (a conv2d or conv3d patch embedding)."""
    dt, L = cfg.torch_dtype, cfg.depth
    b = "transformer_blocks.{}."

    def g(name):
        return stack([lin(sd, (b + name).format(i), dt) for i in range(L)])

    def cat(names):
        return stack([cat_lin(sd, [(b + n).format(i) for n in names], dt) for i in range(L)])

    return {"patch_embed": conv_as_linear(sd, "pos_embed.proj", dt), **_pixart_embedders(sd),
            "blocks": {"scale_shift": [vec(sd, (b + "scale_shift_table").format(i))
                                       for i in range(L)],
                       "qkv": cat(["attn1.to_q", "attn1.to_k", "attn1.to_v"]),
                       "proj": g("attn1.to_out.0"), "cross_q": g("attn2.to_q"),
                       "cross_kv": cat(["attn2.to_k", "attn2.to_v"]),
                       "cross_o": g("attn2.to_out.0"), "ff1": g("ff.net.0.proj"),
                       "ff2": g("ff.net.2")}}


def load_osp_checkpoint(ckpt_dir: str, cfg: OpenSoraPlanConfig, device=None) -> Sd:
    """``OSPModel(cfg)``'s state dict from an Open-Sora-Plan v1.2 checkpoint."""
    tree = convert_osp_state_dict(load_safetensors_dir(ckpt_dir), cfg)
    return convert.osp_params_from_numpy(tree, cfg, device)


_VCHITECT_ATTN = {"q": "to_q", "k": "to_k", "v": "to_v", "o": "to_out.0", "qt": "to_q_temp",
                  "kt": "to_k_temp", "vt": "to_v_temp", "ot": "to_out_temporal",
                  "qc": "to_q_cross", "oc": "to_out_context", "add_q": "add_q_proj",
                  "add_k": "add_k_proj", "add_v": "add_v_proj"}


def convert_vchitect_state_dict(sd: Sd, cfg: VchitectConfig) -> dict:
    """A Vchitect-XL state dict as the JAX Vchitect tree: blocks ``0..L-2``
    stacked, the context-pre-only last block apart. The sincos
    ``pos_embed.pos_embed`` buffer and the last block's
    ``to_add_out_temporal`` are not loaded (as in JAX)."""
    dt, L = cfg.torch_dtype, cfg.depth

    def block(i, pre_only):
        b = f"transformer_blocks.{i}"
        out = {"mod_x": lin(sd, f"{b}.norm1.linear", dt)}
        out.update({ours: lin(sd, f"{b}.attn.{theirs}", dt)
                    for ours, theirs in _VCHITECT_ATTN.items()})
        out["ff1"] = lin(sd, f"{b}.ff.net.0.proj", dt)
        out["ff2"] = lin(sd, f"{b}.ff.net.2", dt)
        if pre_only:
            out["mod_c2"] = lin(sd, f"{b}.norm1_context.linear", dt)
        else:
            out.update(mod_c=lin(sd, f"{b}.norm1_context.linear", dt),
                       add_out=lin(sd, f"{b}.attn.to_add_out", dt),
                       add_out_t=lin(sd, f"{b}.attn.to_add_out_temporal", dt),
                       ffc1=lin(sd, f"{b}.ff_context.net.0.proj", dt),
                       ffc2=lin(sd, f"{b}.ff_context.net.2", dt))
        return out

    te = "time_text_embed"
    return {"patch_embed": conv_as_linear(sd, "pos_embed.proj", dt),
            "context_in": lin(sd, "context_embedder", dt),
            "time_in": {"in": lin(sd, f"{te}.timestep_embedder.linear_1", F32),
                        "out": lin(sd, f"{te}.timestep_embedder.linear_2", F32)},
            "pooled_in": {"in": lin(sd, f"{te}.text_embedder.linear_1", F32),
                          "out": lin(sd, f"{te}.text_embedder.linear_2", F32)},
            "blocks": stack([block(i, False) for i in range(L - 1)]),
            "last": block(L - 1, True),
            "norm_out_mod": lin(sd, "norm_out.linear", F32),
            "proj_out": lin(sd, "proj_out", F32)}


def load_vchitect_checkpoint(ckpt_dir: str, cfg: VchitectConfig, device=None) -> Sd:
    """``VchitectModel(cfg)``'s state dict from a Vchitect-XL checkpoint."""
    tree = convert_vchitect_state_dict(load_safetensors_dir(ckpt_dir), cfg)
    return convert.vchitect_params_from_numpy(tree, cfg, device)


# ---- OmniGen2 ---------------------------------------------------------------------

def convert_omnigen2_state_dict(sd: Sd, cfg: OmniGen2Config) -> dict:
    """An OmniGen2 transformer state dict (Lumina2 lineage) as the JAX
    OmniGen2 tree: ``to_k``/``to_v`` fused into the GQA ``kv``; a modulated
    block's missing ``norm1.linear`` bias zero-filled."""
    dt = cfg.torch_dtype

    def group(prefix, depth, modulated):
        def one(i):
            b = f"{prefix}.{i}"
            p = {"q": lin(sd, f"{b}.attn.to_q", dt),
                 "kv": cat_lin(sd, [f"{b}.attn.to_k", f"{b}.attn.to_v"], dt),
                 "o": lin(sd, f"{b}.attn.to_out.0", dt),
                 "q_norm": vec(sd, f"{b}.attn.norm_q.weight"),
                 "k_norm": vec(sd, f"{b}.attn.norm_k.weight"),
                 "norm2": vec(sd, f"{b}.norm2.weight"),
                 "ffn_norm1": vec(sd, f"{b}.ffn_norm1.weight"),
                 "ffn_norm2": vec(sd, f"{b}.ffn_norm2.weight"),
                 "w1": lin(sd, f"{b}.feed_forward.linear_1", dt),
                 "w3": lin(sd, f"{b}.feed_forward.linear_3", dt),
                 "w2": lin(sd, f"{b}.feed_forward.linear_2", dt)}
            if modulated:
                p["mod"] = lin(sd, f"{b}.norm1.linear", F32)
                p["mod"].setdefault("b", torch.zeros(4 * cfg.hidden, dtype=F32))
                p["norm1"] = vec(sd, f"{b}.norm1.norm.weight")
            else:
                p["norm1"] = vec(sd, f"{b}.norm1.weight")
            return p

        return stack([one(i) for i in range(depth)])

    tc = "time_caption_embed"
    return {"t_embed": {"in": lin(sd, f"{tc}.timestep_embedder.linear_1", F32),
                        "out": lin(sd, f"{tc}.timestep_embedder.linear_2", F32)},
            "cap_norm": vec(sd, f"{tc}.caption_embedder.0.weight"),
            "cap_proj": lin(sd, f"{tc}.caption_embedder.1", F32),
            "x_embed": lin(sd, "x_embedder", dt),
            "ref_embed": lin(sd, "ref_image_patch_embedder", dt),
            "context_refiner": group("context_refiner", cfg.refiner_layers, False),
            "noise_refiner": group("noise_refiner", cfg.refiner_layers, True),
            "ref_refiner": group("ref_image_refiner", cfg.refiner_layers, True),
            "layers": group("layers", cfg.layers, True),
            "norm_out_mod": lin(sd, "norm_out.linear_1", F32),
            "final_out": lin(sd, "norm_out.linear_2", F32)}


def sniff_omnigen2_config(sd: Sd, *, patch: int = 2, dtype: str = "float32") -> OmniGen2Config:
    """The structural ``OmniGen2Config`` fields from the checkpoint's shapes:
    widths from the embedders, depths from the largest ``layers.N`` and
    ``noise_refiner.N``, head geometry from ``norm_q`` and ``to_q``/``to_k``,
    the SwiGLU width from ``feed_forward.linear_1``. ``patch`` comes from
    ``config.json`` (``x_embedder`` folds ``in_channels * patch^2``)."""
    def shape(k):
        if k not in sd:
            raise KeyError(f"checkpoint has no {k!r}")
        return tuple(sd[k].shape)

    hidden, pin = shape("x_embedder.weight")
    head_dim = shape("layers.0.attn.norm_q.weight")[0]
    heads = shape("layers.0.attn.to_q.weight")[0] // head_dim
    kv_heads = shape("layers.0.attn.to_k.weight")[0] // head_dim
    if heads * head_dim != hidden:
        raise ValueError(f"{heads} heads of {head_dim} do not make the width {hidden}")

    def depth(prefix):
        pat = re.compile(rf"{prefix}\.(\d+)\.")
        idxs = [int(m.group(1)) for k in sd for m in [pat.match(k)] if m]
        return max(idxs) + 1 if idxs else 0

    temb_dim, time_embed_dim = shape("time_caption_embed.timestep_embedder.linear_1.weight")
    d3 = head_dim // 3
    return OmniGen2Config(
        hidden=hidden, heads=heads, kv_heads=kv_heads, layers=depth("layers"),
        refiner_layers=depth("noise_refiner"), in_channels=pin // (patch * patch),
        patch=patch, text_dim=shape("time_caption_embed.caption_embedder.1.weight")[1],
        time_embed_dim=time_embed_dim, temb_dim=temb_dim,
        axes_dims=(head_dim - 2 * d3, d3, d3),
        ffn_dim_override=shape("layers.0.feed_forward.linear_1.weight")[0], dtype=dtype)


def omnigen2_config_from_json(d: dict, dtype: str = "float32") -> OmniGen2Config:
    """``OmniGen2Config`` from a diffusers-style transformer ``config.json``
    (the Lumina2 lineage's key-name variants accepted)."""
    def pick(*names, default=None):
        for n in names:
            if d.get(n) is not None:
                return d[n]
        return default

    base = OmniGen2Config()
    kw = dict(
        hidden=pick("hidden_size", "dim", default=base.hidden),
        heads=pick("num_attention_heads", "n_heads", default=base.heads),
        kv_heads=pick("num_kv_heads", "n_kv_heads", default=base.kv_heads),
        layers=pick("num_layers", "n_layers", "num_hidden_layers", default=base.layers),
        refiner_layers=pick("num_refiner_layers", default=base.refiner_layers),
        in_channels=pick("in_channels", default=base.in_channels),
        patch=pick("patch_size", default=base.patch),
        text_dim=pick("text_feat_dim", "cap_feat_dim", default=base.text_dim),
        axes_dims=tuple(pick("axes_dim_rope", "axes_dims_rope", "axes_dims",
                             default=list(base.axes_dims))),
        eps=pick("norm_eps", default=base.eps), dtype=dtype)
    mult = pick("ffn_dim_multiplier")
    if mult:
        kw["ffn_mult"] = mult
    return OmniGen2Config(**kw)


def omnigen2_checkpoint_config(ckpt_dir: str, sd: Sd, dtype: str = "float32") -> OmniGen2Config:
    """The configuration of an OmniGen2 checkpoint directory: ``config.json``
    (when present) gives the patch, rope axes and eps; the tensors' shapes
    give every structural field."""
    jpath = os.path.join(ckpt_dir, "config.json") if os.path.isdir(ckpt_dir) else ""
    patch, axes, eps = 2, None, None
    if jpath and os.path.exists(jpath):
        with open(jpath) as f:
            jcfg = omnigen2_config_from_json(json.load(f), dtype=dtype)
        patch, axes, eps = jcfg.patch, jcfg.axes_dims, jcfg.eps
    cfg = sniff_omnigen2_config(sd, patch=patch, dtype=dtype)
    if axes is not None:
        cfg = dataclasses.replace(cfg, axes_dims=tuple(axes), eps=eps)
    return cfg


def load_omnigen2_checkpoint(ckpt_dir: str, cfg: Optional[OmniGen2Config] = None,
                             dtype: str = "float32", device=None,
                             lora_path: Optional[str] = None, lora_scale: float = 1.0
                             ) -> Tuple[Sd, OmniGen2Config]:
    """``(OmniGen2Model state dict, config)`` from an OmniGen2 transformer
    directory; with ``cfg=None`` the configuration is read from it
    (``omnigen2_checkpoint_config``). ``lora_path`` merges an adapter into
    the published weights first, on ``device`` (the reference's
    ``--transformer_lora_path``)."""
    sd = _lora(load_safetensors_dir(ckpt_dir), lora_path, lora_scale, device)
    if cfg is None:
        cfg = omnigen2_checkpoint_config(ckpt_dir, sd, dtype)
    tree = convert_omnigen2_state_dict(sd, cfg)
    return convert.omnigen2_params_from_numpy(tree, cfg, device), cfg
