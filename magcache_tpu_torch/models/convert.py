"""Parameter conversion into the port's modules.

``wan_params_from_numpy``, ``stdit3_params_from_numpy``,
``flux_params_from_numpy``, ``latte_params_from_numpy``,
``osp_params_from_numpy`` and ``cogvideox_params_from_numpy`` turn the JAX
package's Wan, STDiT3, FLUX, Latte, Open-Sora-Plan v1.2 and CogVideoX
parameter pytrees, with their leaves as numpy arrays, into ``WanModel``,
``STDiT3Model``, ``FluxModel``, ``LatteModel``, ``OSPModel`` and
``CogVideoXModel`` state dicts; ``vchitect_params_from_numpy`` does the
same for Vchitect-XL, and ``umt5_params_from_numpy``,
``osp_vae_params_from_numpy`` and ``cogvideox_vae_params_from_numpy`` for
the UMT5 encoder and the Open-Sora-Plan and CogVideoX VAEs' decoders, and
``wan_vae_params_from_numpy``, ``sd_vae_params_from_numpy`` and
``vae_temporal_params_from_numpy`` for the Wan VAE, the SD VAE and
Open-Sora's temporal VAE, encoder and decoder, and
``causal_vae_params_from_numpy`` for the causal VAE's encoder (Wan i2v's
fallback); ``t5_params_from_flax`` for a T5 or mT5 encoder from the HF Flax
tree the JAX package's ``JaxT5Encoder`` runs, and
``clip_text_params_from_numpy`` and ``clip_vision_params_from_numpy`` for
the CLIP text and vision towers; ``hunyuan_params_from_numpy`` for
HunyuanVideo / FramePack (the FLUX tree plus the token refiner and the
clean-latent projections) and ``llama_params_from_numpy`` for the Llama
encoder (the Qwen2.5-VL text tower too); ``qwen_image_params_from_numpy``
for Qwen-Image (the FLUX tree plus ``txt_norm``) and
``qwen_vl_vision_params_from_numpy`` for the Qwen2.5-VL vision tower;
``omnigen2_params_from_numpy`` for OmniGen2 (its refiners and trunk). Three
layout rules: the JAX block weights are
depth-stacked ``[L, ...]`` (one entry per block here), JAX's ``linear`` is
``x @ w`` with ``w: [d_in, d_out]`` while ``nn.Linear`` keeps ``[d_out, d_in]``, and JAX's
conv kernels are ``[kt, kh, kw, C_in, C_out]`` (``[kh, kw, C_in, C_out]``)
where PyTorch's are ``[C_out, C_in, kt, kh, kw]``. A tree's leaves may also
be torch tensors, as ``models/published.py``'s checkpoint converters build
them (views in the JAX tree's dtypes, depth stacks as per-block lists):
those are cast straight to each parameter's dtype, which rounds as the cast
through f32 does.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from magcache_tpu_torch.models.clip import CLIPTextConfig, CLIPVisionConfig
from magcache_tpu_torch.models.cogvideox import CogVideoXConfig
from magcache_tpu_torch.models.flux import FluxConfig
from magcache_tpu_torch.models.hunyuan import HunyuanConfig
from magcache_tpu_torch.models.latte import LatteConfig
from magcache_tpu_torch.models.llama import LlamaConfig
from magcache_tpu_torch.models.omnigen2 import OmniGen2Config
from magcache_tpu_torch.models.open_sora_plan import OpenSoraPlanConfig
from magcache_tpu_torch.models.qwen_image import QwenImageConfig
from magcache_tpu_torch.models.qwen_vl import QwenVLVisionConfig
from magcache_tpu_torch.models.stdit3 import STDiT3Config
from magcache_tpu_torch.models.t5 import T5Config, UMT5Config
from magcache_tpu_torch.models.vae import CausalVAEConfig
from magcache_tpu_torch.models.vae_cogvideox import CogVideoXVAEConfig
from magcache_tpu_torch.models.vae_osp import OSPVAEConfig
from magcache_tpu_torch.models.vae_sd import SDVAEConfig
from magcache_tpu_torch.models.vae_temporal import VAETemporalConfig
from magcache_tpu_torch.models.vae_wan import WanVAEConfig
from magcache_tpu_torch.models.vchitect import VchitectConfig
from magcache_tpu_torch.models.wan import WanConfig


def _tensor(arr, dt, device) -> torch.Tensor:
    """A tree leaf in ``dt`` on ``device``: a numpy array through f32, a torch
    tensor (a checkpoint's, already in the JAX tree's dtype) cast directly,
    which rounds the same."""
    if torch.is_tensor(arr):
        if device is not None:
            arr = arr.to(device)
        return arr.to(dt).contiguous()
    return torch.from_numpy(np.array(arr, np.float32)).to(device=device, dtype=dt)


def _permute(arr, axes):
    """``arr`` (numpy or torch) with its axes permuted."""
    return arr.permute(*axes) if torch.is_tensor(arr) else np.asarray(arr).transpose(axes)


def _transposed(arr):
    """A 2-D leaf transposed (numpy or torch)."""
    return arr.T if torch.is_tensor(arr) else np.asarray(arr).T


def _putters(sd: dict, device):
    """``(put, put_linear)``: a numpy array or torch tensor, or a JAX ``{"w":
    [d_in, d_out], "b"}`` linear transposed to ``nn.Linear``'s layout, into
    ``sd``."""
    def put(name, arr, dt=torch.float32):
        sd[name] = _tensor(arr, dt, device)

    def put_linear(name, p, dt=torch.float32):
        put(f"{name}.weight", _transposed(p["w"]), dt)
        if "b" in p:
            put(f"{name}.bias", p["b"], dt)

    return put, put_linear


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

    The VACE subtree (``vace``: patch embedding, ``before_proj``, the
    depth-stacked ``after_proj`` and blocks) takes the same split: its
    linears in ``dtype``, its modulation tables and norm gains f32.

    Sequence parallelism shards tokens, never weights: every ``sp`` rank
    loads this same whole tree (local ranks share one model).
    """
    if cfg.model_type not in ("t2v", "i2v"):
        raise NotImplementedError("the Wan model types are t2v and i2v")
    dtype = cfg.torch_dtype if dtype is None else dtype
    sd: Dict[str, torch.Tensor] = {}
    put, put_linear = _putters(sd, device)

    put_linear("patch_embedding", tree["patch_embedding"], dtype)
    for grp in ("text_embedding", "time_embedding"):
        for io in ("in", "out"):
            put_linear(f"{grp}.{io}", tree[grp][io])
    put_linear("time_projection", tree["time_projection"])
    blocks = tree["blocks"]
    linears, vectors = _BLOCK_LINEARS, _BLOCK_VECTORS
    if cfg.has_clip:
        linears += ("cross_k_img", "cross_v_img")
        vectors += ("cross_norm_k_img",)
        for io in ("in", "out"):
            put_linear(f"img_emb.{io}", tree["img_emb"][io])

    def put_blocks(prefix, blocks, depth, linears, vectors):
        for i in range(depth):
            for name in linears:
                put_linear(f"{prefix}.{i}.{name}",
                           {"w": blocks[name]["w"][i], "b": blocks[name]["b"][i]}, dtype)
            for name in vectors:
                put(f"{prefix}.{i}.{name}", blocks[name][i])

    put_blocks("blocks", blocks, cfg.layers, linears, vectors)
    if cfg.vace_layers:
        vace = tree["vace"]
        put_linear("vace.patch_embedding", vace["patch_embedding"], dtype)
        put_linear("vace.before_proj", vace["before_proj"], dtype)
        depth = len(cfg.vace_layers)
        put_blocks("vace.blocks", vace["blocks"], depth, _BLOCK_LINEARS, _BLOCK_VECTORS)
        for i in range(depth):
            put_linear(f"vace.after_proj.{i}", {"w": vace["after_proj"]["w"][i],
                                                "b": vace["after_proj"]["b"][i]}, dtype)
    put("head.modulation", tree["head"]["modulation"])
    put_linear("head.out", tree["head"]["out"])
    return sd


_STDIT3_LINEARS = ("qkv", "proj", "cross_q", "cross_kv", "cross_o", "mlp1", "mlp2")
_STDIT3_VECTORS = ("scale_shift", "q_norm", "k_norm")   # the gains only with qk-norm


def stdit3_params_from_numpy(tree: dict, cfg: STDiT3Config, device=None,
                             dtype: Optional[torch.dtype] = None
                             ) -> Dict[str, torch.Tensor]:
    """State dict for ``STDiT3Model(cfg)`` from a numpy STDiT3 pytree (the
    layout of ``magcache_tpu.models.stdit3.init_stdit3_params``).

    ``dtype`` is the dtype of the block linears (default
    ``cfg.torch_dtype``); every other parameter is f32.
    """
    dtype = cfg.torch_dtype if dtype is None else dtype
    sd: Dict[str, torch.Tensor] = {}
    put, put_linear = _putters(sd, device)

    put("y_null", tree["y_null"])
    put_linear("patch_embed", tree["patch_embed"])
    for grp in ("t_embed", "fps_embed", "y_embed"):
        for io in ("in", "out"):
            put_linear(f"{grp}.{io}", tree[grp][io])
    put_linear("t_block", tree["t_block"])
    for kind in ("spatial", "temporal"):
        g = tree[kind]
        for i in range(cfg.depth):
            for name in _STDIT3_LINEARS:
                put_linear(f"{kind}.{i}.{name}",
                           {"w": g[name]["w"][i], "b": g[name]["b"][i]}, dtype)
            for name in _STDIT3_VECTORS[:None if cfg.qk_norm else 1]:
                put(f"{kind}.{i}.{name}", g[name][i])
    put("final.scale_shift", tree["final"]["scale_shift"])
    put_linear("final.out", tree["final"]["out"])
    return sd


_FLUX_DOUBLE_LINEARS = tuple(f"{s}_{n}" for s in ("img", "txt")
                             for n in ("mod", "qkv", "proj", "mlp1", "mlp2"))


def flux_params_from_numpy(tree: dict, cfg: FluxConfig, device=None,
                           dtype: Optional[torch.dtype] = None
                           ) -> Dict[str, torch.Tensor]:
    """State dict for ``FluxModel(cfg)`` from a numpy FLUX pytree (the
    layout of ``magcache_tpu.models.flux.init_flux_params``: ``double.*``
    stacked ``[depth_double, ...]``, ``single.*`` ``[depth_single, ...]``,
    the q/k gains ``*_qk_scale`` as ``[L, 2, head_dim]``).

    ``dtype`` is the dtype of ``img_in``, ``txt_in`` and the block linears
    (default ``cfg.torch_dtype``); the embedders, the final layer and the
    q/k gains are f32.
    """
    dtype = cfg.torch_dtype if dtype is None else dtype
    sd: Dict[str, torch.Tensor] = {}
    put, put_linear = _putters(sd, device)

    def stacked(group, name, i):
        return {"w": group[name]["w"][i], "b": group[name]["b"][i]}

    put_linear("img_in", tree["img_in"], dtype)
    put_linear("txt_in", tree["txt_in"], dtype)
    embedders = ("time_in", "vector_in") + (("guidance_in",) if cfg.guidance_embed
                                            else ())
    for grp in embedders:
        for io in ("in", "out"):
            put_linear(f"{grp}.{io}", tree[grp][io])
    dbl, sgl = tree["double"], tree["single"]
    for i in range(cfg.depth_double):
        for name in _FLUX_DOUBLE_LINEARS:
            put_linear(f"double_blocks.{i}.{name}", stacked(dbl, name, i), dtype)
        for name in ("img_qk_scale", "txt_qk_scale"):
            put(f"double_blocks.{i}.{name}", dbl[name][i])
    for i in range(cfg.depth_single):
        for name in ("mod", "lin1", "lin2"):
            put_linear(f"single_blocks.{i}.{name}", stacked(sgl, name, i), dtype)
        put(f"single_blocks.{i}.qk_scale", sgl["qk_scale"][i])
    put_linear("final_mod", tree["final_mod"])
    put_linear("final_out", tree["final_out"])
    return sd


def hunyuan_params_from_numpy(tree: dict, cfg: HunyuanConfig, device=None
                              ) -> Dict[str, torch.Tensor]:
    """State dict for ``HunyuanModel(cfg)`` from a numpy HunyuanVideo tree
    (the layout of ``magcache_tpu.models.hunyuan.init_hunyuan_params``: the
    FLUX tree of ``cfg.to_flux()``, ``refiner`` with its blocks
    depth-stacked, and with ``cfg.framepack`` ``clean_proj``,
    ``clean_proj_2x`` and ``clean_proj_4x``). The MMDiT's tensors take
    ``flux_params_from_numpy``'s dtypes (``cfg.torch_dtype`` for its block
    linears); the refiner and the clean projections are f32."""
    if ("clean_proj" in tree) != cfg.framepack:
        raise ValueError(f"the tree {'has' if 'clean_proj' in tree else 'lacks'} the "
                         f"clean-latent projections, the config's framepack is "
                         f"{cfg.framepack}")
    sd = {f"mmdit.{k}": v for k, v in
          flux_params_from_numpy(tree, cfg.to_flux(), device).items()}
    put, put_linear = _putters(sd, device)
    r = tree["refiner"]
    put_linear("refiner.proj_in", r["in"])
    for grp in ("t_embed", "c_embed"):
        for io in ("in", "out"):
            put_linear(f"refiner.{grp}.{io}", r[grp][io])
    g = r["blocks"]
    for i in range(cfg.refiner_depth):
        for n in ("qkv", "proj", "mlp1", "mlp2", "mod"):
            put_linear(f"refiner.blocks.{i}.{n}", {"w": g[n]["w"][i], "b": g[n]["b"][i]})
        for n in ("norm1_w", "norm1_b", "norm2_w", "norm2_b"):
            put(f"refiner.blocks.{i}.{n}", g[n][i])
    if cfg.framepack:
        for n in ("clean_proj", "clean_proj_2x", "clean_proj_4x"):
            put_linear(n, tree[n])
    return sd


def llama_params_from_numpy(tree: dict, cfg: LlamaConfig, device=None
                            ) -> Dict[str, torch.Tensor]:
    """State dict for ``LlamaModel(cfg)`` from a numpy Llama tree (the layout
    of ``magcache_tpu.models.llama.init_llama_params``, blocks
    depth-stacked, q/k/v biases where ``cfg.qkv_bias``): the embedding and
    the linears in ``cfg.torch_dtype``, the norm gains f32."""
    sd: Dict[str, torch.Tensor] = {}
    put, put_linear = _putters(sd, device)
    dt = cfg.torch_dtype
    put("embed", tree["embed"], dt)
    put("final_norm", tree["final_norm"])
    g = tree["blocks"]
    for i in range(cfg.layers):
        for n in ("in_norm", "post_norm"):
            put(f"blocks.{i}.{n}", g[n][i])
        for n in ("q", "k", "v", "o", "gate", "up", "down"):
            put_linear(f"blocks.{i}.{n}", {k: a[i] for k, a in g[n].items()}, dt)
    return sd


def qwen_image_params_from_numpy(tree: dict, cfg: QwenImageConfig, device=None
                                ) -> Dict[str, torch.Tensor]:
    """State dict for ``QwenImageModel(cfg)`` from a numpy Qwen-Image tree
    (the layout of ``magcache_tpu.models.qwen_image.init_qwen_image_params``:
    the FLUX tree of ``cfg.to_flux()``, zero-length ``single`` stacks, and
    ``txt_norm``), with ``flux_params_from_numpy``'s dtypes; the gain is f32."""
    sd = {f"mmdit.{k}": v for k, v in
          flux_params_from_numpy(tree, cfg.to_flux(), device).items()}
    put, _ = _putters(sd, device)
    put("txt_norm", tree["txt_norm"])
    return sd


def omnigen2_params_from_numpy(tree: dict, cfg: OmniGen2Config, device=None
                               ) -> Dict[str, torch.Tensor]:
    """State dict for ``OmniGen2Model(cfg)`` from a numpy OmniGen2 tree (the
    layout of ``magcache_tpu.models.omnigen2.init_omnigen2_params``: the
    block groups ``context_refiner``, ``noise_refiner``, ``ref_refiner`` and
    ``layers`` depth-stacked). ``cap_proj``, ``x_embed``, ``ref_embed`` and
    the block linears take ``cfg.torch_dtype``; ``t_embed``, the
    modulations, ``norm_out_mod``, ``final_out`` and every gain are f32."""
    sd: Dict[str, torch.Tensor] = {}
    put, put_linear = _putters(sd, device)
    dt = cfg.torch_dtype
    for io in ("in", "out"):
        put_linear(f"t_embed.{io}", tree["t_embed"][io])
    put("cap_norm", tree["cap_norm"])
    for n in ("cap_proj", "x_embed", "ref_embed"):
        put_linear(n, tree[n], dt)
    for n in ("norm_out_mod", "final_out"):
        put_linear(n, tree[n])
    for grp, depth in (("context_refiner", cfg.refiner_layers),
                       ("noise_refiner", cfg.refiner_layers),
                       ("ref_refiner", cfg.refiner_layers), ("layers", cfg.layers)):
        g = tree[grp]
        for i in range(depth):
            for n in ("q", "kv", "o", "w1", "w3", "w2"):
                put_linear(f"{grp}.{i}.{n}", {k: a[i] for k, a in g[n].items()}, dt)
            for n in ("q_norm", "k_norm", "norm1", "norm2", "ffn_norm1", "ffn_norm2"):
                put(f"{grp}.{i}.{n}", g[n][i])
            if "mod" in g:
                put_linear(f"{grp}.{i}.mod", {k: a[i] for k, a in g["mod"].items()})
    return sd


def qwen_vl_vision_params_from_numpy(tree: dict, cfg: QwenVLVisionConfig, device=None
                                     ) -> Dict[str, torch.Tensor]:
    """State dict for ``QwenVLVisionTower(cfg)`` from a numpy tree in the
    layout of ``magcache_tpu.models.qwen_vl.init_qwen_vl_vision_params``
    (``patch`` ``[patch_dim, hidden]``, blocks depth-stacked, ``merger``
    with ``ln``, ``fc1``, ``fc2``): linears in ``cfg.torch_dtype``, gains
    f32."""
    sd: Dict[str, torch.Tensor] = {}
    put, put_linear = _putters(sd, device)
    dt = cfg.torch_dtype
    put_linear("patch", {"w": tree["patch"]}, dt)
    g = tree["blocks"]
    for i in range(cfg.depth):
        for n in ("norm1", "norm2"):
            put(f"blocks.{i}.{n}", g[n][i])
        for n in ("qkv", "proj", "gate", "up", "down"):
            put_linear(f"blocks.{i}.{n}", {k: a[i] for k, a in g[n].items()}, dt)
    m = tree["merger"]
    put("merger_ln", m["ln"])
    put_linear("merger_fc1", m["fc1"], dt)
    put_linear("merger_fc2", m["fc2"], dt)
    return sd


_LATTE_LINEARS = ("qkv", "proj", "ff1", "ff2")
_LATTE_CROSS_LINEARS = ("cross_q", "cross_kv", "cross_o")


def latte_params_from_numpy(tree: dict, cfg: LatteConfig, device=None,
                            dtype: Optional[torch.dtype] = None
                            ) -> Dict[str, torch.Tensor]:
    """State dict for ``LatteModel(cfg)`` from a numpy Latte pytree (the
    layout of ``magcache_tpu.models.latte.init_latte_params``; its
    ``temp_pos`` entry is None, the table being built per grid).

    ``dtype`` is the dtype of the patch embedding and the block linears
    (default ``cfg.torch_dtype``); every other parameter is f32.
    """
    dtype = cfg.torch_dtype if dtype is None else dtype
    sd: Dict[str, torch.Tensor] = {}
    put, put_linear = _putters(sd, device)

    put_linear("patch_embed", tree["patch_embed"], dtype)
    for grp in ("caption", "time"):
        for io in ("in", "out"):
            put_linear(f"{grp}.{io}", tree[grp][io])
    put_linear("adaln_single", tree["adaln_single"])
    for kind in ("spatial", "temporal"):
        g = tree[kind]
        names = _LATTE_LINEARS + (_LATTE_CROSS_LINEARS if kind == "spatial" else ())
        for i in range(cfg.depth):
            for name in names:
                put_linear(f"{kind}.{i}.{name}",
                           {"w": g[name]["w"][i], "b": g[name]["b"][i]}, dtype)
            put(f"{kind}.{i}.scale_shift", g["scale_shift"][i])
    put("final_mod", tree["final_mod"])
    put_linear("final_out", tree["final_out"])
    return sd


_OSP_LINEARS = ("qkv", "proj", "cross_q", "cross_kv", "cross_o", "ff1", "ff2")


def osp_params_from_numpy(tree: dict, cfg: OpenSoraPlanConfig, device=None,
                          dtype: Optional[torch.dtype] = None
                          ) -> Dict[str, torch.Tensor]:
    """State dict for ``OSPModel(cfg)`` from a numpy Open-Sora-Plan v1.2
    pytree (the layout of ``magcache_tpu.models.open_sora_plan.
    init_osp_params``). ``dtype`` is the dtype of the patch embedding and the
    block linears (default ``cfg.torch_dtype``); every other parameter is
    f32."""
    dtype = cfg.torch_dtype if dtype is None else dtype
    sd: Dict[str, torch.Tensor] = {}
    put, put_linear = _putters(sd, device)
    put_linear("patch_embed", tree["patch_embed"], dtype)
    for grp in ("caption", "time"):
        for io in ("in", "out"):
            put_linear(f"{grp}.{io}", tree[grp][io])
    put_linear("adaln_single", tree["adaln_single"])
    g = tree["blocks"]
    for i in range(cfg.depth):
        for name in _OSP_LINEARS:
            put_linear(f"blocks.{i}.{name}", {"w": g[name]["w"][i], "b": g[name]["b"][i]},
                       dtype)
        put(f"blocks.{i}.scale_shift", g["scale_shift"][i])
    put("final_mod", tree["final_mod"])
    put_linear("final_out", tree["final_out"])
    return sd


_COGVIDEOX_LINEARS = ("mod1", "mod2", "qkv", "proj", "ff1", "ff2")
_COGVIDEOX_VECTORS = ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "q_norm_w", "q_norm_b",
                      "k_norm_w", "k_norm_b")


def cogvideox_params_from_numpy(tree: dict, cfg: CogVideoXConfig, device=None,
                                dtype: Optional[torch.dtype] = None
                                ) -> Dict[str, torch.Tensor]:
    """State dict for ``CogVideoXModel(cfg)`` from a numpy CogVideoX pytree
    (the layout of ``magcache_tpu.models.cogvideox.init_cogvideox_params``).
    ``dtype`` is the dtype of the patch and text embeddings and the block
    linears (default ``cfg.torch_dtype``); every other parameter is f32."""
    dtype = cfg.torch_dtype if dtype is None else dtype
    sd: Dict[str, torch.Tensor] = {}
    put, put_linear = _putters(sd, device)
    put_linear("patch_embed", tree["patch_embed"], dtype)
    put_linear("text_proj", tree["text_proj"], dtype)
    for io in ("in", "out"):
        put_linear(f"time.{io}", tree["time"][io])
    g = tree["blocks"]
    for i in range(cfg.layers):
        for name in _COGVIDEOX_LINEARS:
            put_linear(f"blocks.{i}.{name}", {"w": g[name]["w"][i], "b": g[name]["b"][i]},
                       dtype)
        for name in _COGVIDEOX_VECTORS:
            put(f"blocks.{i}.{name}", g[name][i])
    for name in ("norm_final_w", "norm_final_b", "norm_out_w", "norm_out_b"):
        put(name, tree[name])
    put_linear("final_mod", tree["final_mod"])
    put_linear("final_out", tree["final_out"])
    return sd


_UMT5_LINEARS = ("q", "k", "v", "o", "wi0", "wi1", "wo")


def umt5_params_from_numpy(tree: dict, cfg: UMT5Config, device=None
                           ) -> Dict[str, torch.Tensor]:
    """State dict for ``UMT5Model(cfg)`` from a numpy UMT5 pytree (the
    layout of ``magcache_tpu.models.umt5.init_umt5_params``), every tensor
    in ``cfg.torch_dtype``."""
    dt = cfg.torch_dtype

    def put(arr):
        return _tensor(arr, dt, device)

    blocks = tree["blocks"]
    sd = {"embed": put(tree["embed"]), "final_ln": put(tree["final_ln"])}
    for i in range(cfg.layers):
        for name in ("ln1", "ln2", "rel"):
            sd[f"blocks.{i}.{name}"] = put(blocks[name][i])
        for name in _UMT5_LINEARS:
            sd[f"blocks.{i}.{name}.weight"] = put(_transposed(blocks[name][i]))
    return sd


def t5_params_from_flax(tree: dict, cfg: T5Config, device=None
                        ) -> Dict[str, torch.Tensor]:
    """State dict for ``T5Model(cfg)`` from a Flax T5 / mT5 encoder's params
    as numpy (``magcache_tpu.models.text.JaxT5Encoder(...).params``: HF
    ``FlaxT5EncoderModel`` keys, ``Dense`` kernels ``[in, out]``, the
    relative bias in block 0 only), every tensor in ``cfg.torch_dtype``."""
    if cfg.per_layer_bias:
        raise ValueError("a Flax T5 tree shares block 0's bias; a per-layer-bias (UMT5) "
                         "config takes umt5_params_from_numpy")
    dt = cfg.torch_dtype

    def put(arr, transpose=False):
        return _tensor(_transposed(arr) if transpose else arr, dt, device)

    enc = tree["encoder"]
    sd = {"embed": put(tree["shared"]["embedding"]),
          "final_ln": put(enc["final_layer_norm"]["weight"])}
    ff = (("wi", "wi"),) if cfg.feed_forward == "relu" else (("wi_0", "wi0"), ("wi_1", "wi1"))
    for i in range(cfg.layers):
        att, mlp = (enc["block"][str(i)]["layer"][j] for j in ("0", "1"))
        sa, dense = att["SelfAttention"], mlp["DenseReluDense"]
        pre = f"blocks.{i}."
        sd[pre + "ln1"] = put(att["layer_norm"]["weight"])
        sd[pre + "ln2"] = put(mlp["layer_norm"]["weight"])
        for n in "qkvo":
            sd[f"{pre}{n}.weight"] = put(sa[n]["kernel"], transpose=True)
        if i == 0:
            sd[pre + "rel"] = put(sa["relative_attention_bias"]["embedding"])
        for flax_name, name in ff + (("wo", "wo"),):
            sd[f"{pre}{name}.weight"] = put(dense[flax_name]["kernel"], transpose=True)
    return sd


def clip_text_params_from_numpy(tree: dict, cfg: CLIPTextConfig, device=None
                                ) -> Dict[str, torch.Tensor]:
    """State dict for ``CLIPTextModel(cfg)`` from a numpy CLIP text tree (the
    layout of ``magcache_tpu.models.clip.init_clip_text_params``, blocks
    depth-stacked, fused qkv; ``text_proj [dim, projection_dim]`` where the
    config has a projection), every tensor in ``cfg.torch_dtype``."""
    if ("text_proj" in tree) != (cfg.projection_dim is not None):
        raise ValueError(f"the tree {'has' if 'text_proj' in tree else 'lacks'} text_proj, "
                         f"the config's projection_dim is {cfg.projection_dim}")
    sd: Dict[str, torch.Tensor] = {}
    put, put_linear = _putters(sd, device)
    dt = cfg.torch_dtype
    put("tok", tree["tok"], dt)
    put("pos", tree["pos"], dt)
    put("final_norm.weight", tree["final_norm_w"], dt)
    put("final_norm.bias", tree["final_norm_b"], dt)
    if "text_proj" in tree:
        put("text_proj", tree["text_proj"], dt)
    g = tree["blocks"]
    for i in range(cfg.layers):
        for n in ("norm1", "norm2"):
            put(f"blocks.{i}.{n}.weight", g[f"{n}_w"][i], dt)
            put(f"blocks.{i}.{n}.bias", g[f"{n}_b"][i], dt)
        for n in ("qkv", "proj", "mlp1", "mlp2"):
            put_linear(f"blocks.{i}.{n}", {"w": g[n]["w"][i], "b": g[n]["b"][i]}, dt)
    return sd


def clip_vision_params_from_numpy(tree: dict, cfg: CLIPVisionConfig, device=None
                                  ) -> Dict[str, torch.Tensor]:
    """State dict for ``CLIPVisionModel(cfg)`` from a numpy CLIP vision tree
    (the layout of ``magcache_tpu.models.clip.init_clip_vision_params``,
    blocks depth-stacked, fused qkv): the patch embedding and the block
    linears in ``cfg.torch_dtype``, the class token, positions and norms
    f32."""
    sd: Dict[str, torch.Tensor] = {}
    put, put_linear = _putters(sd, device)
    dt = cfg.torch_dtype
    put_linear("patch_embed", tree["patch_embed"], dt)
    put("cls", tree["cls"])
    put("pos", tree["pos"])
    for n in ("pre_norm", "post_norm"):
        put(f"{n}.weight", tree[f"{n}_w"])
        put(f"{n}.bias", tree[f"{n}_b"])
    g = tree["blocks"]
    for i in range(cfg.layers):
        for n in ("norm1", "norm2"):
            put(f"blocks.{i}.{n}.weight", g[f"{n}_w"][i])
            put(f"blocks.{i}.{n}.bias", g[f"{n}_b"][i])
        for n in ("qkv", "proj", "mlp1", "mlp2"):
            put_linear(f"blocks.{i}.{n}", {"w": g[n]["w"][i], "b": g[n]["b"][i]}, dt)
    return sd


def wan_vae_params_from_numpy(tree: dict, cfg: WanVAEConfig, device=None
                              ) -> Dict[str, torch.Tensor]:
    """State dict for ``WanVAE(cfg)`` (encoder, decoder and the quant and
    post-quant convs) from a numpy Wan VAE pytree (the layout of
    ``magcache_tpu.models.vae_wan.init_wan_vae_params``). Conv weights and
    biases in ``cfg.torch_dtype``, norm gains f32."""
    dt = cfg.torch_dtype
    sd: Dict[str, torch.Tensor] = {}
    put, _ = _putters(sd, device)

    def conv(name, p):
        n = p["w"].ndim
        put(f"{name}.weight", _permute(p["w"], (n - 1, n - 2) + tuple(range(n - 2))), dt)
        put(f"{name}.bias", p["b"], dt)

    def res(name, p):
        put(f"{name}.norm1", p["norm1"])
        put(f"{name}.norm2", p["norm2"])
        for c in ("conv1", "conv2", "shortcut"):
            if c in p:
                conv(f"{name}.{c}", p[c])

    conv("post_quant", tree["post_quant"])
    conv("quant", tree["quant"])
    for side in ("encoder", "decoder"):
        t = tree[side]
        conv(f"{side}.conv1", t["conv1"])
        for i, p in enumerate(t["mid"]):
            res(f"{side}.mid.{i}", p)
        put(f"{side}.mid_attn.norm", t["mid_attn"]["norm"])
        conv(f"{side}.mid_attn.qkv", t["mid_attn"]["qkv"])
        conv(f"{side}.mid_attn.proj", t["mid_attn"]["proj"])
        for i, lv in enumerate(t["levels"]):
            for j, p in enumerate(lv["blocks"]):
                res(f"{side}.levels.{i}.blocks.{j}", p)
            for c in ("resample", "time_conv"):
                if lv[c] is not None:
                    conv(f"{side}.levels.{i}.{c}", lv[c])
        put(f"{side}.head_norm", t["head_norm"])
        conv(f"{side}.head", t["head"])
    return sd


_VCHITECT_LAST = ("mod_x", "q", "k", "v", "o", "qt", "kt", "vt", "ot", "qc", "oc", "add_q",
                  "add_k", "add_v", "ff1", "ff2", "mod_c2")
_VCHITECT_BLOCK = _VCHITECT_LAST[:-1] + ("mod_c", "add_out", "add_out_t", "ffc1", "ffc2")


def vchitect_params_from_numpy(tree: dict, cfg: VchitectConfig, device=None,
                               dtype: Optional[torch.dtype] = None
                               ) -> Dict[str, torch.Tensor]:
    """State dict for ``VchitectModel(cfg)`` from a numpy Vchitect-XL pytree
    (the layout of ``magcache_tpu.models.vchitect.init_vchitect_params``: the
    ``depth - 1`` joint blocks stacked in ``blocks``, the context-pre-only
    block in ``last``). ``dtype`` is the dtype of the patch and context
    embeddings and the block linears (default ``cfg.torch_dtype``); the
    time and pooled embedders, ``norm_out_mod`` and ``proj_out`` are f32."""
    dtype = cfg.torch_dtype if dtype is None else dtype
    sd: Dict[str, torch.Tensor] = {}
    put, put_linear = _putters(sd, device)
    put_linear("patch_embed", tree["patch_embed"], dtype)
    put_linear("context_in", tree["context_in"], dtype)
    for grp in ("time_in", "pooled_in"):
        for io in ("in", "out"):
            put_linear(f"{grp}.{io}", tree[grp][io])
    g = tree["blocks"]
    for i in range(cfg.depth - 1):
        for name in _VCHITECT_BLOCK:
            put_linear(f"blocks.{i}.{name}", {"w": g[name]["w"][i], "b": g[name]["b"][i]},
                       dtype)
    for name in _VCHITECT_LAST:
        put_linear(f"last.{name}", tree["last"][name], dtype)
    put_linear("norm_out_mod", tree["norm_out_mod"])
    put_linear("proj_out", tree["proj_out"])
    return sd


def _put_vae_tree(put, prefix: str, node) -> None:
    """A JAX VAE subtree into state dict entries named by its keys and list
    indices: a ``{"w", "b"}`` leaf is a conv (``w [k..., C_in, C_out]`` ->
    ``[C_out, C_in, k...]``) or a GroupNorm affine (``w [C]``); None is a
    layer the configuration leaves out."""
    if node is None:
        return
    if isinstance(node, dict) and "w" in node:
        w = node["w"]
        if w.ndim > 1:
            w = _permute(w, (w.ndim - 1, w.ndim - 2) + tuple(range(w.ndim - 2)))
        put(f"{prefix}.weight", w)
        put(f"{prefix}.bias", node["b"])
        return
    for key, sub in (node.items() if isinstance(node, dict) else enumerate(node)):
        _put_vae_tree(put, f"{prefix}.{key}", sub)


def causal_vae_params_from_numpy(tree: dict, cfg: CausalVAEConfig, device=None
                                 ) -> Dict[str, torch.Tensor]:
    """State dict for ``CausalVAE(cfg)`` (its encoder, f32) from a numpy
    causal-VAE pytree (the layout of ``magcache_tpu.models.vae.
    init_causal_vae_params``: ``level{i}`` with ``blocks`` and ``down`` ``{conv,
    tstride}``; the decoder is not ported and is left out)."""
    sd: Dict[str, torch.Tensor] = {}
    put, _ = _putters(sd, device)
    enc = tree["encoder"]
    levels = [{"blocks": enc[f"level{i}"]["blocks"],
               "down": enc[f"level{i}"]["down"] and enc[f"level{i}"]["down"]["conv"]}
              for i in range(len(cfg.ch_mult))]
    _put_vae_tree(put, "encoder", {"stem": enc["stem"], "levels": levels, "mid": enc["mid"],
                                   "out_norm": enc["out_norm"], "out": enc["out"]})
    return sd


def osp_vae_params_from_numpy(tree: dict, cfg: OSPVAEConfig, device=None
                              ) -> Dict[str, torch.Tensor]:
    """State dict for ``OSPCausalVAE(cfg)`` (the decoder and the post-quant
    conv, f32) from a numpy Open-Sora-Plan CausalVAE pytree (the layout of
    ``magcache_tpu.models.vae_osp.init_osp_vae_params``; its encoder is not
    ported and is left out)."""
    sd: Dict[str, torch.Tensor] = {}
    put, _ = _putters(sd, device)
    if cfg.use_quant_layer:
        _put_vae_tree(put, "post_quant_conv", tree["post_quant_conv"])
    _put_vae_tree(put, "decoder", tree["decoder"])
    return sd


def cogvideox_vae_params_from_numpy(tree: dict, cfg: CogVideoXVAEConfig, device=None
                                    ) -> Dict[str, torch.Tensor]:
    """State dict for ``CogVideoXVAE(cfg)`` (the decoder, f32) from a numpy
    CogVideoX VAE pytree (the layout of ``magcache_tpu.models.vae_cogvideox.
    init_cogvideox_vae_params``; its encoder is not ported and is left
    out)."""
    sd: Dict[str, torch.Tensor] = {}
    put, _ = _putters(sd, device)
    _put_vae_tree(put, "decoder", tree["decoder"])
    return sd


def _sd_res(node: dict) -> dict:
    """A JAX SD-VAE ResNet block with diffusers' shortcut name."""
    return {("conv_shortcut" if k == "shortcut" else k): v for k, v in node.items()}


def _put_sd_mid(put, prefix: str, mid: dict) -> None:
    """A JAX SD-VAE mid block (``res1``, ``attn``, ``res2``) under diffusers'
    names; the attention's ``[out, in]`` linears come over as they are."""
    _put_vae_tree(put, f"{prefix}.resnets", [_sd_res(mid["res1"]), _sd_res(mid["res2"])])
    a = f"{prefix}.attentions.0"
    _put_vae_tree(put, f"{a}.group_norm", mid["attn"]["norm"])
    for src, dst in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("o", "to_out.0")):
        put(f"{a}.{dst}.weight", mid["attn"][src]["w"])
        put(f"{a}.{dst}.bias", mid["attn"][src]["b"])


def sd_vae_params_from_numpy(tree: dict, cfg: SDVAEConfig, device=None
                             ) -> Dict[str, torch.Tensor]:
    """State dict for ``SDVAE(cfg)`` (f32, diffusers ``AutoencoderKL`` names)
    from a numpy SD-VAE pytree (the layout of ``magcache_tpu.models.vae_sd.
    init_sd_vae_params``: ``level{i}`` with ``res`` and ``down`` / ``up``,
    ``mid`` with ``res1``, ``attn``, ``res2``)."""
    sd: Dict[str, torch.Tensor] = {}
    put, _ = _putters(sd, device)
    for side, blocks, resample in (("encoder", "down_blocks", "downsamplers"),
                                   ("decoder", "up_blocks", "upsamplers")):
        t = tree[side]
        _put_vae_tree(put, f"{side}.conv_in", t["conv_in"])
        _put_sd_mid(put, f"{side}.mid_block", t["mid"])
        for i in range(len(cfg.ch_mult)):
            lv = t[f"level{i}"]
            _put_vae_tree(put, f"{side}.{blocks}.{i}.resnets", [_sd_res(r) for r in lv["res"]])
            _put_vae_tree(put, f"{side}.{blocks}.{i}.{resample}.0.conv",
                          lv["down" if side == "encoder" else "up"])
        _put_vae_tree(put, f"{side}.conv_norm_out", t["norm_out"])
        _put_vae_tree(put, f"{side}.conv_out", t["conv_out"])
    if cfg.quant_conv:
        _put_vae_tree(put, "quant_conv", tree["quant_conv"])
        _put_vae_tree(put, "post_quant_conv", tree["post_quant_conv"])
    return sd


def vae_temporal_params_from_numpy(tree: dict, cfg: VAETemporalConfig, device=None
                                   ) -> Dict[str, torch.Tensor]:
    """State dict for ``VAETemporal(cfg)`` (f32, the reference's
    ``VAE_Temporal`` names) from a numpy tree in the layout of
    ``magcache_tpu.models.vae_temporal.init_vae_temporal_params``; every conv
    sits in a ``CausalConv3d`` (``.conv``), the ResNet convs without bias."""
    sd: Dict[str, torch.Tensor] = {}
    put, _ = _putters(sd, device)

    def conv(prefix, node):
        put(f"{prefix}.conv.weight", _permute(node["w"], (4, 3, 0, 1, 2)))
        if "b" in node:
            put(f"{prefix}.conv.bias", node["b"])

    def res(prefix, node):
        for name in ("norm1", "norm2"):
            _put_vae_tree(put, f"{prefix}.{name}", node[name])
        for name in ("conv1", "conv2", "conv3"):
            if name in node:
                conv(f"{prefix}.{name}", node[name])

    for side in ("encoder", "decoder"):
        t = tree[side]
        for j, r in enumerate(t["res_blocks"]):
            res(f"{side}.res_blocks.{j}", r)
        for i, lv in enumerate(t["blocks"]):
            for j, r in enumerate(lv["res"]):
                res(f"{side}.block_res_blocks.{i}.{j}", r)
            resample = lv["down"] if side == "encoder" else lv["up"]
            if resample is not None:
                conv(f"{side}.conv_blocks.{i if side == 'encoder' else i - 1}", resample)
        _put_vae_tree(put, f"{side}.norm1", t["norm1"])
    conv("encoder.conv_in", tree["encoder"]["conv_in"])
    conv("encoder.conv2", tree["encoder"]["conv2"])
    conv("decoder.conv1", tree["decoder"]["conv1"])
    conv("decoder.conv_out", tree["decoder"]["conv_out"])
    conv("quant_conv", tree["quant_conv"])
    conv("post_quant_conv", tree["post_quant_conv"])
    return sd
