"""Published checkpoints into the port (``models/checkpoint.py``,
``models/published.py`` and the encoder and VAE loaders) against the JAX
package's converters.

Each case builds a tiny published-layout state dict from a seed, converts it
with the JAX converter and the port's ``*_params_from_numpy`` (the in-process
reference), and requires the port's converter to give the same state dict
bit for bit, for f32 and bf16 models. No forward runs here: ``tests/
test_convert.py`` runs JAX's converted forwards, and the port's forwards are
held to JAX's in the per-family files.
"""

import dataclasses
import json
import struct

import jax
import numpy as np
import pytest
import torch

from magcache_tpu.models import convert as JC
from magcache_tpu_torch.models import convert as TC
from magcache_tpu_torch.models import published as P
from magcache_tpu_torch.models.checkpoint import (load_safetensors_dir, read_safetensors,
                                                  save_safetensors, torch_load_flat)
from tests.test_convert import _flux_tiny_sd, _rlin, _wan_tiny_sd, make_omnigen2_sd


def _torch_sd(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_state_dicts_equal(got, want):
    assert got.keys() == want.keys(), sorted(got.keys() ^ want.keys())[:5]
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert torch.equal(got[k].cpu(), want[k].cpu()), k


# ---- published-layout builders of the families test_convert.py builds inline --

def _hunyuan_sd(cfg, rng):
    d, hd, mlp_d = cfg.hidden, cfg.head_dim, cfg.mlp_ratio * cfg.hidden
    sd = {"img_in.proj.weight": rng.normal(0, .05, (d, cfg.in_channels, 1, 2, 2)).astype("f4"),
          "img_in.proj.bias": rng.normal(0, .01, (d,)).astype("f4")}
    for name, i, o in (("txt_in.input_embedder", cfg.text_dim, d),
                       ("txt_in.t_embedder.mlp.0", cfg.time_embed_dim, d),
                       ("txt_in.t_embedder.mlp.2", d, d),
                       ("txt_in.c_embedder.linear_1", cfg.text_dim, d),
                       ("txt_in.c_embedder.linear_2", d, d),
                       ("time_in.mlp.0", cfg.time_embed_dim, d), ("time_in.mlp.2", d, d),
                       ("vector_in.in_layer", cfg.vec_dim, d), ("vector_in.out_layer", d, d),
                       ("guidance_in.mlp.0", cfg.time_embed_dim, d), ("guidance_in.mlp.2", d, d),
                       ("final_layer.adaLN_modulation.1", d, 2 * d),
                       ("final_layer.linear", d, cfg.patch_in)):
        _rlin(rng, sd, name, i, o)
    for i in range(cfg.refiner_depth):
        b = f"txt_in.individual_token_refiner.blocks.{i}"
        for name, di, do in (("self_attn_qkv", d, 3 * d), ("self_attn_proj", d, d),
                             ("mlp.fc1", d, mlp_d), ("mlp.fc2", mlp_d, d),
                             ("adaLN_modulation.1", d, 2 * d)):
            _rlin(rng, sd, f"{b}.{name}", di, do)
        for nm in ("norm1", "norm2"):
            sd[f"{b}.{nm}.weight"] = rng.normal(1, .1, d).astype("f4")
            sd[f"{b}.{nm}.bias"] = rng.normal(0, .1, d).astype("f4")
    for i in range(cfg.depth_double):
        b = f"double_blocks.{i}"
        for s in ("img", "txt"):
            for name, di, do in ((f"{s}_mod.linear", d, 6 * d), (f"{s}_attn_qkv", d, 3 * d),
                                 (f"{s}_attn_proj", d, d), (f"{s}_mlp.fc1", d, mlp_d),
                                 (f"{s}_mlp.fc2", mlp_d, d)):
                _rlin(rng, sd, f"{b}.{name}", di, do)
            for n in ("q", "k"):
                sd[f"{b}.{s}_attn_{n}_norm.weight"] = rng.normal(1, .1, hd).astype("f4")
    for i in range(cfg.depth_single):
        b = f"single_blocks.{i}"
        _rlin(rng, sd, f"{b}.modulation.linear", d, 3 * d)
        _rlin(rng, sd, f"{b}.linear1", d, 3 * d + mlp_d)
        _rlin(rng, sd, f"{b}.linear2", d + mlp_d, d)
        for n in ("q", "k"):
            sd[f"{b}.{n}_norm.weight"] = rng.normal(1, .1, hd).astype("f4")
    # the hyvideo .pt's "module." prefix
    return {f"module.{k}": v for k, v in sd.items()}


def _qwen_image_sd(cfg, rng):
    f = cfg.to_flux()
    d, hd, mlp_d = f.hidden, f.head_dim, f.mlp_ratio * f.hidden
    sd = {"txt_norm.weight": rng.normal(1, .1, cfg.text_dim).astype("f4")}
    for name, i, o in (("img_in", cfg.in_channels, d), ("txt_in", cfg.text_dim, d),
                       ("time_text_embed.timestep_embedder.linear_1", cfg.time_embed_dim, d),
                       ("time_text_embed.timestep_embedder.linear_2", d, d),
                       ("norm_out.linear", d, 2 * d), ("proj_out", d, cfg.in_channels)):
        _rlin(rng, sd, name, i, o)
    for i in range(cfg.depth):
        b = f"transformer_blocks.{i}"
        for name, di, do in (("img_mod.1", d, 6 * d), ("txt_mod.1", d, 6 * d),
                             ("attn.to_out.0", d, d), ("attn.to_add_out", d, d),
                             ("img_mlp.net.0.proj", d, mlp_d), ("img_mlp.net.2", mlp_d, d),
                             ("txt_mlp.net.0.proj", d, mlp_d), ("txt_mlp.net.2", mlp_d, d)):
            _rlin(rng, sd, f"{b}.{name}", di, do)
        for n in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            _rlin(rng, sd, f"{b}.attn.{n}", d, d)
        for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            sd[f"{b}.attn.{n}.weight"] = rng.normal(1, .1, hd).astype("f4")
    return sd


def _cogvideox_sd(cfg, rng):
    d, ct, hd = cfg.hidden, cfg.cond_dim, cfg.head_dim
    sd = {"patch_embed.proj.weight": rng.normal(
        0, .05, (d, cfg.in_channels, cfg.patch, cfg.patch)).astype("f4"),
        "patch_embed.proj.bias": rng.normal(0, .01, (d,)).astype("f4")}
    for name, i, o in (("patch_embed.text_proj", cfg.text_dim, d),
                       ("time_embedding.linear_1", cfg.time_embed_dim, ct),
                       ("time_embedding.linear_2", ct, ct), ("norm_out.linear", ct, 2 * d),
                       ("proj_out", d, cfg.in_channels * cfg.patch ** 2)):
        _rlin(rng, sd, name, i, o)
    for i in range(cfg.layers):
        b = f"transformer_blocks.{i}"
        _rlin(rng, sd, f"{b}.norm1.linear", ct, 6 * d)
        _rlin(rng, sd, f"{b}.norm2.linear", ct, 6 * d)
        for n in ("to_q", "to_k", "to_v", "to_out.0"):
            _rlin(rng, sd, f"{b}.attn1.{n}", d, d)
        _rlin(rng, sd, f"{b}.ff.net.0.proj", d, cfg.mlp_ratio * d)
        _rlin(rng, sd, f"{b}.ff.net.2", cfg.mlp_ratio * d, d)
        for nm, w in (("norm1.norm", d), ("norm2.norm", d), ("attn1.norm_q", hd),
                      ("attn1.norm_k", hd)):
            sd[f"{b}.{nm}.weight"] = rng.normal(1, .1, w).astype("f4")
            sd[f"{b}.{nm}.bias"] = rng.normal(0, .1, w).astype("f4")
    for nm in ("norm_final", "norm_out.norm"):
        sd[f"{nm}.weight"] = rng.normal(1, .1, d).astype("f4")
        sd[f"{nm}.bias"] = rng.normal(0, .1, d).astype("f4")
    return sd


def _stdit3_sd(cfg, rng):
    d, hd, mlp_d = cfg.hidden, cfg.head_dim, cfg.mlp_ratio * cfg.hidden
    pt, ph, pw = cfg.patch
    sd = {"x_embedder.proj.weight": rng.normal(
        0, .05, (d, cfg.in_channels, pt, ph, pw)).astype("f4"),
        "x_embedder.proj.bias": rng.normal(0, .01, (d,)).astype("f4"),
        "y_embedder.y_embedding": rng.normal(
            0, .05, (cfg.caption_max_len, cfg.caption_dim)).astype("f4"),
        "final_layer.scale_shift_table": rng.normal(0, .02, (2, d)).astype("f4")}
    for name, i, o in (("t_embedder.mlp.0", cfg.freq_dim, d), ("t_embedder.mlp.2", d, d),
                       ("fps_embedder.mlp.0", cfg.freq_dim, d), ("fps_embedder.mlp.2", d, d),
                       ("t_block.1", d, 6 * d), ("y_embedder.y_proj.fc1", cfg.caption_dim, d),
                       ("y_embedder.y_proj.fc2", d, d),
                       ("final_layer.linear", d, cfg.in_channels * 2 * pt * ph * pw)):
        _rlin(rng, sd, name, i, o)
    for pre in ("spatial_blocks", "temporal_blocks"):
        for i in range(cfg.depth):
            b = f"{pre}.{i}"
            sd[f"{b}.scale_shift_table"] = rng.normal(0, .02, (6, d)).astype("f4")
            for name, di, do in (("attn.qkv", d, 3 * d), ("attn.proj", d, d),
                                 ("cross_attn.q_linear", d, d),
                                 ("cross_attn.kv_linear", d, 2 * d),
                                 ("cross_attn.proj", d, d), ("mlp.fc1", d, mlp_d),
                                 ("mlp.fc2", mlp_d, d)):
                _rlin(rng, sd, f"{b}.{name}", di, do)
            for n in ("q_norm", "k_norm"):
                sd[f"{b}.attn.{n}.weight"] = rng.normal(1, .1, hd).astype("f4")
    return sd


def _pixart_sd(cfg, rng, blocks, patch_shape, out_dim):
    """Latte / Open-Sora-Plan: ``blocks`` is ``[(prefix, cross)]``."""
    d, mlp_d = cfg.hidden, cfg.mlp_ratio * cfg.hidden
    sd = {"pos_embed.proj.weight": rng.normal(0, .05, (d, cfg.in_channels) + patch_shape
                                              ).astype("f4"),
          "pos_embed.proj.bias": rng.normal(0, .01, (d,)).astype("f4"),
          "scale_shift_table": rng.normal(0, .02, (2, d)).astype("f4")}
    for name, i, o in (("caption_projection.linear_1", cfg.caption_dim, d),
                       ("caption_projection.linear_2", d, d),
                       ("adaln_single.emb.timestep_embedder.linear_1", cfg.time_embed_dim, d),
                       ("adaln_single.emb.timestep_embedder.linear_2", d, d),
                       ("adaln_single.linear", d, 6 * d), ("proj_out", d, out_dim)):
        _rlin(rng, sd, name, i, o)
    for pre, cross in blocks:
        for i in range(cfg.depth):
            b = f"{pre}.{i}"
            sd[f"{b}.scale_shift_table"] = rng.normal(0, .02, (6, d)).astype("f4")
            for a in ("attn1", "attn2") if cross else ("attn1",):
                for n in ("to_q", "to_k", "to_v", "to_out.0"):
                    _rlin(rng, sd, f"{b}.{a}.{n}", d, d)
            _rlin(rng, sd, f"{b}.ff.net.0.proj", d, mlp_d)
            _rlin(rng, sd, f"{b}.ff.net.2", mlp_d, d)
    return sd


def _vchitect_sd(cfg, rng):
    d, mlp_d = cfg.hidden, cfg.mlp_ratio * cfg.hidden
    sd = {"pos_embed.proj.weight": rng.normal(
        0, .05, (d, cfg.in_channels, cfg.patch, cfg.patch)).astype("f4"),
        "pos_embed.proj.bias": rng.normal(0, .01, (d,)).astype("f4")}
    for name, i, o in (("context_embedder", cfg.text_dim, d),
                       ("time_text_embed.timestep_embedder.linear_1", cfg.time_embed_dim, d),
                       ("time_text_embed.timestep_embedder.linear_2", d, d),
                       ("time_text_embed.text_embedder.linear_1", cfg.vec_dim, d),
                       ("time_text_embed.text_embedder.linear_2", d, d),
                       ("norm_out.linear", d, 2 * d),
                       ("proj_out", d, cfg.patch * cfg.patch * cfg.in_channels)):
        _rlin(rng, sd, name, i, o)
    for i in range(cfg.depth):
        b, last = f"transformer_blocks.{i}", i == cfg.depth - 1
        _rlin(rng, sd, f"{b}.norm1.linear", d, 6 * d)
        _rlin(rng, sd, f"{b}.norm1_context.linear", d, 2 * d if last else 6 * d)
        for n in ("to_q", "to_k", "to_v", "to_out.0", "to_q_temp", "to_k_temp", "to_v_temp",
                  "to_out_temporal", "to_q_cross", "to_out_context", "add_q_proj",
                  "add_k_proj", "add_v_proj", "to_add_out_temporal"):
            _rlin(rng, sd, f"{b}.attn.{n}", d, d)
        _rlin(rng, sd, f"{b}.ff.net.0.proj", d, mlp_d)
        _rlin(rng, sd, f"{b}.ff.net.2", mlp_d, d)
        if not last:
            _rlin(rng, sd, f"{b}.attn.to_add_out", d, d)
            _rlin(rng, sd, f"{b}.ff_context.net.0.proj", d, mlp_d)
            _rlin(rng, sd, f"{b}.ff_context.net.2", mlp_d, d)
    return sd


def _wan_i2v_sd(cfg, rng):
    sd = _wan_tiny_sd(cfg, rng)
    d = cfg.dim
    for i in range(cfg.layers):
        for nm in ("cross_attn.k_img", "cross_attn.v_img"):
            _rlin(rng, sd, f"blocks.{i}.{nm}", d, d)
        sd[f"blocks.{i}.cross_attn.norm_k_img.weight"] = rng.normal(1, .1, d).astype("f4")
    _rlin(rng, sd, "img_emb.proj.1", cfg.clip_dim, cfg.clip_dim)
    _rlin(rng, sd, "img_emb.proj.3", cfg.clip_dim, d)
    return sd


# ---- the DiT families --------------------------------------------------------

def _family(name, dtype):
    """(published sd, JAX tree, port converter's state dict, in-process state
    dict) of one family at ``dtype``."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name in ("wan", "wan-i2v"):
        from magcache_tpu.models.wan import WanConfig as J
        from magcache_tpu_torch.models.wan import WanConfig as T
        kw = dict(model_type="i2v", in_channels=36, clip_dim=32) if name == "wan-i2v" else {}
        jc, tc = J.tiny(dtype=dtype, **kw), T.tiny(dtype=dtype, **kw)
        sd = (_wan_i2v_sd if name == "wan-i2v" else _wan_tiny_sd)(jc, rng)
        return (sd, JC.convert_wan_state_dict(sd, jc),
                lambda s: TC.wan_params_from_numpy(P.convert_wan_state_dict(s, tc), tc),
                lambda t: TC.wan_params_from_numpy(t, tc))
    if name == "flux":
        from magcache_tpu.models.flux import FluxConfig as J
        from magcache_tpu_torch.models.flux import FluxConfig as T
        jc, tc = J.tiny(mlp_ratio=4, dtype=dtype), T.tiny(mlp_ratio=4, dtype=dtype)
        sd = _flux_tiny_sd(jc, rng)
        return (sd, JC.convert_flux_state_dict(sd, jc),
                lambda s: TC.flux_params_from_numpy(P.convert_flux_state_dict(s, tc), tc),
                lambda t: TC.flux_params_from_numpy(t, tc))
    if name == "hunyuan":
        from magcache_tpu.models.hunyuan import HunyuanConfig as J
        from magcache_tpu_torch.models.hunyuan import HunyuanConfig as T
        jc, tc = J.tiny(dtype=dtype), T.tiny(dtype=dtype)
        sd = _hunyuan_sd(jc, rng)
        return (sd, JC.convert_hunyuan_state_dict(sd, jc),
                lambda s: TC.hunyuan_params_from_numpy(P.convert_hunyuan_state_dict(s, tc), tc),
                lambda t: TC.hunyuan_params_from_numpy(t, tc))
    if name == "qwen-image":
        from magcache_tpu.models.qwen_image import QwenImageConfig as J
        from magcache_tpu_torch.models.qwen_image import QwenImageConfig as T
        jc, tc = J.tiny(dtype=dtype), T.tiny(dtype=dtype)
        sd = _qwen_image_sd(jc, rng)
        return (sd, JC.convert_qwen_image_state_dict(sd, jc),
                lambda s: TC.qwen_image_params_from_numpy(
                    P.convert_qwen_image_state_dict(s, tc), tc),
                lambda t: TC.qwen_image_params_from_numpy(t, tc))
    if name == "cogvideox":
        from magcache_tpu.models.cogvideox import CogVideoXConfig as J
        from magcache_tpu_torch.models.cogvideox import CogVideoXConfig as T
        kw = dict(temb_dim=16, time_embed_dim=96, dtype=dtype)
        jc, tc = J.tiny(**kw), T.tiny(**kw)
        sd = _cogvideox_sd(jc, rng)
        return (sd, JC.convert_cogvideox_state_dict(sd, jc),
                lambda s: TC.cogvideox_params_from_numpy(
                    P.convert_cogvideox_state_dict(s, tc), tc),
                lambda t: TC.cogvideox_params_from_numpy(t, tc))
    if name == "stdit3":
        from magcache_tpu.models.stdit3 import STDiT3Config as J
        from magcache_tpu_torch.models.stdit3 import STDiT3Config as T
        jc, tc = J.tiny(dtype=dtype), T.tiny(dtype=dtype)
        sd = _stdit3_sd(jc, rng)
        return (sd, JC.convert_stdit3_state_dict(sd, jc),
                lambda s: TC.stdit3_params_from_numpy(P.convert_stdit3_state_dict(s, tc), tc),
                lambda t: TC.stdit3_params_from_numpy(t, tc))
    if name == "latte":
        from magcache_tpu.models.latte import LatteConfig as J
        from magcache_tpu_torch.models.latte import LatteConfig as T
        jc, tc = J.tiny(out_channels=8, dtype=dtype), T.tiny(out_channels=8, dtype=dtype)
        sd = _pixart_sd(jc, rng, (("transformer_blocks", True),
                                  ("temporal_transformer_blocks", False)),
                        (jc.patch, jc.patch), jc.patch * jc.patch * jc.c_out)
        return (sd, JC.convert_latte_state_dict(sd, jc),
                lambda s: TC.latte_params_from_numpy(P.convert_latte_state_dict(s, tc), tc),
                lambda t: TC.latte_params_from_numpy(t, tc))
    if name == "osp":
        from magcache_tpu.models.open_sora_plan import OpenSoraPlanConfig as J
        from magcache_tpu_torch.models.open_sora_plan import OpenSoraPlanConfig as T
        jc, tc = J.tiny(out_channels=8, dtype=dtype), T.tiny(out_channels=8, dtype=dtype)
        pt, ph, pw = jc.patch
        sd = _pixart_sd(jc, rng, (("transformer_blocks", True),), (ph, pw),
                        pt * ph * pw * jc.c_out)
        return (sd, JC.convert_osp_state_dict(sd, jc),
                lambda s: TC.osp_params_from_numpy(P.convert_osp_state_dict(s, tc), tc),
                lambda t: TC.osp_params_from_numpy(t, tc))
    if name == "vchitect":
        from magcache_tpu.models.vchitect import VchitectConfig as J
        from magcache_tpu_torch.models.vchitect import VchitectConfig as T
        jc, tc = J.tiny(dtype=dtype), T.tiny(dtype=dtype)
        sd = _vchitect_sd(jc, rng)
        return (sd, JC.convert_vchitect_state_dict(sd, jc),
                lambda s: TC.vchitect_params_from_numpy(
                    P.convert_vchitect_state_dict(s, tc), tc),
                lambda t: TC.vchitect_params_from_numpy(t, tc))
    if name == "omnigen2":
        from magcache_tpu.models.omnigen2 import OmniGen2Config as J
        from magcache_tpu_torch.models.omnigen2 import OmniGen2Config as T
        jc, tc = J.tiny(dtype=dtype), T.tiny(dtype=dtype)
        sd = make_omnigen2_sd(jc, seed=int(rng.integers(100)))
        return (sd, JC.convert_omnigen2_state_dict(sd, jc),
                lambda s: TC.omnigen2_params_from_numpy(
                    P.convert_omnigen2_state_dict(s, tc), tc),
                lambda t: TC.omnigen2_params_from_numpy(t, tc))
    raise AssertionError(name)


FAMILIES = ("wan", "wan-i2v", "flux", "hunyuan", "qwen-image", "cogvideox", "stdit3",
            "latte", "osp", "vchitect", "omnigen2")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_dit_converter_bit_equal_to_jax(family, dtype):
    sd, jtree, port, inproc = _family(family, dtype)
    got = port(_torch_sd(sd))
    assert_state_dicts_equal(got, inproc(_np_tree(jtree)))
    # a missing key raises, as in JAX
    drop = dict(_torch_sd(sd))
    drop.pop(sorted(k for k in drop if k.endswith(".weight") and drop[k].ndim == 2)[-1])
    with pytest.raises(KeyError):
        port(drop)


def test_converters_keep_stored_bf16_without_copies():
    """A BF16 checkpoint converts to a bf16 model with every block weight a
    view of the file's tensor (no f32 host copy), and to an f32 model
    exactly (bf16 -> f32 is exact)."""
    from magcache_tpu.models.wan import WanConfig as J
    from magcache_tpu_torch.models.wan import WanConfig as T

    sd = _torch_sd(_wan_tiny_sd(J.tiny(), np.random.default_rng(3)))
    sd = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    tree = P.convert_wan_state_dict(sd, T.tiny(dtype="bfloat16"))
    w = tree["blocks"]["q"]["w"][0]
    assert w.untyped_storage().data_ptr() == sd["blocks.0.self_attn.q.weight"] \
        .untyped_storage().data_ptr()
    got = TC.wan_params_from_numpy(P.convert_wan_state_dict(sd, T.tiny()), T.tiny())
    want = TC.wan_params_from_numpy(
        _np_tree(JC.convert_wan_state_dict({k: v.float().numpy() for k, v in sd.items()},
                                           J.tiny())), T.tiny())
    assert_state_dicts_equal(got, want)


def test_framepack_and_vace_layouts_refuse():
    from magcache_tpu_torch.models.hunyuan import HunyuanConfig
    from magcache_tpu_torch.models.wan import WanConfig

    with pytest.raises(NotImplementedError, match="FramePack"):
        P.convert_hunyuan_state_dict({}, HunyuanConfig.tiny(framepack=True))
    with pytest.raises(NotImplementedError, match="VACE"):
        P.convert_wan_state_dict({}, WanConfig.tiny(vace_layers=(0,)))


def test_omnigen2_sniffed_and_json_config_equal_jax(tmp_path):
    from magcache_tpu.models.omnigen2 import OmniGen2Config as J
    from magcache_tpu_torch.models.omnigen2 import OmniGen2Config as T

    kw = dict(hidden=72, heads=6, kv_heads=3, layers=3, refiner_layers=2, text_dim=40,
              time_embed_dim=16, temb_dim=24, in_channels=8, axes_dims=(4, 4, 4))
    sd = make_omnigen2_sd(J.tiny(**kw))
    j = {"hidden_size": 72, "num_attention_heads": 6, "num_kv_heads": 3, "num_layers": 3,
         "num_refiner_layers": 2, "in_channels": 8, "patch_size": 2, "text_feat_dim": 40,
         "axes_dim_rope": [4, 4, 4], "norm_eps": 1e-6, "ffn_dim_multiplier": 2.5}
    for got, want in ((P.sniff_omnigen2_config(_torch_sd(sd), patch=2),
                       JC.sniff_omnigen2_config(sd, patch=2)),
                      (P.omnigen2_config_from_json(j), JC.omnigen2_config_from_json(j))):
        assert dataclasses.asdict(got) == {k: v for k, v in dataclasses.asdict(want).items()
                                           if k != "remat"}
    save_safetensors(_torch_sd(sd), str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(j))
    tsd, tcfg = P.load_omnigen2_checkpoint(str(tmp_path))
    jtree, jcfg = JC.load_omnigen2_checkpoint(str(tmp_path))
    assert dataclasses.asdict(tcfg) == {k: v for k, v in dataclasses.asdict(jcfg).items()
                                        if k != "remat"}
    assert tcfg == T(**{**kw, "eps": 1e-6, "ffn_dim_override": tcfg.ffn_dim_override})
    assert_state_dicts_equal(tsd, TC.omnigen2_params_from_numpy(_np_tree(jtree), tcfg))


# ---- the readers -------------------------------------------------------------

def _hand_safetensors(path, tensors, meta=None):
    """A .safetensors file written without either library's writer."""
    names = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
             torch.int64: "I64"}
    header, blobs, off = {}, [], 0
    for k, v in tensors.items():
        raw = v.contiguous().view(torch.uint8).numpy().tobytes()
        header[k] = {"dtype": names[v.dtype], "shape": list(v.shape),
                     "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    if meta:
        header["__metadata__"] = meta
    h = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h + b"".join(blobs))


@pytest.mark.parametrize("writer", ["hand", "safetensors.torch", "save_safetensors"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_read_safetensors_dtypes(tmp_path, writer, dtype):
    import ml_dtypes  # noqa: F401  (numpy learns bfloat16 for JAX's reader)

    g = torch.Generator().manual_seed(1)
    tensors = {"a.weight": torch.randn(5, 3, generator=g).to(dtype),
               "b": torch.randn(7, generator=g).to(dtype),
               "steps": torch.arange(4, dtype=torch.int64)}
    path = str(tmp_path / "m.safetensors")
    if writer == "hand":
        _hand_safetensors(path, tensors, {"format": "pt"})
    elif writer == "safetensors.torch":
        from safetensors.torch import save_file
        save_file(tensors, path, metadata={"format": "pt"})
    else:
        save_safetensors(tensors, path, {"format": "pt"})
    got = read_safetensors(path)
    assert got.keys() == tensors.keys()
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    want = JC.load_safetensors_dir(str(tmp_path))
    for k, v in load_safetensors_dir(str(tmp_path)).items():
        np.testing.assert_array_equal(v.double().numpy(), np.asarray(want[k], np.float64))


def test_sharded_directory_merges(tmp_path):
    g = torch.Generator().manual_seed(2)
    full = {f"blocks.{i}.w": torch.randn(4, 4, generator=g).to(torch.bfloat16)
            for i in range(4)}
    keys = sorted(full)
    save_safetensors({k: full[k] for k in keys[:2]},
                     str(tmp_path / "diffusion_pytorch_model-00001-of-00002.safetensors"))
    save_safetensors({k: full[k] for k in keys[2:]},
                     str(tmp_path / "diffusion_pytorch_model-00002-of-00002.safetensors"))
    torch.save({"x": torch.ones(1)}, tmp_path / "models_t5_umt5-xxl-enc-bf16.pth")
    got = load_safetensors_dir(str(tmp_path))
    assert got.keys() == full.keys()
    assert all(torch.equal(got[k], full[k]) for k in keys)


def test_truncated_and_bad_files_raise(tmp_path):
    path = tmp_path / "m.safetensors"
    save_safetensors({"w": torch.ones(64)}, str(path))
    raw = path.read_bytes()
    for cut, match in ((len(raw) - 4, "truncated"), (20, "past the end"), (3, "too short")):
        (tmp_path / "cut.safetensors").write_bytes(raw[:cut])
        with pytest.raises(ValueError, match=match):
            read_safetensors(str(tmp_path / "cut.safetensors"))
    with pytest.raises(FileNotFoundError):
        load_safetensors_dir(str(tmp_path / "empty"))


def test_torch_files_unwrap_filter_and_flag_duplicates(tmp_path):
    """The cases of tests/test_convert.py's torch-file tests, through the
    port's reader, which keeps bf16 as bf16."""
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    torch.save({"module": {"a.weight": w.to(torch.bfloat16), "int_buffer": torch.tensor(3)}},
               tmp_path / "mp_rank_00_model_states.pt")
    sd = load_safetensors_dir(str(tmp_path))
    assert sd["a.weight"].dtype == torch.bfloat16 and torch.equal(sd["a.weight"].float(), w)
    assert "int_buffer" in sd
    save_safetensors({"b.weight": torch.ones(2, 2)}, str(tmp_path / "model.safetensors"))
    assert set(load_safetensors_dir(str(tmp_path))) == {"b.weight"}
    torch.save({"state_dict": {"c.weight": w}}, tmp_path / "vae.pth")
    assert torch.equal(load_safetensors_dir(str(tmp_path / "vae.pth"))["c.weight"], w)
    assert torch.equal(torch_load_flat(str(tmp_path / "vae.pth"))["c.weight"], w)

    d = tmp_path / "wan"
    d.mkdir()
    one = torch.ones(2, 2)
    for name, key in (("model.pth", "dit.weight"),
                      ("models_t5_umt5-xxl-enc-bf16.pth", "token_embedding.weight"),
                      ("Wan2.1_VAE.pth", "decoder.weight"),
                      ("models_clip_open-clip-xlm.pth", "visual.weight")):
        torch.save({key: one}, d / name)
    assert set(load_safetensors_dir(str(d))) == {"dit.weight"}
    assert set(JC.load_safetensors_dir(str(d))) == {"dit.weight"}
    d2 = tmp_path / "dup"
    d2.mkdir()
    torch.save({"x.weight": one}, d2 / "part_a.pth")
    torch.save({"x.weight": one * 5}, d2 / "part_b.pth")
    with pytest.raises(ValueError, match="duplicate keys"):
        load_safetensors_dir(str(d2))
