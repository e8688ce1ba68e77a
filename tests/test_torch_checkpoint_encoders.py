"""The port's encoder converters (CLIP vision in the Wan and HF layouts,
CLIP text with and without its projection, Llama with and without q/k/v
biases, the Qwen2.5-VL vision tower) against the JAX package's, and the
encoders' checkpoint paths (an HF directory with ``config.json``, read
with the hash tokenizer).

Each published state dict is a seeded port model's under the published
names; the JAX converter's tree through the port's ``*_params_from_numpy``
and the port's converter must give the same state dict bit for bit, equal
to the seeded one.
"""

import dataclasses
import json

import pytest
import torch

from magcache_tpu.models import clip as JCL
from magcache_tpu.models import llama as JLL
from magcache_tpu.models import qwen_vl as JQV
from magcache_tpu_torch.models import clip as TCL
from magcache_tpu_torch.models import convert as TC
from magcache_tpu_torch.models import llama as TLL
from magcache_tpu_torch.models import qwen_vl as TQV
from magcache_tpu_torch.models import text as TT
from magcache_tpu_torch.models.checkpoint import save_safetensors
from tests.test_torch_checkpoint import _np_tree, assert_state_dicts_equal


def _jax_cfg(cls, cfg):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in names})


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _split_qkv(out, pre, w_or_b, v):
    for n, part in zip("qkv", v.chunk(3, 0)):
        out[f"{pre}.{n}_proj.{w_or_b}"] = part


def _hf_blocks(sd, layers, out):
    for i in range(layers):
        b, h = f"blocks.{i}", f"encoder.layers.{i}"
        for leaf in ("weight", "bias"):
            out[f"{h}.layer_norm1.{leaf}"] = sd[f"{b}.norm1.{leaf}"]
            out[f"{h}.layer_norm2.{leaf}"] = sd[f"{b}.norm2.{leaf}"]
            _split_qkv(out, f"{h}.self_attn", leaf, sd[f"{b}.qkv.{leaf}"])
            out[f"{h}.self_attn.out_proj.{leaf}"] = sd[f"{b}.proj.{leaf}"]
            out[f"{h}.mlp.fc1.{leaf}"] = sd[f"{b}.mlp1.{leaf}"]
            out[f"{h}.mlp.fc2.{leaf}"] = sd[f"{b}.mlp2.{leaf}"]
    return out


def _clip_text_published(sd, cfg):
    out = {"embeddings.token_embedding.weight": sd["tok"],
           "embeddings.position_embedding.weight": sd["pos"],
           "final_layer_norm.weight": sd["final_norm.weight"],
           "final_layer_norm.bias": sd["final_norm.bias"]}
    out = {f"text_model.{k}": v for k, v in _hf_blocks(sd, cfg.layers, out).items()}
    if "text_proj" in sd:
        out["text_projection.weight"] = sd["text_proj"].T.contiguous()
    return out


def _clip_vision_published(sd, cfg, hf):
    p, d = cfg.patch, cfg.dim
    pe = sd["patch_embed.weight"].reshape(d, 3, p, p)
    if hf:
        out = {"embeddings.patch_embedding.weight": pe, "embeddings.class_embedding": sd["cls"],
               "embeddings.position_embedding.weight": sd["pos"],
               "pre_layrnorm.weight": sd["pre_norm.weight"],
               "pre_layrnorm.bias": sd["pre_norm.bias"],
               "post_layernorm.weight": sd["post_norm.weight"],
               "post_layernorm.bias": sd["post_norm.bias"]}
        return {f"vision_model.{k}": v for k, v in _hf_blocks(sd, cfg.layers, out).items()}
    out = {"patch_embedding.weight": pe, "patch_embedding.bias": sd["patch_embed.bias"],
           "cls_embedding": sd["cls"].reshape(1, 1, d), "pos_embedding": sd["pos"][None]}
    for n in ("pre_norm", "post_norm"):
        for leaf in ("weight", "bias"):
            out[f"{n}.{leaf}"] = sd[f"{n}.{leaf}"]
    names = {"norm1": "norm1", "norm2": "norm2", "qkv": "attn.to_qkv", "proj": "attn.proj",
             "mlp1": "mlp.0", "mlp2": "mlp.2"}
    for i in range(cfg.layers):
        for ours, theirs in names.items():
            for leaf in ("weight", "bias"):
                out[f"transformer.{i}.{theirs}.{leaf}"] = sd[f"blocks.{i}.{ours}.{leaf}"]
    return {f"visual.{k}": v for k, v in out.items()}


def _llama_published(sd, cfg):
    out = {"model.embed_tokens.weight": sd["embed"], "model.norm.weight": sd["final_norm"]}
    names = {"in_norm": "input_layernorm", "post_norm": "post_attention_layernorm",
             "q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
             "o": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
             "down": "mlp.down_proj"}
    for k, v in sd.items():
        if k.startswith("blocks."):
            _, i, name, *leaf = k.split(".")
            out[f"model.layers.{i}.{names[name]}.{leaf[0] if leaf else 'weight'}"] = v
    return out


def _qwen_vl_published(sd, cfg):
    c = cfg
    out = {"visual.patch_embed.proj.weight": sd["patch.weight"].reshape(
        c.hidden, c.in_channels, c.temporal_patch_size, c.patch_size, c.patch_size),
        "visual.merger.ln_q.weight": sd["merger_ln"]}
    for leaf in ("weight", "bias"):
        out[f"visual.merger.mlp.0.{leaf}"] = sd[f"merger_fc1.{leaf}"]
        out[f"visual.merger.mlp.2.{leaf}"] = sd[f"merger_fc2.{leaf}"]
    names = {"qkv": "attn.qkv", "proj": "attn.proj", "gate": "mlp.gate_proj",
             "up": "mlp.up_proj", "down": "mlp.down_proj"}
    for i in range(c.depth):
        for n in ("norm1", "norm2"):
            out[f"visual.blocks.{i}.{n}.weight"] = sd[f"blocks.{i}.{n}"]
        for ours, theirs in names.items():
            for leaf in ("weight", "bias"):
                out[f"visual.blocks.{i}.{theirs}.{leaf}"] = sd[f"blocks.{i}.{ours}.{leaf}"]
    return out


def _seeded(model, seed):
    return model.init(torch.Generator().manual_seed(seed)).state_dict()


@pytest.mark.parametrize("projection", [None, 24])
def test_clip_text_converter_bit_equal_to_jax(projection):
    cfg = TCL.CLIPTextConfig.tiny(projection_dim=projection)
    seeded = _seeded(TCL.CLIPTextModel(cfg, "cpu"), 1)
    pub = _clip_text_published(seeded, cfg)
    jtree = JCL.convert_clip_text_state_dict(_np(pub), _jax_cfg(JCL.CLIPTextConfig, cfg))
    want = TC.clip_text_params_from_numpy(_np_tree(jtree), cfg)
    got = TC.clip_text_params_from_numpy(TCL.convert_clip_text_state_dict(pub, cfg), cfg)
    assert_state_dicts_equal(got, want)
    assert_state_dicts_equal(got, seeded)


@pytest.mark.parametrize("hf", [False, True])
def test_clip_vision_converter_bit_equal_to_jax(hf):
    cfg = TCL.CLIPVisionConfig(dim=32, layers=2, heads=4, image_size=28)
    seeded = _seeded(TCL.CLIPVisionModel(cfg, "cpu"), 2)
    pub = _clip_vision_published(seeded, cfg, hf)
    jconv = JCL.convert_hf_clip_vision_state_dict if hf else JCL.convert_clip_vision_state_dict
    tconv = TCL.convert_hf_clip_vision_state_dict if hf else TCL.convert_clip_vision_state_dict
    want = TC.clip_vision_params_from_numpy(
        _np_tree(jconv(_np(pub), _jax_cfg(JCL.CLIPVisionConfig, cfg))), cfg)
    assert_state_dicts_equal(TC.clip_vision_params_from_numpy(tconv(pub, cfg), cfg), want)
    if not hf:                 # the HF patch embedding has no bias: JAX zero-fills it
        assert_state_dicts_equal(want, seeded)


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_llama_converter_bit_equal_to_jax(qkv_bias):
    cfg = TLL.LlamaConfig.tiny(qkv_bias=qkv_bias)
    seeded = _seeded(TLL.LlamaModel(cfg, "cpu"), 3)
    pub = _llama_published(seeded, cfg)
    want = TC.llama_params_from_numpy(_np_tree(JLL.convert_llama_state_dict(
        _np(pub), _jax_cfg(JLL.LlamaConfig, cfg))), cfg)
    got = TC.llama_params_from_numpy(TLL.convert_llama_state_dict(pub, cfg), cfg)
    assert_state_dicts_equal(got, want)
    assert_state_dicts_equal(got, seeded)


def test_qwen_vl_vision_converter_bit_equal_to_jax():
    cfg = TQV.QwenVLVisionConfig.tiny()
    seeded = _seeded(TQV.QwenVLVisionTower(cfg, "cpu"), 4)
    pub = _qwen_vl_published(seeded, cfg)
    want = TC.qwen_vl_vision_params_from_numpy(_np_tree(JQV.convert_qwen_vl_vision_state_dict(
        _np(pub), _jax_cfg(JQV.QwenVLVisionConfig, cfg))), cfg)
    got = TC.qwen_vl_vision_params_from_numpy(TQV.convert_qwen_vl_vision_state_dict(pub, cfg),
                                              cfg)
    assert_state_dicts_equal(got, want)
    assert_state_dicts_equal(got, seeded)


def _write(d, sd, config):
    d.mkdir()
    save_safetensors(sd, str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps(config))
    return str(d)


def test_encoder_paths_load_the_checkpoint(tmp_path, capsys):
    """ClipTextEncoder, LlamaTextEncoder and QwenVLTextEncoder given a
    directory: the config from config.json, the weights bit-equal to the
    written ones, the hash tokenizer (with its warning)."""
    ccfg = TCL.CLIPTextConfig.tiny(projection_dim=24, eos_token_id=2)
    cmodel = TCL.CLIPTextModel(ccfg, "cpu").init(torch.Generator().manual_seed(5))
    path = _write(tmp_path / "clip", _clip_text_published(cmodel.state_dict(), ccfg), {
        "text_config": {"vocab_size": ccfg.vocab_size, "hidden_size": ccfg.dim,
                        "num_hidden_layers": ccfg.layers, "num_attention_heads": ccfg.heads,
                        "intermediate_size": ccfg.mlp_ratio * ccfg.dim,
                        "max_position_embeddings": ccfg.max_len, "eos_token_id": 2,
                        "hidden_act": "quick_gelu"}})
    enc = TT.ClipTextEncoder(path, device="cpu", project=True)
    assert enc.cfg == ccfg and "hash tokenizer" in capsys.readouterr().out
    assert_state_dicts_equal(enc.model.state_dict(), cmodel.state_dict())
    assert tuple(enc(["a cat"]).shape) == (1, 24)

    lcfg = TLL.LlamaConfig.tiny(qkv_bias=True, rope_theta=1e6, eps=1e-6)
    lmodel = TLL.LlamaModel(lcfg, "cpu").init(torch.Generator().manual_seed(6))
    hf_txt = {"vocab_size": lcfg.vocab_size, "hidden_size": lcfg.hidden,
              "num_hidden_layers": lcfg.layers, "num_attention_heads": lcfg.heads,
              "num_key_value_heads": lcfg.kv_heads, "intermediate_size": lcfg.intermediate,
              "rope_theta": 1e6, "rms_norm_eps": 1e-6, "model_type": "qwen2"}
    path = _write(tmp_path / "llama", _llama_published(lmodel.state_dict(), lcfg), hf_txt)
    enc = TT.LlamaTextEncoder(path, out_len=8, skip_layers=0, template=None, device="cpu")
    assert enc.cfg == lcfg
    assert_state_dicts_equal(enc.model.state_dict(), lmodel.state_dict())

    vcfg = TQV.QwenVLVisionConfig.tiny(out_hidden=lcfg.hidden)
    vmodel = TQV.QwenVLVisionTower(vcfg, "cpu").init(torch.Generator().manual_seed(7))
    sd = {**_llama_published(lmodel.state_dict(), lcfg),
          **_qwen_vl_published(vmodel.state_dict(), vcfg)}
    path = _write(tmp_path / "qwen_vl", sd, {
        "text_config": hf_txt, "image_token_id": 7,
        "vision_config": {"depth": vcfg.depth, "hidden_size": vcfg.hidden,
                          "num_heads": vcfg.heads, "intermediate_size": vcfg.intermediate,
                          "out_hidden_size": vcfg.out_hidden, "patch_size": vcfg.patch_size,
                          "temporal_patch_size": vcfg.temporal_patch_size,
                          "spatial_merge_size": vcfg.merge_size,
                          "window_size": vcfg.window_size,
                          "fullatt_block_indexes": list(vcfg.fullatt_indexes)}})
    enc = TT.QwenVLTextEncoder(path, out_len=8, device="cpu")
    assert enc.cfg == lcfg and enc.vision_cfg == vcfg and enc.image_token_id == 7
    assert_state_dicts_equal(enc.model.state_dict(), lmodel.state_dict())
    assert_state_dicts_equal(enc.vision_model.state_dict(), vmodel.state_dict())
