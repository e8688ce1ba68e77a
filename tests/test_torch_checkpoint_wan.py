"""The Wan checkpoint path of the port against the JAX package: the UMT5 and
T5 encoders' and the Wan VAE's converters and loaders, ``chip_smoke.py``'s
maps from the port's names back to the published ones, and
``cli.generate --task t2v-1.3B --ckpt_dir D --vae_ckpt ...`` on a tiny
published-layout directory, bit-equal to the in-process pipeline built from
the JAX converters' trees."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import chip_smoke
from magcache_tpu.models import convert as JC
from magcache_tpu.models import umt5 as JU
from magcache_tpu.models import vae_wan as JW
from magcache_tpu_torch.models import convert as TC
from magcache_tpu_torch.models import published as P
from magcache_tpu_torch.models import t5 as TT
from magcache_tpu_torch.models import umt5 as TU
from magcache_tpu_torch.models import vae_wan as TW
from magcache_tpu_torch.models.checkpoint import save_safetensors
from tests.test_convert import _wan_tiny_sd
from tests.test_torch_checkpoint import _np_tree, _torch_sd, assert_state_dicts_equal

UMT5 = dict(vocab_size=128, d_model=24, d_kv=8, d_ff=40, layers=2, heads=3, rel_buckets=8)
# the pipeline's tiny VAE: the Wan strides (4, 8, 8) and 16 latent channels
VAE = dict(base=8, dim_mult=(1, 2, 2, 2), num_res_blocks=1, temporal_down=(False, True, True),
           z_channels=16)


def _umt5_sd(rng, wan_names: bool):
    c = UMT5
    inner = c["heads"] * c["d_kv"]

    def w(*shape):
        return rng.normal(0, .2, shape).astype("f4")

    if wan_names:
        sd = {"token_embedding.weight": w(c["vocab_size"], c["d_model"]),
              "norm.weight": w(c["d_model"])}
        pre, names = "blocks.{}.", ("norm1.weight", "attn.q.weight", "attn.k.weight",
                                    "attn.v.weight", "attn.o.weight",
                                    "pos_embedding.embedding.weight", "norm2.weight",
                                    "ffn.gate.0.weight", "ffn.fc1.weight", "ffn.fc2.weight")
    else:
        sd = {"shared.weight": w(c["vocab_size"], c["d_model"]),
              "encoder.final_layer_norm.weight": w(c["d_model"])}
        pre = "encoder.block.{}.layer."
        names = ("0.layer_norm.weight", "0.SelfAttention.q.weight", "0.SelfAttention.k.weight",
                 "0.SelfAttention.v.weight", "0.SelfAttention.o.weight",
                 "0.SelfAttention.relative_attention_bias.weight", "1.layer_norm.weight",
                 "1.DenseReluDense.wi_0.weight", "1.DenseReluDense.wi_1.weight",
                 "1.DenseReluDense.wo.weight")
    shapes = ((c["d_model"],), (inner, c["d_model"]), (inner, c["d_model"]),
              (inner, c["d_model"]), (c["d_model"], inner), (c["rel_buckets"], c["heads"]),
              (c["d_model"],), (c["d_ff"], c["d_model"]), (c["d_ff"], c["d_model"]),
              (c["d_model"], c["d_ff"]))
    for i in range(c["layers"]):
        for n, s in zip(names, shapes):
            sd[pre.format(i) + n] = w(*s)
    return sd


@pytest.mark.parametrize("wan_names", [True, False])
def test_umt5_converter_and_sniff_equal_jax(wan_names):
    sd = _umt5_sd(np.random.default_rng(5), wan_names)
    jcfg = JU.sniff_umt5_config(sd)
    tcfg = TU.sniff_umt5_config(_torch_sd(sd))
    assert dataclasses.asdict(tcfg) == {**{k: v for k, v in dataclasses.asdict(jcfg).items()
                                           if k in dataclasses.asdict(tcfg)},
                                        "per_layer_bias": True, "feed_forward": "gated-gelu"}
    assert tcfg == TU.UMT5Config(**UMT5)
    want = TC.umt5_params_from_numpy(_np_tree(JU.convert_umt5_state_dict(sd, jcfg)), tcfg)
    got = TC.umt5_params_from_numpy(TU.convert_umt5_state_dict(_torch_sd(sd), tcfg), tcfg)
    assert_state_dicts_equal(got, want)


def test_t5_encoder_converter_equal_jax(tmp_path):
    """An HF T5 (shared bias) checkpoint: ``convert_t5_encoder_state_dict``
    into ``t5_params_from_flax``, equal to JAX's converter's Flax tree; the
    routing by config.json and file names as ``make_t5_encoder``'s."""
    sd = _umt5_sd(np.random.default_rng(6), wan_names=False)
    for i in range(1, UMT5["layers"]):      # T5 keeps block 0's bias only
        sd.pop(f"encoder.block.{i}.layer.0.SelfAttention.relative_attention_bias.weight")
    sd["encoder.embed_tokens.weight"] = sd["shared.weight"]
    cfg = TT.t5_config_from_checkpoint(_torch_sd(sd), {"model_type": "t5", "num_layers": 2})
    assert cfg == TT.T5Config(**{k: v for k, v in UMT5.items()}, feed_forward="gated-gelu")
    want = TC.t5_params_from_flax(_np_tree(JC.convert_t5_encoder_state_dict(sd)), cfg)
    got = TC.t5_params_from_flax(TT.convert_t5_encoder_state_dict(_torch_sd(sd)), cfg)
    assert_state_dicts_equal(got, want)
    with pytest.raises(ValueError, match="num_heads"):
        TT.t5_config_from_checkpoint(_torch_sd(sd), {"num_heads": 7})
    save_safetensors(_torch_sd(sd), str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text('{"model_type": "mt5"}')
    assert not TT.is_umt5_checkpoint(str(tmp_path))
    c, model = TT.load_t5_encoder(str(tmp_path), device="cpu")
    assert c == cfg and not model.cfg.per_layer_bias
    wan = tmp_path / "wan"
    wan.mkdir()
    (wan / "config.json").write_text('{"model_type": "t2v"}')
    torch.save(_torch_sd(_umt5_sd(np.random.default_rng(7), True)),
               wan / "models_t5_umt5-xxl-enc-bf16.pth")
    save_safetensors({"patch_embedding.weight": torch.ones(1)},
                     str(wan / "diffusion_pytorch_model.safetensors"))
    assert TT.is_umt5_checkpoint(str(wan))
    c, model = TT.load_t5_encoder(str(wan), device="cpu")
    assert c == TU.UMT5Config(**UMT5) and model.cfg.per_layer_bias


def _port_vae(seed=3, **kw):
    cfg = TW.WanVAEConfig(**{**VAE, **kw})
    return TW.WanVAE(cfg, "cpu").init(torch.Generator().manual_seed(seed)), cfg


@pytest.mark.parametrize("patchify", [1, 2])
def test_wan_vae_converter_and_sniff_equal_jax(tmp_path, patchify):
    """The seeded port VAE under the published names (``chip_smoke``'s
    map): JAX's converter and sniffer and the port's give the same state
    dict and config, equal to the seeded one; the .pth loader too."""
    vae, cfg = _port_vae(patchify=patchify)
    pub = chip_smoke.wan_vae_published(vae.state_dict(), cfg)
    np_pub = {k: v.numpy() for k, v in pub.items()}
    jcfg = JW.sniff_wan_vae_config(np_pub)
    tcfg = TW.sniff_wan_vae_config(pub)
    assert tcfg == cfg
    assert {k: getattr(jcfg, k) for k in VAE} == {k: getattr(cfg, k) for k in VAE}
    want = TC.wan_vae_params_from_numpy(_np_tree(JW.convert_wan_vae_state_dict(np_pub, jcfg)),
                                        cfg)
    got = TC.wan_vae_params_from_numpy(TW.convert_wan_vae_state_dict(pub, cfg), cfg)
    assert_state_dicts_equal(got, want)
    assert_state_dicts_equal(got, vae.state_dict())
    torch.save({"state_dict": pub}, tmp_path / "Wan2.1_VAE.pth")
    loaded = TW.load_wan_vae_checkpoint(str(tmp_path / "Wan2.1_VAE.pth"), device="cpu",
                                        dtype="bfloat16")
    assert loaded.cfg == dataclasses.replace(cfg, dtype="bfloat16")
    assert_state_dicts_equal(loaded.state_dict(), TC.wan_vae_params_from_numpy(
        _np_tree(JW.convert_wan_vae_state_dict(np_pub, jcfg)), loaded.cfg))


def test_smoke_maps_invert_the_loaders():
    """``chip_smoke``'s published-name maps of the Wan DiT, UMT5 and
    OmniGen2, read back by the port's loaders (and JAX's converters), give
    the seeded state dicts."""
    from magcache_tpu_torch.models.omnigen2 import OmniGen2Config, OmniGen2Model
    from magcache_tpu_torch.models.wan import WanConfig, WanModel

    g = torch.Generator().manual_seed(4)
    cfg = WanConfig.tiny()
    model = WanModel(cfg, "cpu").init(g)
    pub = chip_smoke.wan_published(model.state_dict())
    assert_state_dicts_equal(TC.wan_params_from_numpy(P.convert_wan_state_dict(pub, cfg), cfg),
                             model.state_dict())
    from magcache_tpu.models.wan import WanConfig as JWan
    assert_state_dicts_equal(TC.wan_params_from_numpy(_np_tree(JC.convert_wan_state_dict(
        {k: v.numpy() for k, v in pub.items()}, JWan.tiny())), cfg), model.state_dict())

    ucfg = TU.UMT5Config(**UMT5)
    umodel = TU.UMT5Model(ucfg, "cpu").init(g)
    pub = chip_smoke.umt5_published(umodel.state_dict())
    assert_state_dicts_equal(TC.umt5_params_from_numpy(TU.convert_umt5_state_dict(pub, ucfg),
                                                       ucfg), umodel.state_dict())

    ocfg = OmniGen2Config.tiny()
    omodel = OmniGen2Model(ocfg, "cpu").init(g)
    pub = chip_smoke.omnigen2_published(omodel.state_dict(), ocfg)
    assert_state_dicts_equal(TC.omnigen2_params_from_numpy(
        P.convert_omnigen2_state_dict(pub, ocfg), ocfg), omodel.state_dict())
    sniffed = P.sniff_omnigen2_config(pub)
    assert sniffed.ffn_dim == ocfg.ffn_dim
    assert dataclasses.replace(sniffed, ffn_dim_override=None, eps=ocfg.eps) == ocfg


def _write_wan_dir(d, rng):
    """A tiny Wan ``ckpt_dir``: the DiT as two BF16 safetensors shards, the
    UMT5 as ``models_t5_umt5-xxl-enc-bf16.pth`` (wan names), the VAE as
    ``Wan2.1_VAE.pth``; returns the published dicts (numpy, as written)."""
    from magcache_tpu.models.wan import WanConfig as JWan

    dit = {k: torch.from_numpy(v).to(torch.bfloat16)
           for k, v in _wan_tiny_sd(JWan.tiny(), rng).items()}
    keys = sorted(dit)
    for n, part in enumerate((keys[:len(keys) // 2], keys[len(keys) // 2:])):
        save_safetensors({k: dit[k] for k in part},
                         str(d / f"diffusion_pytorch_model-0000{n + 1}-of-00002.safetensors"))
    umt5 = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in _umt5_sd(rng, True).items()}
    torch.save(umt5, d / "models_t5_umt5-xxl-enc-bf16.pth")
    vae, vcfg = _port_vae(seed=9)
    vae_pub = chip_smoke.wan_vae_published(vae.state_dict(), vcfg)
    torch.save(vae_pub, d / "Wan2.1_VAE.pth")
    as_np = lambda sd: {k: v.float().numpy() for k, v in sd.items()}   # noqa: E731
    return as_np(dit), as_np(umt5), as_np(vae_pub)


def test_cli_t2v_from_checkpoint_dir_bit_equal(tmp_path, capsys):
    """``cli.generate --task t2v-1.3B --tiny --device cpu --ckpt_dir D
    --vae_ckpt D/Wan2.1_VAE.pth``: latents bit-equal to the in-process
    pipeline of the JAX converters' trees, pixels finite."""
    from magcache_tpu.models.wan import WanConfig as JWan
    from magcache_tpu_torch.cli import generate as G
    from magcache_tpu_torch.models.text import FallbackHashTokenizer, T5Encoder
    from magcache_tpu_torch.models.wan import WanModel
    from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

    d = tmp_path / "Wan2.1-T2V-1.3B"
    d.mkdir()
    dit, umt5, vae_pub = _write_wan_dir(d, np.random.default_rng(11))
    out = tmp_path / "run"
    G.main(["--task", "t2v-1.3B", "--tiny", "--device", "cpu", "--ckpt_dir", str(d),
            "--vae_ckpt", str(d / "Wan2.1_VAE.pth"), "--sample_steps", "3", "--use_magcache",
            "--base_seed", "5", "--save_file", str(out)])
    printed = capsys.readouterr().out
    assert "hash tokenizer" in printed and "finite True" in printed
    got = np.load(str(out) + "_latents.npy")
    pixels = np.load(str(out) + "_pixels.npy")

    cfg = WanPipelineConfig(tiny=True, size=(64, 32), frame_num=9, sample_steps=3,
                            sample_shift=5.0, guide_scale=5.0, use_magcache=True)
    mcfg = cfg.model_config()
    model = WanModel(mcfg, "cpu")
    model.load_state_dict(TC.wan_params_from_numpy(_np_tree(JC.convert_wan_state_dict(
        dit, JWan.tiny(dtype=mcfg.dtype))), mcfg))
    ucfg = TU.UMT5Config(**UMT5)
    umodel = TU.UMT5Model(ucfg, "cpu")
    umodel.load_state_dict(TC.umt5_params_from_numpy(_np_tree(JU.convert_umt5_state_dict(
        umt5, JU.sniff_umt5_config(umt5))), ucfg))
    text = T5Encoder(ucfg, seq_len=mcfg.text_len, model=umodel,
                     tokenizer=FallbackHashTokenizer(ucfg.vocab_size))
    vcfg = TW.WanVAEConfig(**VAE)
    vae = TW.WanVAE(vcfg, "cpu")
    vae.load_state_dict(TC.wan_vae_params_from_numpy(_np_tree(JW.convert_wan_vae_state_dict(
        vae_pub, JW.sniff_wan_vae_config(vae_pub))), vcfg))
    want = WanPipeline(cfg, "cpu", model=model, text_encoder=text,
                       vae=vae).generate(G.build_parser().get_default("prompt"), seed=5)
    np.testing.assert_array_equal(got, want.latents.numpy())
    np.testing.assert_array_equal(pixels, want.video.numpy())
    assert pixels.shape == (1, 9, 32, 64, 3) and np.isfinite(pixels).all()


def test_cli_checkpoint_flags_refuse_where_they_do_not_apply(tmp_path):
    from magcache_tpu_torch.cli import generate as G

    with pytest.raises(SystemExit, match="no VAE slot"):
        G.main(["--task", "omnigen2", "--tiny", "--device", "cpu", "--sample_steps", "1",
                "--vae_ckpt", str(tmp_path / "vae.pth")])
    for flag in ("--transformer_lora_path", "--clip_ckpt", "--clip_text_ckpt2"):
        with pytest.raises(SystemExit, match="does not apply"):
            G.main(["--task", "t2v-1.3B", "--tiny", "--device", "cpu", flag, "x"])
    with pytest.raises(FileNotFoundError, match=os.path.basename(str(tmp_path))):
        G.main(["--task", "t2v-1.3B", "--tiny", "--device", "cpu", "--ckpt_dir",
                str(tmp_path)])
