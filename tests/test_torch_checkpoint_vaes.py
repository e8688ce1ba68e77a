"""The port's VAE checkpoint loaders (the SD VAE, Open-Sora's temporal VAE
and composite, the Open-Sora-Plan CausalVAE and the CogVideoX VAE) against
the JAX package's converters, and ``--vae_ckpt``'s routing by task.

The SD and temporal VAEs' module names are the published ones, so a seeded
port model's state dict is their published layout; the OSP and CogVideoX
VAEs (the port keeps their decoders only) are written from the JAX
package's seeded trees under the published names. The JAX converter's tree
through the port's ``*_params_from_numpy`` and the port's loader must give
the same state dict bit for bit.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from magcache_tpu.models import vae_cogvideox as JCV
from magcache_tpu.models import vae_osp as JOV
from magcache_tpu.models import vae_sd as JSD
from magcache_tpu.models import vae_temporal as JTV
from magcache_tpu_torch.models import convert as TC
from magcache_tpu_torch.models import vae_cogvideox as TCV
from magcache_tpu_torch.models import vae_osp as TOV
from magcache_tpu_torch.models import vae_sd as TSD
from magcache_tpu_torch.models import vae_temporal as TTV
from magcache_tpu_torch.models.checkpoint import save_safetensors
from tests.test_torch_checkpoint import _np_tree, assert_state_dicts_equal


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _seeded(model, seed):
    return model.init(torch.Generator().manual_seed(seed)).state_dict()


def _save(path, sd):
    path.mkdir()
    save_safetensors({k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in sd.items()},
                     str(path / "diffusion_pytorch_model.safetensors"))
    return str(path)


def test_sd_vae_loader_bit_equal_to_jax(tmp_path):
    cfg = TSD.SDVAEConfig.tiny(quant_conv=True)
    seeded = _seeded(TSD.SDVAE(cfg, "cpu"), 1)
    path = _save(tmp_path / "vae", seeded)
    (tmp_path / "vae" / "config.json").write_text(json.dumps(
        {"scaling_factor": 0.3611, "shift_factor": 0.1159}))
    vae = TSD.load_sd_vae_checkpoint(path, device="cpu")
    jcfg, jtree = JSD.load_sd_vae_checkpoint(path)
    # GroupNorm's group count is not in the weights: it stays 32 (as in JAX)
    assert dataclasses.replace(vae.cfg, groups=cfg.groups) == dataclasses.replace(
        cfg, scaling_factor=0.3611, shift_factor=0.1159)
    assert vae.cfg.groups == jcfg.groups == 32
    assert (jcfg.z_channels, jcfg.base, jcfg.ch_mult, jcfg.blocks_per_level) == (
        cfg.z_channels, cfg.base, cfg.ch_mult, cfg.blocks_per_level)
    assert_state_dicts_equal(vae.state_dict(), TC.sd_vae_params_from_numpy(_np_tree(jtree), cfg))
    assert_state_dicts_equal(vae.state_dict(), seeded)


def test_open_sora_vae_loader_bit_equal_to_jax(tmp_path):
    """The published OpenSora-VAE-v1.2 layout (``spatial_vae.module.*`` +
    ``temporal_vae.*``) at a tiny temporal width through both loaders."""
    scfg, tcfg = TSD.SDVAEConfig.tiny(), TTV.VAETemporalConfig.tiny(latent_embed_dim=4)
    spatial = _seeded(TSD.SDVAE(scfg, "cpu"), 2)
    temporal = _seeded(TTV.VAETemporal(tcfg, "cpu"), 3)
    sd = {**{f"spatial_vae.module.{k}": v for k, v in spatial.items()},
          **{f"temporal_vae.{k}": v for k, v in temporal.items()}}
    path = _save(tmp_path / "osvae", sd)
    from dataclasses import fields

    jt = JTV.VAETemporalConfig(**{f.name: getattr(tcfg, f.name)
                                  for f in fields(JTV.VAETemporalConfig)})
    got = TTV.load_vae_temporal_checkpoint(path, tcfg, device="cpu")
    _, jtree = JTV.load_vae_temporal_checkpoint(path, jt)
    assert_state_dicts_equal(got.state_dict(),
                             TC.vae_temporal_params_from_numpy(_np_tree(jtree), tcfg))
    assert_state_dicts_equal(got.state_dict(), temporal)
    # the composite: its spatial half sniffed, the temporal half at the
    # published width (so the tiny temporal weights above do not fit it)
    with pytest.raises(KeyError, match="temporal_vae.encoder"):
        TTV.load_open_sora_vae(path, device="cpu")
    g = torch.Generator().manual_seed(4)
    full = {k: torch.randn(v.shape, generator=g) for k, v in
            TTV.VAETemporal(TTV.VAETemporalConfig(), "meta").state_dict().items()}
    sd = {**{f"spatial_vae.module.{k}": v for k, v in spatial.items()},
          **{f"temporal_vae.{k}": v for k, v in full.items()}}
    path = _save(tmp_path / "osvae_full", sd)
    vae = TTV.load_open_sora_vae(path, micro_frame_size=5, device="cpu")
    assert vae.micro_frame_size == 5 and vae.spatial.cfg.base == scfg.base
    assert_state_dicts_equal(vae.spatial.state_dict(), spatial)
    assert_state_dicts_equal(vae.temporal.state_dict(), full)


def _osp_published(tree):
    """A JAX OSP VAE tree under ``CausalVAEModel``'s names."""
    out = {}

    def walk(node, name):
        if node is None:
            return
        if isinstance(node, dict) and "w" in node:
            w = np.asarray(node["w"])
            if w.ndim == 5:                # a CausalConv3d (Down/Upsample wrap one)
                key = f"{name}.conv" + (".conv" if name.endswith("sample") else "")
                out[f"{key}.weight"] = w.transpose(4, 3, 0, 1, 2)
                if "b" in node:
                    out[f"{key}.bias"] = np.asarray(node["b"])
            else:
                out[f"{name}.weight"], out[f"{name}.bias"] = w, np.asarray(node["b"])
            return
        for k, v in (node.items() if isinstance(node, dict) else enumerate(node)):
            walk(v, f"{name}.{k}" if name else str(k))

    walk(tree, "")
    return out


def _cogvideox_published(tree, cfg):
    """A JAX CogVideoX VAE tree under diffusers' names."""
    out = {}

    def conv(name, p, bare=False):
        w = np.asarray(p["w"])
        perm = (4, 3, 0, 1, 2) if w.ndim == 5 else (3, 2, 0, 1)
        key = name if bare or w.ndim == 4 else f"{name}.conv"
        out[f"{key}.weight"], out[f"{key}.bias"] = w.transpose(perm), np.asarray(p["b"])

    def norm(name, p):
        if "norm" in p:               # the decoder's spatial norm
            norm(f"{name}.norm_layer", p["norm"])
            conv(f"{name}.conv_y", p["conv_y"])
            conv(f"{name}.conv_b", p["conv_b"])
        else:
            out[f"{name}.weight"], out[f"{name}.bias"] = (np.asarray(p["w"]),
                                                          np.asarray(p["b"]))

    def resnet(name, p):
        conv(f"{name}.conv1", p["conv1"])
        conv(f"{name}.conv2", p["conv2"])
        norm(f"{name}.norm1", p["norm1"])
        norm(f"{name}.norm2", p["norm2"])
        if "shortcut" in p:
            conv(f"{name}.conv_shortcut", p["shortcut"], bare=True)

    for side, blocks, key, sampler in (("encoder", "down", "down_blocks", "downsamplers"),
                                       ("decoder", "up", "up_blocks", "upsamplers")):
        t = tree[side]
        conv(f"{side}.conv_in", t["conv_in"])
        conv(f"{side}.conv_out", t["conv_out"])
        norm(f"{side}.norm_out", t["norm_out"])
        for j, p in enumerate(t["mid"]):
            resnet(f"{side}.mid_block.resnets.{j}", p)
        for i in range(len(cfg.block_out_channels)):
            lv = t[f"{blocks}{i}"]
            for j, p in enumerate(lv["resnets"]):
                resnet(f"{side}.{key}.{i}.resnets.{j}", p)
            if lv[blocks] is not None:
                conv(f"{side}.{key}.{i}.{sampler}.0.conv", lv[blocks])
    return out


def _random_tree(init, cfg, seed):
    """The JAX init's tree with numpy normal leaves (shapes only: no XLA
    compile)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg))
    return jax.tree.map(lambda a: rng.normal(0, .1, a.shape).astype(np.float32), shapes)


def test_osp_vae_loader_bit_equal_to_jax(tmp_path):
    jcfg = JOV.OSPVAEConfig.tiny()
    tcfg = TOV.OSPVAEConfig.tiny()
    pub = _osp_published(_random_tree(JOV.init_osp_vae_params, jcfg, 5))
    path = _save(tmp_path / "osp_vae", pub)
    got = TOV.load_osp_vae_checkpoint(path, tcfg, device="cpu")
    _, jtree = JOV.load_osp_vae_checkpoint(path, jcfg)
    assert_state_dicts_equal(got.state_dict(), TC.osp_vae_params_from_numpy(_np_tree(jtree),
                                                                             tcfg))
    pub.pop("encoder.conv_in.conv.weight")     # the encoder converts too: a key missing raises
    with pytest.raises(KeyError, match="encoder.conv_in"):
        TOV.convert_osp_vae_state_dict({k: torch.from_numpy(v) for k, v in pub.items()}, tcfg)


def test_cogvideox_vae_loader_bit_equal_to_jax(tmp_path):
    jcfg, tcfg = JCV.CogVideoXVAEConfig.tiny(), TCV.CogVideoXVAEConfig.tiny()
    pub = _cogvideox_published(_random_tree(JCV.init_cogvideox_vae_params, jcfg, 6), jcfg)
    path = _save(tmp_path / "cog_vae", pub)
    got = TCV.load_cogvideox_vae_checkpoint(path, tcfg, device="cpu")
    jtree = JCV.convert_cogvideox_vae_state_dict(pub, jcfg)
    assert_state_dicts_equal(got.state_dict(),
                             TC.cogvideox_vae_params_from_numpy(_np_tree(jtree), tcfg))


@pytest.mark.parametrize("task,loader", [("latte", "vae_sd.load_sd_vae_checkpoint"),
                                         ("cogvideox", "vae_cogvideox."
                                                       "load_cogvideox_vae_checkpoint"),
                                         ("open-sora-plan", "vae_osp.load_osp_vae_checkpoint"),
                                         ("open-sora", "vae_temporal.load_open_sora_vae"),
                                         ("qwen-image", "vae_wan.load_wan_vae_checkpoint")])
def test_cli_routes_vae_ckpt_by_task(monkeypatch, task, loader):
    """``--vae_ckpt`` reaches each family's loader (the JAX CLI's routing;
    Open-Sora-Plan with its version's VAE config), and its result fills the
    pipeline's slot; ``--vae_dtype`` is the Wan VAE's only."""
    import importlib

    from magcache_tpu_torch.cli import generate as G

    module, name = loader.rsplit(".", 1)
    mod = importlib.import_module(f"magcache_tpu_torch.models.{module}")
    seen = []
    monkeypatch.setattr(mod, name, lambda path, *a, **kw: seen.append((path, a, kw)) or "vae")

    class Pipe:
        vae, device = None, torch.device("cpu")

        class config:
            @staticmethod
            def vae_config():
                return "osp-config"

    args = G.build_parser().parse_args(["--task", task, "--vae_ckpt", "v.safetensors"])
    pipe = Pipe()
    G._attach_vae(args, pipe)
    assert pipe.vae == "vae" and seen[0][0] == "v.safetensors"
    if task == "open-sora-plan":
        assert seen[0][1][0] == "osp-config"
    if task != "qwen-image":
        args.vae_dtype = "bfloat16"
        with pytest.raises(SystemExit, match="f32 only"):
            G._attach_vae(args, pipe)
