"""The SD-lineage image VAE (diffusers ``AutoencoderKL``) as PyTorch modules:
the port of ``magcache_tpu.models.vae_sd``, encoder and decoder.

The image and video families decode through this one architecture at
their published VAEs' settings: FLUX.1 and Kontext (16 latent channels, no
quant convs), Latte-1 (``sd-vae-ft``, 4 channels), Vchitect-XL (the SD3 VAE,
16 channels) and Open-Sora 1.2's spatial stage (4 channels). Structure:

- encoder: ``conv_in`` -> per level ``blocks_per_level`` ResNet blocks and,
  but on the last level, a stride-2 3x3 conv after a right/bottom-only pad
  -> mid block (ResNet, single-head attention over the H*W positions scaled
  by ``1/sqrt(C)``, ResNet) -> GroupNorm, SiLU, ``conv_out`` to ``2 z``
  (mean, logvar) [-> ``quant_conv``];
- decoder: [``post_quant_conv`` ->] ``conv_in`` -> mid block -> per level
  (deepest first) ``blocks_per_level + 1`` ResNet blocks and, but on the
  last, a nearest 2x repeat and a 3x3 conv -> GroupNorm, SiLU, ``conv_out``.

Module names follow diffusers' ``AutoencoderKL`` (``encoder.down_blocks.i.
resnets.j.conv1``, ``decoder.up_blocks.i.upsamplers.0.conv``,
``mid_block.attentions.0.to_q`` ...), so a diffusers state dict maps by
name; ``models.convert.sd_vae_params_from_numpy`` carries the JAX tree over.

NCHW inside (cuDNN's layout), channel-last at the API: pixels ``[B, H, W,
3]`` and latents ``[B, h, w, z]``, f32, as in JAX. ``decode`` also takes
video latents ``[B, T, h, w, z]``: frame by frame, in chunks of
``micro_batch`` frames (GroupNorm is per sample, so chunking changes
nothing). ``to_latent`` / ``from_latent`` apply and undo the VAE's shift
and scale. The mid attention is plain PyTorch (one [HW, C] matmul pair, as
in JAX: no Pallas kernel); the convolutions are ``F.conv2d`` (cuDNN on a
card).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from magcache_tpu_torch.models.vae import (GroupNormAffine, chunked_images, group_norm,
                                           init_convs_, tiled_decode)

__all__ = ["SDVAEConfig", "SDVAE", "FLUX_VAE", "SD_VAE_FT", "SD3_VAE",
           "OPEN_SORA_SPATIAL_VAE"]


@dataclasses.dataclass(frozen=True)
class SDVAEConfig:
    in_channels: int = 3
    z_channels: int = 4                 # 16 for FLUX/SD3-lineage
    base: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    blocks_per_level: int = 2
    groups: int = 32
    quant_conv: bool = True             # False for FLUX/SD3 checkpoints
    scaling_factor: float = 0.18215
    shift_factor: float = 0.0           # FLUX: 0.1159

    @property
    def chs(self):
        return [self.base * m for m in self.ch_mult]

    @property
    def spatial_down(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)

    @staticmethod
    def tiny(**kw) -> "SDVAEConfig":
        d = dict(base=8, ch_mult=(1, 2), blocks_per_level=1, z_channels=4, groups=4)
        d.update(kw)
        return SDVAEConfig(**d)


# The published VAEs, at the geometry of ``SDVAEConfig()``; the latent
# channels, quant convs, scale and shift come from each model's VAE
# config.json (none of them is in the repository):
# black-forest-labs/FLUX.1-dev vae/config.json (FLUX.1 t2i and Kontext)
FLUX_VAE = SDVAEConfig(z_channels=16, quant_conv=False, scaling_factor=0.3611,
                       shift_factor=0.1159)
# stabilityai/sd-vae-ft-mse config.json (Latte-1's vae)
SD_VAE_FT = SDVAEConfig(z_channels=4, quant_conv=True, scaling_factor=0.18215)
# stabilityai/stable-diffusion-3-medium-diffusers vae/config.json (Vchitect-XL)
SD3_VAE = SDVAEConfig(z_channels=16, quant_conv=False, scaling_factor=1.5305,
                      shift_factor=0.0609)
# Open-Sora opensora/models/vae/vae.py ``VideoAutoencoderKL`` (scaling_factor
# 0.18215; a diffusers AutoencoderKL with quant convs, 4 channels)
OPEN_SORA_SPATIAL_VAE = SDVAEConfig(z_channels=4, quant_conv=True, scaling_factor=0.18215)


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, device):
        super().__init__()
        self.groups = groups
        self.norm1 = GroupNormAffine(cin, device)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, device=device)
        self.norm2 = GroupNormAffine(cout, device)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, device=device)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1, device=device) if cin != cout else None

    def forward(self, x):
        g = self.groups
        h = self.conv1(F.silu(group_norm(x, self.norm1.weight, self.norm1.bias, g)))
        h = self.conv2(F.silu(group_norm(h, self.norm2.weight, self.norm2.bias, g)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """Single-head softmax attention over the H*W positions, scale
    ``1/sqrt(C)``, with ``nn.Linear`` projections and the residual."""

    def __init__(self, c: int, groups: int, device):
        super().__init__()
        self.groups = groups
        self.group_norm = GroupNormAffine(c, device)
        self.to_q, self.to_k, self.to_v = (nn.Linear(c, c, device=device) for _ in range(3))
        self.to_out = nn.ModuleList([nn.Linear(c, c, device=device)])

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = group_norm(x, self.group_norm.weight, self.group_norm.bias, self.groups)
        tokens = h.flatten(2).transpose(1, 2)                    # [B, HW, C]
        q, k, v = self.to_q(tokens), self.to_k(tokens), self.to_v(tokens)
        a = torch.softmax(torch.bmm(q, k.transpose(1, 2)) / math.sqrt(c), dim=-1)
        o = self.to_out[0](torch.bmm(a, v))
        return x + o.transpose(1, 2).reshape(b, c, hh, ww)


class MidBlock(nn.Module):
    def __init__(self, c: int, groups: int, device):
        super().__init__()
        self.resnets = nn.ModuleList(ResnetBlock2D(c, c, groups, device) for _ in range(2))
        self.attentions = nn.ModuleList([Attention(c, groups, device)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Downsample2D(nn.Module):
    """diffusers' ``Downsample2D``: pad right and bottom by one, then a
    stride-2 3x3 conv."""

    def __init__(self, c: int, device):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2, device=device)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample2D(nn.Module):
    """Nearest 2x, then a 3x3 conv."""

    def __init__(self, c: int, device):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1, device=device)

    def forward(self, x):
        return self.conv(x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))


class DownBlock(nn.Module):
    def __init__(self, cin: int, cout: int, cfg: SDVAEConfig, down: bool, device):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(cin if j == 0 else cout, cout, cfg.groups, device)
            for j in range(cfg.blocks_per_level))
        self.downsamplers = nn.ModuleList([Downsample2D(cout, device)]) if down else None

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        return self.downsamplers[0](x) if self.downsamplers is not None else x


class UpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, cfg: SDVAEConfig, up: bool, device):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(cin if j == 0 else cout, cout, cfg.groups, device)
            for j in range(cfg.blocks_per_level + 1))
        self.upsamplers = nn.ModuleList([Upsample2D(cout, device)]) if up else None

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        return self.upsamplers[0](x) if self.upsamplers is not None else x


class Encoder(nn.Module):
    def __init__(self, cfg: SDVAEConfig, device):
        super().__init__()
        chs, n = cfg.chs, len(cfg.chs)
        self.groups = cfg.groups
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1, device=device)
        self.down_blocks = nn.ModuleList(
            DownBlock(chs[max(i - 1, 0)], chs[i], cfg, i < n - 1, device) for i in range(n))
        self.mid_block = MidBlock(chs[-1], cfg.groups, device)
        self.conv_norm_out = GroupNormAffine(chs[-1], device)
        self.conv_out = nn.Conv2d(chs[-1], 2 * cfg.z_channels, 3, padding=1, device=device)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        h = self.mid_block(h)
        n = self.conv_norm_out
        return self.conv_out(F.silu(group_norm(h, n.weight, n.bias, self.groups)))


class Decoder(nn.Module):
    def __init__(self, cfg: SDVAEConfig, device):
        super().__init__()
        chs = cfg.chs[::-1]                       # deepest first
        self.groups = cfg.groups
        self.conv_in = nn.Conv2d(cfg.z_channels, chs[0], 3, padding=1, device=device)
        self.mid_block = MidBlock(chs[0], cfg.groups, device)
        self.up_blocks = nn.ModuleList(
            UpBlock(chs[max(i - 1, 0)], chs[i], cfg, i < len(chs) - 1, device)
            for i in range(len(chs)))
        self.conv_norm_out = GroupNormAffine(chs[-1], device)
        self.conv_out = nn.Conv2d(chs[-1], cfg.in_channels, 3, padding=1, device=device)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        n = self.conv_norm_out
        return self.conv_out(F.silu(group_norm(h, n.weight, n.bias, self.groups)))


class SDVAE(nn.Module):
    """Pixels ``[..., H, W, 3]`` <-> latents ``[..., H/s, W/s, z]`` (s =
    ``cfg.spatial_down``), f32, any leading dims (a batch, or a batch and
    frames), in chunks of ``micro_batch`` images. Build on ``device``, then
    ``init(generator)`` for random weights or ``load_state_dict``
    (``models/convert.py::sd_vae_params_from_numpy``)."""

    def __init__(self, cfg: SDVAEConfig, device=None, micro_batch: int = 8):
        super().__init__()
        self.cfg = cfg
        self.micro_batch = micro_batch
        self.encoder = Encoder(cfg, device)
        self.decoder = Decoder(cfg, device)
        if cfg.quant_conv:
            z = cfg.z_channels
            self.quant_conv = nn.Conv2d(2 * z, 2 * z, 1, device=device)
            self.post_quant_conv = nn.Conv2d(z, z, 1, device=device)
        else:
            self.quant_conv = self.post_quant_conv = None

    def init(self, generator: torch.Generator) -> "SDVAE":
        """Random weights from ``generator`` (on its device), drawn as
        ``init_sd_vae_params`` draws them (the draws themselves differ): conv
        weights ``N(0, 1/fan_in)``, attention linears ``N(0, 0.02^2)``, zero
        biases, unit and zero norms."""
        init_convs_(self, generator)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    m.weight.copy_(torch.randn(m.weight.shape, generator=generator,
                                               device=generator.device) * 0.02)
                    m.bias.zero_()
        return self

    @property
    def device(self) -> torch.device:
        return self.decoder.conv_in.weight.device

    def _chunked(self, fn, x: torch.Tensor) -> torch.Tensor:
        return chunked_images(fn, x, self.device, self.micro_batch)

    def _encode_nchw(self, x):
        h = self.encoder(x)
        return self.quant_conv(h) if self.quant_conv is not None else h

    def _decode_nchw(self, z):
        if self.post_quant_conv is not None:
            z = self.post_quant_conv(z)
        return self.decoder(z)

    @torch.inference_mode()
    def encode(self, x: torch.Tensor):
        """Pixels ``[..., H, W, 3]`` -> ``(mean, logvar)``, each ``[..., H/s,
        W/s, z]`` f32 (no sampling: the deterministic encode)."""
        h = self._chunked(self._encode_nchw, x)
        return h[..., :self.cfg.z_channels], h[..., self.cfg.z_channels:]

    def to_latent(self, mean):
        return (mean - self.cfg.shift_factor) * self.cfg.scaling_factor

    def from_latent(self, z):
        return z / self.cfg.scaling_factor + self.cfg.shift_factor

    @torch.inference_mode()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents ``[B, h, w, z]`` or video latents ``[B, T, h, w, z]`` ->
        pixels ``[..., s h, s w, 3]`` f32, one image a sample, in chunks of
        ``micro_batch`` images. The latents are the VAE's own (apply
        ``from_latent`` to a sampler's first)."""
        return self._chunked(self._decode_nchw, z)

    @torch.inference_mode()
    def decode_tiled(self, z: torch.Tensor, tile: int = 64, overlap: int = 8) -> torch.Tensor:
        """``decode`` of overlapping ``tile`` x ``tile`` latent tiles (steps
        of ``tile - overlap``), each weighted by a linear ramp over its first
        ``overlap * s`` pixel rows and columns where it has an upper or left
        neighbour, summed and divided by the summed weights (JAX
        ``SDVAE.decode_tiled``); a latent of at most one tile decodes
        whole."""
        return tiled_decode(self.decode, z, tile, overlap, self.cfg.spatial_down)


# ---- diffusers AutoencoderKL checkpoints ---------------------------------------

def convert_sd_vae_state_dict(sd: dict, cfg: SDVAEConfig) -> dict:
    """A diffusers ``AutoencoderKL`` state dict (``encoder.down_blocks.*``,
    ``decoder.up_blocks.*``) as the JAX SD VAE tree (convs HWIO as permuted
    views; the attention's linears, 1x1 convs in old exports, ``[out, in]``)."""
    from magcache_tpu_torch.models.checkpoint import vec

    def cv(name):
        return {"w": vec(sd, f"{name}.weight").permute(2, 3, 1, 0), "b": vec(sd, f"{name}.bias")}

    def nm(name):
        return {"w": vec(sd, f"{name}.weight"), "b": vec(sd, f"{name}.bias")}

    def res(base):
        p = {"norm1": nm(f"{base}.norm1"), "conv1": cv(f"{base}.conv1"),
             "norm2": nm(f"{base}.norm2"), "conv2": cv(f"{base}.conv2")}
        if f"{base}.conv_shortcut.weight" in sd:
            p["shortcut"] = cv(f"{base}.conv_shortcut")
        return p

    def attn_lin(name):
        w = vec(sd, f"{name}.weight")
        return {"w": w[:, :, 0, 0] if w.ndim == 4 else w, "b": vec(sd, f"{name}.bias")}

    def mid(base):
        a = f"{base}.attentions.0"
        return {"res1": res(f"{base}.resnets.0"), "res2": res(f"{base}.resnets.1"),
                "attn": {"norm": nm(f"{a}.group_norm"), "q": attn_lin(f"{a}.to_q"),
                         "k": attn_lin(f"{a}.to_k"), "v": attn_lin(f"{a}.to_v"),
                         "o": attn_lin(f"{a}.to_out.0")}}

    tree = {}
    for side, blocks, sampler, key, n in (
            ("encoder", "down_blocks", "downsamplers", "down", cfg.blocks_per_level),
            ("decoder", "up_blocks", "upsamplers", "up", cfg.blocks_per_level + 1)):
        t = {"conv_in": cv(f"{side}.conv_in"), "mid": mid(f"{side}.mid_block"),
             "norm_out": nm(f"{side}.conv_norm_out"), "conv_out": cv(f"{side}.conv_out")}
        for li in range(len(cfg.ch_mult)):
            b = f"{side}.{blocks}.{li}"
            t[f"level{li}"] = {"res": [res(f"{b}.resnets.{j}") for j in range(n)],
                               key: (cv(f"{b}.{sampler}.0.conv")
                                     if f"{b}.{sampler}.0.conv.weight" in sd else None)}
        tree[side] = t
    if cfg.quant_conv:
        tree["quant_conv"] = cv("quant_conv")
        tree["post_quant_conv"] = cv("post_quant_conv")
    return tree


def sniff_sd_vae_config(sd: dict) -> SDVAEConfig:
    """The ``SDVAEConfig`` of an ``AutoencoderKL`` state dict from its shapes
    (the JAX ``load_sd_vae_checkpoint``'s rule; scaling and shift stay at
    the defaults, as there)."""
    nlv = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("encoder.down_blocks."))
    base = int(sd["encoder.conv_in.weight"].shape[0])
    return SDVAEConfig(
        z_channels=int(sd["encoder.conv_out.weight"].shape[0]) // 2, base=base,
        ch_mult=tuple(int(sd[f"encoder.down_blocks.{i}.resnets.0.conv2.weight"].shape[0])
                      // base for i in range(nlv)),
        blocks_per_level=1 + max(int(k.split(".")[4]) for k in sd
                                 if k.startswith("encoder.down_blocks.0.resnets.")),
        quant_conv="quant_conv.weight" in sd)


def sd_vae_from_state_dict(sd: dict, cfg: Optional[SDVAEConfig] = None, device="cuda"
                           ) -> "SDVAE":
    """An ``SDVAE`` on ``device`` from an ``AutoencoderKL`` state dict
    (``cfg=None`` sniffs it)."""
    from magcache_tpu_torch.models.convert import sd_vae_params_from_numpy

    cfg = cfg or sniff_sd_vae_config(sd)
    vae = SDVAE(cfg, torch.device(device))
    vae.load_state_dict(sd_vae_params_from_numpy(convert_sd_vae_state_dict(sd, cfg), cfg,
                                                 device))
    return vae.requires_grad_(False)


def load_sd_vae_checkpoint(path: str, cfg: Optional[SDVAEConfig] = None, device="cuda"
                           ) -> "SDVAE":
    """An ``SDVAE`` from a diffusers ``vae/`` directory or file; with
    ``cfg=None`` the geometry is sniffed and a ``config.json`` beside the
    weights gives ``scaling_factor`` and ``shift_factor`` (FLUX's 0.3611
    and 0.1159; the JAX loader keeps the defaults)."""
    import json
    import os

    from magcache_tpu_torch.models.checkpoint import load_safetensors_dir

    sd = load_safetensors_dir(path)
    if cfg is None:
        cfg = sniff_sd_vae_config(sd)
        cj = os.path.join(path if os.path.isdir(path) else os.path.dirname(path), "config.json")
        if os.path.exists(cj):
            with open(cj) as f:
                j = json.load(f)
            cfg = dataclasses.replace(
                cfg, scaling_factor=float(j.get("scaling_factor", cfg.scaling_factor)),
                shift_factor=float(j.get("shift_factor") or 0.0))
    return sd_vae_from_state_dict(sd, cfg, device)
