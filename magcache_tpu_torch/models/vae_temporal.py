"""Open-Sora 1.2's temporal VAE (``VAE_Temporal``, a MAGVIT-style causal 3-D
VAE that compresses time only) as PyTorch modules: the port of
``magcache_tpu.models.vae_temporal``, encoder and decoder.

Reference ``videosys/models/autoencoders/autoencoder_kl_open_sora.py``
(``VAE_Temporal`` :379, ``VAE_Temporal_SD`` :474: filters 128, mults (1, 2,
2, 4), 4 ResNet blocks a level, temporal downsample (False, True, True),
GroupNorm(32), SiLU, bias-free ResNet convs). Module names follow it
(``encoder.block_res_blocks.i.j.conv1.conv``, ``decoder.conv_blocks.i``,
``quant_conv.conv`` ...); levels without a time stride hold an
``nn.Identity`` in ``conv_blocks``, so the indices are the reference's.

The causal conv here zero-pads the front of the time axis by ``(kt - 1) +
(1 - stride_t)`` frames (one frame fewer for the stride-2 down conv) and
space symmetrically; it is not ``models.vae.causal_conv3d``, which
replicates the first frame. ``encode`` front-pads the clip with zero frames
to a multiple of ``time_factor``; ``decode`` turns channels into time at
each up level (frame ``2t + s`` from channel ``2c + s``) and slices frames
off the front down to ``num_frames``.

``open_sora_vae`` builds Open-Sora 1.2's whole VAE: this stage behind the SD
spatial VAE in ``models.vae.MicroFrameVAE``, with the published scales.

NCDHW inside; ``[B, T, H, W, C]`` f32 at the API, as in JAX. The
convolutions are ``F.conv3d`` (cuDNN on a card); the JAX module reaches no
Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from magcache_tpu_torch.models.vae import (GroupNormAffine, MicroFrameVAE, group_norm,
                                           init_convs_)
from magcache_tpu_torch.models.vae_sd import OPEN_SORA_SPATIAL_VAE, SDVAE

__all__ = ["VAETemporalConfig", "VAETemporal", "open_sora_vae"]


@dataclasses.dataclass(frozen=True)
class VAETemporalConfig:
    in_out_channels: int = 4
    latent_embed_dim: int = 4
    embed_dim: int = 4
    filters: int = 128
    num_res_blocks: int = 4
    channel_multipliers: Tuple[int, ...] = (1, 2, 2, 4)
    temporal_downsample: Tuple[bool, ...] = (False, True, True)
    groups: int = 32

    @property
    def time_factor(self) -> int:
        return 2 ** sum(self.temporal_downsample)

    @staticmethod
    def tiny(**kw) -> "VAETemporalConfig":
        d = dict(filters=8, num_res_blocks=1, channel_multipliers=(1, 2),
                 temporal_downsample=(True,), groups=4)
        d.update(kw)
        return VAETemporalConfig(**d)


class CausalConv3d(nn.Module):
    """The reference's ``CausalConv3d``: zero time-front pad of ``(kt - 1) +
    (1 - stride_t)`` frames, symmetric zero pad in space."""

    def __init__(self, cin, cout, k=3, stride=(1, 1, 1), bias=True, device=None):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, k, stride=stride, bias=bias, device=device)

    def forward(self, x):
        kt, kh, kw = self.conv.kernel_size
        tp = (kt - 1) + (1 - self.conv.stride[0])
        return self.conv(F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2, tp, 0)))


class ResBlock(nn.Module):
    """GroupNorm, SiLU, causal 3x3x3 conv, twice (no biases), and a 1x1x1
    ``conv3`` shortcut where the channels change."""

    def __init__(self, cin, cout, groups, device):
        super().__init__()
        self.groups = groups
        self.norm1 = GroupNormAffine(cin, device)
        self.conv1 = CausalConv3d(cin, cout, bias=False, device=device)
        self.norm2 = GroupNormAffine(cout, device)
        self.conv2 = CausalConv3d(cout, cout, bias=False, device=device)
        self.conv3 = CausalConv3d(cin, cout, 1, bias=False, device=device) if cin != cout else None

    def forward(self, x):
        g = self.groups
        h = self.conv1(F.silu(group_norm(x, self.norm1.weight, self.norm1.bias, g)))
        h = self.conv2(F.silu(group_norm(h, self.norm2.weight, self.norm2.bias, g)))
        if self.conv3 is not None:
            x = self.conv3(x)
        return x + h


class Encoder(nn.Module):
    def __init__(self, cfg: VAETemporalConfig, device):
        super().__init__()
        nb, f0, g = len(cfg.channel_multipliers), cfg.filters, cfg.groups
        self.groups = g
        self.conv_in = CausalConv3d(cfg.in_out_channels, f0, bias=False, device=device)
        self.block_res_blocks, self.conv_blocks = nn.ModuleList(), nn.ModuleList()
        c = f0
        for i, m in enumerate(cfg.channel_multipliers):
            f = f0 * m
            self.block_res_blocks.append(nn.ModuleList(
                ResBlock(c if j == 0 else f, f, g, device) for j in range(cfg.num_res_blocks)))
            c = f
            if i < nb - 1:
                self.conv_blocks.append(
                    CausalConv3d(c, f, stride=(2, 1, 1), device=device)
                    if cfg.temporal_downsample[i] else nn.Identity())
        self.res_blocks = nn.ModuleList(ResBlock(c, c, g, device)
                                        for _ in range(cfg.num_res_blocks))
        self.norm1 = GroupNormAffine(c, device)
        self.conv2 = CausalConv3d(c, 2 * cfg.latent_embed_dim, 1, device=device)

    def forward(self, x):
        h = self.conv_in(x)
        for i, blocks in enumerate(self.block_res_blocks):
            for blk in blocks:
                h = blk(h)
            if i < len(self.conv_blocks):
                h = self.conv_blocks[i](h)
        for blk in self.res_blocks:
            h = blk(h)
        return self.conv2(F.silu(group_norm(h, self.norm1.weight, self.norm1.bias,
                                            self.groups)))


def _depth_to_time(h: torch.Tensor) -> torch.Tensor:
    """``[B, 2C, T, H, W]`` -> ``[B, C, 2T, H, W]``: frame ``2t + s`` is
    channel ``2c + s`` of frame t (JAX's channel-last ``(C, 2)`` split, its
    minor 2 made the minor factor of time)."""
    b, c2, t, hh, ww = h.shape
    h = h.reshape(b, c2 // 2, 2, t, hh, ww).permute(0, 1, 3, 2, 4, 5)
    return h.reshape(b, c2 // 2, 2 * t, hh, ww)


class Decoder(nn.Module):
    def __init__(self, cfg: VAETemporalConfig, device):
        super().__init__()
        nb, f0, g = len(cfg.channel_multipliers), cfg.filters, cfg.groups
        self.groups = g
        c = f0 * cfg.channel_multipliers[-1]
        self.conv1 = CausalConv3d(cfg.latent_embed_dim, c, device=device)
        self.res_blocks = nn.ModuleList(ResBlock(c, c, g, device)
                                        for _ in range(cfg.num_res_blocks))
        levels, ups = [None] * nb, [None] * (nb - 1)
        for i in reversed(range(nb)):
            f = f0 * cfg.channel_multipliers[i]
            levels[i] = nn.ModuleList(ResBlock(c if j == 0 else f, f, g, device)
                                      for j in range(cfg.num_res_blocks))
            c = f
            if i > 0:
                ups[i - 1] = (CausalConv3d(c, 2 * c, device=device)
                              if cfg.temporal_downsample[i - 1] else nn.Identity())
        self.block_res_blocks = nn.ModuleList(levels)
        self.conv_blocks = nn.ModuleList(ups)
        self.norm1 = GroupNormAffine(c, device)
        self.conv_out = CausalConv3d(c, cfg.in_out_channels, device=device)

    def forward(self, z):
        h = self.conv1(z)
        for blk in self.res_blocks:
            h = blk(h)
        for i in reversed(range(len(self.block_res_blocks))):
            for blk in self.block_res_blocks[i]:
                h = blk(h)
            if i > 0 and isinstance(self.conv_blocks[i - 1], CausalConv3d):
                h = _depth_to_time(self.conv_blocks[i - 1](h))
        return self.conv_out(F.silu(group_norm(h, self.norm1.weight, self.norm1.bias,
                                               self.groups)))


class VAETemporal(nn.Module):
    """Latents of the spatial VAE ``[B, T, H, W, C]`` <-> temporal latents
    ``[B, ceil(T / time_factor), H, W, embed_dim]`` (no spatial stride), f32.
    Build on ``device``, then ``init(generator)`` for random weights or
    ``load_state_dict`` (``models/convert.py::vae_temporal_params_from_numpy``)."""

    # decode takes a num_frames hint and front-pads: a micro-frame chunk of
    # m frames is ceil(m / time_factor) latents (``MicroFrameVAE`` reads this)
    front_padded_latents = True

    def __init__(self, cfg: VAETemporalConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, device)
        self.decoder = Decoder(cfg, device)
        e, le = cfg.embed_dim, cfg.latent_embed_dim
        self.quant_conv = CausalConv3d(2 * le, 2 * e, 1, device=device)
        self.post_quant_conv = CausalConv3d(e, le, 1, device=device)

    def init(self, generator: torch.Generator) -> "VAETemporal":
        """Random weights from ``generator`` (on its device), drawn as
        ``init_vae_temporal_params`` draws them (the draws themselves differ):
        conv weights ``N(0, 1/fan_in)``, zero biases, unit and zero norms."""
        init_convs_(self, generator)
        return self

    @property
    def device(self) -> torch.device:
        return self.decoder.conv1.conv.weight.device

    @torch.inference_mode()
    def encode(self, x: torch.Tensor):
        """``[B, T, H, W, C]`` -> ``(mean, logvar)`` at ``ceil(T /
        time_factor)`` frames; the clip is front-padded with zero frames to a
        multiple of ``time_factor`` (ref :442-448)."""
        x = x.to(device=self.device, dtype=torch.float32).permute(0, 4, 1, 2, 3)
        tf = self.cfg.time_factor
        pad = (tf - x.shape[2] % tf) % tf
        if pad:
            x = F.pad(x, (0, 0, 0, 0, pad, 0))
        h = self.quant_conv(self.encoder(x)).permute(0, 2, 3, 4, 1)
        e = self.cfg.embed_dim
        return h[..., :e], h[..., e:]

    @torch.inference_mode()
    def decode(self, z: torch.Tensor, num_frames: Optional[int] = None) -> torch.Tensor:
        """``[B, T', H, W, embed_dim]`` -> ``[B, num_frames, H, W, C]`` (all
        ``time_factor * T'`` frames without ``num_frames``; the front ones are
        sliced off, ref :454-463)."""
        z = z.to(device=self.device, dtype=torch.float32).permute(0, 4, 1, 2, 3)
        h = self.decoder(self.post_quant_conv(z))
        if num_frames is not None:
            h = h[:, :, h.shape[2] - num_frames:]
        return h.permute(0, 2, 3, 4, 1)


def open_sora_vae(device=None) -> MicroFrameVAE:
    """Open-Sora 1.2's composite VAE at its published widths (JAX
    ``load_open_sora_vae``'s layout): ``SDVAE(OPEN_SORA_SPATIAL_VAE)`` and
    ``VAETemporal(VAETemporalConfig())`` in 17-frame chunks, with the
    published latent scales. ``.init(generator)`` gives random weights."""
    return MicroFrameVAE(SDVAE(OPEN_SORA_SPATIAL_VAE, device),
                         VAETemporal(VAETemporalConfig(), device), micro_frame_size=17)
