"""Wan2.1's video VAE as PyTorch modules (``magcache_tpu.models.vae_wan``):
the decoder, and the encoder that Wan i2v, flf2v and VACE encode their
conditioning frames with; with ``patchify=2`` (``WAN22_VAE``) the Wan2.2 VAE
of TI2V-5B.

Architecture (base 96, mults (1, 2, 4, 4), 2 residual blocks per level,
z = 16; the encoder downsamples /8 in space and /4 in time, the decoder
upsamples back). The encoder: a causal 3x3x3 conv in; per level
``num_res_blocks`` residual blocks, then (but after the last level) a 3x3
conv of stride 2 over each frame after a zero pad of one row and column at
the bottom and right, and on a temporal transition a causal (3,1,1) time
conv of stride 2; the middle as the decoder's; an RMS norm -> SiLU ->
causal conv to 2z channels, and the 1x1x1 quant conv, whose output is the
(mean, logvar) pair. The decoder:
- post-quant 1x1x1 conv; a causal 3x3x3 conv in; middle: a residual block,
  single-head per-frame spatial attention (RMS norm, 1x1 qkv and projection
  convs, an f32 softmax over the frame's H*W tokens), a residual block;
- per level ``num_res_blocks + 1`` residual blocks (RMS norm -> SiLU ->
  causal conv, twice, plus a 1x1x1 shortcut when channels change), then an
  upsample: on a temporal transition a causal (3,1,1) time conv doubling the
  channels, read as twice the frames (the first latent frame stays one
  pixel frame: its leading duplicate is dropped, on the first chunk only
  when streaming); nearest x2 in space and a 3x3 conv halving the channels;
- head: RMS norm -> SiLU -> causal conv to 3 pixel channels.

``WanVAE.decode(z, latent_chunk=1)`` streams one latent frame a call with
the causal convs' carried time caches (equal to the whole-clip decode; the
only way 480p x 81 frames fits a card), or decodes whole.
``WanVAE.encode(x, pixel_chunk=4)`` streams the pixels as the official wan
VAE does: the first frame alone, then windows of 4 (a multiple of the time
stride keeps every strided conv's window phase), or encodes whole; the mean
is normalized with the configured latent statistics. Activations are
NCDHW inside (cuDNN's layout; ``models.vae``); latents ``[B, F, H, W, C]``
and pixels ``[B, F, H, W, 3]`` f32 at the API, as in JAX. In a bf16 config
the convs' weights and activations are bf16 and the norm statistics stay
f32 (JAX ``_cast_conv_params``); the attention's scores and softmax are f32
in either. Checkpoint loading is not ported;
``models.convert.wan_vae_params_from_numpy`` carries the JAX tree over.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from magcache_tpu_torch.models.common import DTYPES
from magcache_tpu_torch.models.vae import causal_conv3d, channel_rms_norm, init_convs_

__all__ = ["WanVAEConfig", "WanVAE", "WAN21_VAE", "WAN22_VAE"]


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    base: int = 96
    z_channels: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temporal_down: Tuple[bool, ...] = (False, True, True)   # per transition
    patchify: int = 1                   # 2: Wan2.2-VAE's pixel shuffle
    eps: float = 1e-6
    # latent normalization (z * std * scale + mean on decode; identity unset)
    latent_scale: float = 1.0
    latent_mean: Optional[Tuple[float, ...]] = None
    latent_std: Optional[Tuple[float, ...]] = None
    dtype: str = "float32"              # the convs' dtype; norms stay f32

    @staticmethod
    def tiny(**kw) -> "WanVAEConfig":
        d = dict(base=8, dim_mult=(1, 2), num_res_blocks=1, temporal_down=(True,),
                 z_channels=4)
        d.update(kw)
        return WanVAEConfig(**d)

    @property
    def pixel_channels(self) -> int:
        return 3 * self.patchify * self.patchify

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


WAN21_VAE = WanVAEConfig()
# the Wan2.2 VAE (TI2V-5B's latent space): a 2x2 pixel shuffle in front of the
# same backbone at base 160, 48 latent channels, stride (4, 16, 16). Its
# published per-channel latent statistics are not in this repository: the
# latents stay unnormalized, as in the JAX preset
WAN22_VAE = WanVAEConfig(base=160, z_channels=48, patchify=2)


def _patchify_pixels(x: torch.Tensor, p: int) -> torch.Tensor:
    """``[B, T, H, W, 3]`` -> ``[B, T, H/p, W/p, 3*p*p]`` (pixel unshuffle,
    channel order (c, dh, dw), JAX ``_patchify_pixels``)."""
    if p == 1:
        return x
    b, t, h, w, c = x.shape
    x = x.reshape(b, t, h // p, p, w // p, p, c)
    return x.permute(0, 1, 2, 4, 6, 3, 5).reshape(b, t, h // p, w // p, c * p * p)


def _unpatchify_pixels(x: torch.Tensor, p: int) -> torch.Tensor:
    """``[B, T, H, W, 3*p*p]`` -> ``[B, T, H*p, W*p, 3]`` (channel order
    (c, dh, dw), JAX ``_unpatchify_pixels``)."""
    if p == 1:
        return x
    b, t, h, w, cpp = x.shape
    x = x.reshape(b, t, h, w, cpp // (p * p), p, p)
    return x.permute(0, 1, 2, 5, 3, 6, 4).reshape(b, t, h * p, w * p, cpp // (p * p))


def _conv2d_frames(x: torch.Tensor, conv: nn.Conv2d, stride: int = 1,
                   asym_pad: bool = False) -> torch.Tensor:
    """A 2-D conv applied to every frame of ``x [B, C, T, H, W]`` (JAX
    ``_conv2d_frames``), as a 3-D conv with a one-frame kernel: zero 'same'
    padding, or with ``asym_pad`` one zero row and column at the bottom and
    right and no other padding (the encoder's stride-2 downsample)."""
    kh, kw = conv.weight.shape[2:]
    pad = (0, (kh - 1) // 2, (kw - 1) // 2)
    if asym_pad:
        x, pad = F.pad(x, (0, 1, 0, 1)), 0
    return F.conv3d(x, conv.weight.unsqueeze(2), conv.bias, stride=(1, stride, stride),
                    padding=pad)


def _conv3(cin, cout, k, dt, device) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, k, device=device, dtype=dt)


def _norm(c, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(c, device=device))


class ResBlock(nn.Module):
    def __init__(self, cin, cout, dt, device):
        super().__init__()
        self.norm1, self.norm2 = _norm(cin, device), _norm(cout, device)
        self.conv1 = _conv3(cin, cout, 3, dt, device)
        self.conv2 = _conv3(cout, cout, 3, dt, device)
        self.shortcut = _conv3(cin, cout, 1, dt, device) if cin != cout else None


class AttnBlock(nn.Module):
    def __init__(self, c, dt, device):
        super().__init__()
        self.norm = _norm(c, device)
        self.qkv = nn.Conv2d(c, 3 * c, 1, device=device, dtype=dt)
        self.proj = nn.Conv2d(c, c, 1, device=device, dtype=dt)


class UpLevel(nn.Module):
    def __init__(self, cin, cout, blocks, resample, time_conv, dt, device):
        super().__init__()
        self.blocks = nn.ModuleList(ResBlock(cin if j == 0 else cout, cout, dt, device)
                                    for j in range(blocks))
        self.resample = (nn.Conv2d(cout, cout // 2, 3, device=device, dtype=dt)
                         if resample else None)
        self.time_conv = (_conv3(cout, 2 * cout, (3, 1, 1), dt, device)
                          if time_conv else None)


class DownLevel(nn.Module):
    def __init__(self, cin, cout, blocks, resample, time_conv, dt, device):
        super().__init__()
        self.blocks = nn.ModuleList(ResBlock(cin if j == 0 else cout, cout, dt, device)
                                    for j in range(blocks))
        self.resample = (nn.Conv2d(cout, cout, 3, device=device, dtype=dt)
                         if resample else None)
        self.time_conv = (_conv3(cout, cout, (3, 1, 1), dt, device)
                          if time_conv else None)


class WanVAEEncoder(nn.Module):
    def __init__(self, cfg: WanVAEConfig, device=None):
        super().__init__()
        dt = cfg.torch_dtype
        dims = [cfg.base * m for m in cfg.dim_mult]
        self.conv1 = _conv3(cfg.pixel_channels, dims[0], 3, dt, device)
        levels, cin = [], dims[0]
        for i, cout in enumerate(dims):
            last = i == len(dims) - 1
            levels.append(DownLevel(cin, cout, cfg.num_res_blocks, not last,
                                    not last and cfg.temporal_down[i], dt, device))
            cin = cout
        self.levels = nn.ModuleList(levels)
        self.mid = nn.ModuleList(ResBlock(dims[-1], dims[-1], dt, device) for _ in range(2))
        self.mid_attn = AttnBlock(dims[-1], dt, device)
        self.head_norm = _norm(dims[-1], device)
        self.head = _conv3(dims[-1], 2 * cfg.z_channels, 3, dt, device)


class WanVAEDecoder(nn.Module):
    def __init__(self, cfg: WanVAEConfig, device=None):
        super().__init__()
        dt = cfg.torch_dtype
        rdims = [cfg.base * m for m in reversed(cfg.dim_mult)]
        tups = list(reversed(cfg.temporal_down))
        self.conv1 = _conv3(cfg.z_channels, rdims[0], 3, dt, device)
        self.mid = nn.ModuleList(ResBlock(rdims[0], rdims[0], dt, device) for _ in range(2))
        self.mid_attn = AttnBlock(rdims[0], dt, device)
        levels, cin = [], rdims[0]
        for i, cout in enumerate(rdims):
            last = i == len(rdims) - 1
            levels.append(UpLevel(cin, cout, cfg.num_res_blocks + 1, not last,
                                  not last and tups[i], dt, device))
            cin = cout // 2
        self.levels = nn.ModuleList(levels)
        self.head_norm = _norm(rdims[-1], device)
        self.head = _conv3(rdims[-1], cfg.pixel_channels, 3, dt, device)


class WanVAE(nn.Module):
    """Latents ``[B, F, H, W, z]`` -> pixels ``[B, 4(F-1)+1, 8H, 8W, 3]`` f32
    (``decode``), and pixels -> (mean, logvar) latents (``encode``). Build on
    ``device``, then ``init(generator)`` for random weights or
    ``load_state_dict`` (``models/convert.py``)."""

    def __init__(self, cfg: WanVAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.post_quant = _conv3(cfg.z_channels, cfg.z_channels, 1, cfg.torch_dtype, device)
        self.decoder = WanVAEDecoder(cfg, device)
        # after the decoder: init's draws for the decoder stay the same
        self.quant = _conv3(2 * cfg.z_channels, 2 * cfg.z_channels, 1, cfg.torch_dtype, device)
        self.encoder = WanVAEEncoder(cfg, device)

    def init(self, generator: torch.Generator) -> "WanVAE":
        """Random weights from ``generator`` (on its device), drawn as
        ``magcache_tpu.models.vae_wan.init_wan_vae_params`` draws them (the
        draws themselves differ): conv weights ``N(0, 1/fan_in)``, zero
        biases, unit norm gains."""
        init_convs_(self, generator)
        return self

    def _res(self, blk: ResBlock, x, tc=None, out=None):
        """Residual block; ``tc`` is this block's caches from the previous
        chunk and ``out`` collects the new ones (both None: no streaming)."""
        eps = self.cfg.eps
        tc = tc or {}
        h = F.silu(channel_rms_norm(x, blk.norm1, eps=eps))
        h, c1 = causal_conv3d(h, blk.conv1.weight, blk.conv1.bias, tcache=tc.get("c1"))
        h = F.silu(channel_rms_norm(h, blk.norm2, eps=eps))
        h, c2 = causal_conv3d(h, blk.conv2.weight, blk.conv2.bias, tcache=tc.get("c2"))
        if blk.shortcut is not None:
            x, _ = causal_conv3d(x, blk.shortcut.weight, blk.shortcut.bias)
        if out is not None:
            out.update(c1=c1, c2=c2)
        return x + h

    def _attn(self, blk: AttnBlock, x):
        """Single-head spatial self-attention within each frame, one frame
        at a time: f32 scores over the H*W tokens, f32 softmax and product
        with v, rounded back to x's dtype before the projection."""
        b, c, t, hh, ww = x.shape
        qkv = _conv2d_frames(channel_rms_norm(x, blk.norm, eps=self.cfg.eps), blk.qkv)
        tokens = qkv.permute(0, 2, 3, 4, 1).reshape(b * t, hh * ww, 3 * c)
        a = torch.empty((b * t, hh * ww, c), dtype=x.dtype, device=x.device)
        for f in range(b * t):
            q, k, v = tokens[f].float().split(c, dim=-1)
            p = torch.softmax((q @ k.T) / math.sqrt(c), dim=-1)
            a[f] = (p @ v).to(x.dtype)
        a = a.reshape(b, t, hh, ww, c).permute(0, 4, 1, 2, 3)
        return x + _conv2d_frames(a, blk.proj)

    def _latent_stats(self, z: torch.Tensor):
        """``(mean, std * scale)`` of the latent normalization on z's device,
        None when it is the identity."""
        cfg = self.cfg
        if cfg.latent_mean is None and cfg.latent_std is None and cfg.latent_scale == 1.0:
            return None
        n = z.shape[-1]
        mean = torch.tensor(cfg.latent_mean or (0.0,) * n, device=z.device)
        std = torch.tensor(cfg.latent_std or (1.0,) * n, device=z.device)
        return mean, std * cfg.latent_scale

    def _normalize(self, z: torch.Tensor) -> torch.Tensor:
        stats = self._latent_stats(z)
        return z if stats is None else (z - stats[0]) / stats[1]

    def _denormalize(self, z: torch.Tensor) -> torch.Tensor:
        stats = self._latent_stats(z)
        return z if stats is None else z * stats[1] + stats[0]

    def _encode_core(self, x: torch.Tensor, caches: Optional[dict] = None):
        """Pixels ``[B, C, T, H, W]`` -> ((mean, logvar) ``f32[B, z, T', h,
        w]``, new caches). ``caches`` None encodes a whole clip; else the
        carried causal caches of the previous window."""
        cfg, p = self.cfg, self.encoder
        tc = caches or {}
        nc = {}

        def cc(name, x, conv, stride=1):
            y, nc[name] = causal_conv3d(x, conv.weight, conv.bias, stride=stride,
                                        tcache=tc.get(name))
            return y

        def rb(name, blk, h):
            nc[name] = {}
            return self._res(blk, h, tc.get(name), nc[name])

        h = cc("conv1", x.to(cfg.torch_dtype), p.conv1)
        for li, lv in enumerate(p.levels):
            for bi, blk in enumerate(lv.blocks):
                h = rb(f"l{li}b{bi}", blk, h)
            if lv.resample is not None:
                h = _conv2d_frames(h, lv.resample, stride=2, asym_pad=True)
                if lv.time_conv is not None:
                    h = cc(f"l{li}t", h, lv.time_conv, stride=(2, 1, 1))
        h = rb("mid0", p.mid[0], h)
        h = self._attn(p.mid_attn, h)
        h = rb("mid1", p.mid[1], h)
        h = F.silu(channel_rms_norm(h, p.head_norm, eps=cfg.eps))
        h = cc("head", h, p.head)
        h, _ = causal_conv3d(h, self.quant.weight, self.quant.bias)
        return h.float().chunk(2, dim=1), nc

    @torch.inference_mode()
    def encode(self, x: torch.Tensor, pixel_chunk: Optional[int] = 4):
        """Pixels ``[B, F, H, W, 3]`` in [-1, 1] -> ``(mean, logvar)``, each
        ``f32[B, 1 + (F-1)/4, H/8, W/8, z]``, the mean normalized. Streams the
        first frame, then windows of ``pixel_chunk`` frames (a multiple of
        the time stride) with the carried causal caches (equal to the whole
        encode), or encodes the whole clip when ``pixel_chunk`` is None."""
        dev = self.quant.weight.device
        x = _patchify_pixels(x.to(dev).float(), self.cfg.patchify).permute(0, 4, 1, 2, 3)
        n = x.shape[2]
        if pixel_chunk is None or n <= 1:
            (mean, logvar), _ = self._encode_core(x)
        else:
            t_stride = 2 ** sum(self.cfg.temporal_down)
            if pixel_chunk % t_stride:
                raise ValueError(f"pixel_chunk {pixel_chunk} is not a multiple of the "
                                 f"time stride {t_stride}")
            caches, means, logvars = None, [], []
            for i in [0] + list(range(1, n, pixel_chunk)):
                end = 1 if i == 0 else min(i + pixel_chunk, n)
                (m, lv), caches = self._encode_core(x[:, :, i:end], caches)
                means.append(m)
                logvars.append(lv)
            mean, logvar = torch.cat(means, dim=2), torch.cat(logvars, dim=2)
        mean, logvar = (t.permute(0, 2, 3, 4, 1) for t in (mean, logvar))
        return self._normalize(mean), logvar

    def _decode_core(self, z: torch.Tensor, caches: Optional[dict] = None):
        """Latents ``[B, z, T, H, W]`` -> (pixels ``[B, T', H', W', 3]`` f32,
        new caches). ``caches`` None decodes a whole clip; else the carried
        causal caches of the previous chunk (a streamed decode)."""
        cfg, p = self.cfg, self.decoder
        tc = caches or {}
        nc = {}

        def cc(name, x, conv):
            y, nc[name] = causal_conv3d(x, conv.weight, conv.bias, tcache=tc.get(name))
            return y

        def rb(name, blk, h):
            nc[name] = {}
            return self._res(blk, h, tc.get(name), nc[name])

        z, _ = causal_conv3d(z.to(cfg.torch_dtype), self.post_quant.weight,
                             self.post_quant.bias)
        h = cc("conv1", z, p.conv1)
        h = rb("mid0", p.mid[0], h)
        h = self._attn(p.mid_attn, h)
        h = rb("mid1", p.mid[1], h)
        for li, lv in enumerate(p.levels):
            for bi, blk in enumerate(lv.blocks):
                h = rb(f"l{li}b{bi}", blk, h)
            if lv.resample is None:
                continue
            if lv.time_conv is not None:
                # the doubled channels are (two frames, C): frame 2t + i takes
                # channel block i; the first chunk drops its leading duplicate
                y = cc(f"l{li}t", h, lv.time_conv)
                b, c2, t, hh, ww = y.shape
                h = y.reshape(b, 2, c2 // 2, t, hh, ww).permute(0, 2, 3, 1, 4, 5)
                h = h.reshape(b, c2 // 2, 2 * t, hh, ww)
                if f"l{li}seen" not in tc:
                    h = h[:, :, 1:]
                nc[f"l{li}seen"] = True
            h = F.interpolate(h, scale_factor=(1, 2, 2), mode="nearest")
            h = _conv2d_frames(h, lv.resample)
        h = F.silu(channel_rms_norm(h, p.head_norm, eps=cfg.eps))
        h = cc("head", h, p.head)
        h = _unpatchify_pixels(h.permute(0, 2, 3, 4, 1), cfg.patchify)
        return h.float(), nc

    @torch.inference_mode()
    def decode(self, z: torch.Tensor, latent_chunk: Optional[int] = 1) -> torch.Tensor:
        """Latents ``[B, F, H, W, z]`` -> pixels ``[B, F', H', W', 3]`` f32.
        Streams ``latent_chunk`` latent frames a call with the carried causal
        caches (default one; equal to the whole decode), or decodes the whole
        clip in one pass when ``latent_chunk`` is None."""
        dev = self.post_quant.weight.device
        z = self._denormalize(z.to(dev).float()).permute(0, 4, 1, 2, 3)
        if latent_chunk is None or z.shape[2] <= latent_chunk:
            return self._decode_core(z)[0]
        caches, outs = None, []
        for i in range(0, z.shape[2], latent_chunk):
            y, caches = self._decode_core(z[:, :, i:i + latent_chunk], caches)
            outs.append(y)
        return torch.cat(outs, dim=1)
