"""Causal-VAE primitives that the Wan, Open-Sora-Plan, CogVideoX, SD and
Open-Sora temporal VAEs are built from, Open-Sora 1.2's micro-frame
composite ``MicroFrameVAE``, and the two VAEs of ``magcache_tpu.models.vae``:
the causal 3-D VAE ``CausalVAE`` (encoder, and a decoder that streams over
latent time with carried caches; Wan i2v's random-weight fallback encoder
when a pipeline has no VAE that encodes) and the compact SD-style 2-D
``ImageVAE``.

The JAX package keeps activations channel-last (NDHWC, XLA's TPU layout).
Here they are NCDHW, cuDNN's layout, with weights in PyTorch's conv layout
``[C_out, C_in, kt, kh, kw]``; the VAE's API converts at its boundary. The
convolutions are plain ``F.conv3d`` (cuDNN on a card): the JAX functions
reach no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["channel_rms_norm", "causal_conv3d", "group_norm", "GroupNormAffine",
           "init_convs_", "blend_edge", "stitch_tiles", "chunked_images", "tiled_decode",
           "MicroFrameVAE", "OPEN_SORA_VAE_SCALE", "OPEN_SORA_VAE_SHIFT", "CausalVAEConfig",
           "CausalVAE", "ImageVAEConfig", "ImageVAE"]


def channel_rms_norm(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the channel axis (dim 1) of ``x [B, C, ...]`` with f32
    statistics and f32 ``weight``/``bias`` ``[C]``; returns x's dtype.
    Position-local statistics: a streamed decode equals a whole one."""
    shape = (-1,) + (1,) * (x.dim() - 2)
    x32 = x.float()
    out = x32 * torch.rsqrt((x32 * x32).mean(1, keepdim=True) + eps)
    out = out * weight.float().reshape(shape)
    if bias is not None:
        out = out + bias.float().reshape(shape)
    return out.to(x.dtype)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm of ``x [B, C, ...]`` (channel dim 1) with f32 statistics over
    each group's channels and every position, and f32 ``weight``/``bias``
    ``[C]``; returns x's dtype. ``groups`` falls back to the largest count
    that divides C (JAX ``group_norm``: ``while c % g: g -= 1``). The
    statistics span every frame: a decode in time slices differs from a
    whole one."""
    c = x.shape[1]
    g = min(groups, c)
    while c % g:
        g -= 1
    return F.group_norm(x.float(), g, weight.float(), bias.float(), eps).to(x.dtype)


def causal_conv3d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  stride: Union[int, Tuple[int, int, int]] = 1,
                  tcache: Optional[torch.Tensor] = None):
    """Causal-in-time 3-D convolution of ``x [B, C, T, H, W]`` by ``weight
    [C_out, C_in, kt, kh, kw]``, zero 'same' padding in space.

    The time axis is left-padded with ``kt - 1`` frames: the first frame
    replicated at clip start, or ``tcache`` (the previous chunk's tail) when
    streaming, which makes a chunked decode equal to a whole one. The next
    chunk's first window starts right after the ``n_out`` windows of step
    ``st`` this call consumed, which keeps a strided conv's window phase.
    Returns ``(y, new_tcache)`` (``new_tcache`` None for ``kt == 1``)."""
    kt, kh, kw = weight.shape[2:]
    stride = (stride,) * 3 if isinstance(stride, int) else tuple(stride)
    if kt > 1:
        front = x[:, :, :1].expand(-1, -1, kt - 1, -1, -1) if tcache is None else tcache
        stream = torch.cat([front, x], dim=2)
        n_out = (stream.shape[2] - kt) // stride[0] + 1
        new_cache = stream[:, :, n_out * stride[0]:].clone()   # not a view of stream
    else:
        stream, new_cache = x, None
    y = F.conv3d(stream, weight, bias, stride=stride, padding=(0, (kh - 1) // 2, (kw - 1) // 2))
    return y, new_cache


class GroupNormAffine(nn.Module):
    """A norm's f32 ``weight`` (ones) and ``bias`` (zeros) ``[C]``; the norm
    itself is ``group_norm`` (or ``channel_rms_norm`` in ``CausalVAE``)."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))


def init_convs_(module: nn.Module, generator: torch.Generator) -> None:
    """Random conv weights as the JAX VAEs draw them (the draws themselves
    differ): ``N(0, 1/fan_in)`` from ``generator`` on its device, zero
    biases (where the conv has one); every other parameter keeps its
    value."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d)):
                w = torch.randn(m.weight.shape, generator=generator, device=generator.device)
                m.weight.copy_(w / math.sqrt(m.weight[0].numel()))
                if m.bias is not None:
                    m.bias.zero_()


def blend_edge(a: torch.Tensor, b: torch.Tensor, ext: int, dim: int) -> torch.Tensor:
    """Tile ``b`` with its first ``ext`` entries along ``dim`` blended
    linearly (weights ``i / ext``) with the last ``ext`` of its neighbour
    ``a`` (the reference VAEs' ``blend_v`` / ``blend_h``); ``ext`` is clipped
    to both tiles."""
    ext = min(a.shape[dim], b.shape[dim], ext)
    if ext <= 0:
        return b
    shape = [1] * b.dim()
    shape[dim] = ext
    w = (torch.arange(ext, dtype=torch.float32, device=b.device) / ext).reshape(shape)
    edge = a.narrow(dim, a.shape[dim] - ext, ext) * (1 - w) + b.narrow(dim, 0, ext) * w
    return torch.cat([edge, b.narrow(dim, ext, b.shape[dim] - ext)], dim=dim)


def stitch_tiles(rows: List[List[torch.Tensor]], ext: int, limit: int) -> torch.Tensor:
    """Rows of decoded, overlapping ``[B, C, T, h, w]`` tiles -> one clip:
    each tile blended over ``ext`` pixels with its upper and left
    neighbours, cropped to ``limit`` x ``limit`` and concatenated."""
    out_rows = []
    for i, row in enumerate(rows):
        out = []
        for j, t in enumerate(row):
            if i > 0:
                t = blend_edge(rows[i - 1][j], t, ext, 3)
            if j > 0:
                t = blend_edge(row[j - 1], t, ext, 4)
            out.append(t[:, :, :, :limit, :limit])
        out_rows.append(torch.cat(out, dim=4))
    return torch.cat(out_rows, dim=3)


def chunked_images(fn: Callable, x: torch.Tensor, device, micro_batch: int) -> torch.Tensor:
    """``fn`` over channel-last ``x [..., H, W, C]`` as f32 NCHW images on
    ``device``, in chunks of ``micro_batch`` images (0: all at once);
    returns channel-last with x's leading dims."""
    lead = x.shape[:-3]
    flat = x.to(device=device, dtype=torch.float32).reshape(-1, *x.shape[-3:])
    flat = flat.permute(0, 3, 1, 2)
    mb = micro_batch or flat.shape[0]
    out = torch.cat([fn(flat[i:i + mb]) for i in range(0, flat.shape[0], mb)])
    out = out.permute(0, 2, 3, 1)
    return out.reshape(*lead, *out.shape[1:])


def tiled_decode(decode: Callable, z: torch.Tensor, tile: int, overlap: int,
                 s: int) -> torch.Tensor:
    """``decode`` of overlapping ``tile`` x ``tile`` tiles of channel-last
    latents ``z [..., h, w, C]`` (steps of ``tile - overlap``), each weighted
    by a linear ramp over its first ``overlap * s`` pixel rows and columns
    where it has an upper or left neighbour, summed and divided by the
    summed weights (the JAX ``decode_tiled`` of the 2-D VAEs; ``s`` is the
    spatial stride); a latent of at most one tile decodes whole."""
    zh, zw = z.shape[-3], z.shape[-2]
    if zh <= tile and zw <= tile:
        return decode(z)
    step, ov = tile - overlap, overlap * s
    out = weight = ramp = None
    for i0 in range(0, zh, step):
        for j0 in range(0, zw, step):
            y = decode(z[..., i0:i0 + tile, j0:j0 + tile, :])
            ph, pw = y.shape[-3], y.shape[-2]
            if out is None:
                out = torch.zeros(*y.shape[:-3], zh * s, zw * s, y.shape[-1],
                                  device=y.device)
                weight = torch.zeros(zh * s, zw * s, 1, device=y.device)
                ramp = torch.from_numpy(
                    np.linspace(0, 1, ov, endpoint=False).astype(np.float32)).to(y.device)
            w = torch.ones(ph, pw, device=y.device)
            if ov > 0 and i0 > 0:
                w[:ov] *= ramp[:ph, None]
            if ov > 0 and j0 > 0:
                w[:, :ov] *= ramp[None, :pw]
            w = w[:, :, None]
            rows, cols = slice(i0 * s, i0 * s + ph), slice(j0 * s, j0 * s + pw)
            out[..., rows, cols, :] += y * w
            weight[rows, cols] += w
    return out / weight.clamp_min(1e-8)


# Open-Sora 1.2's per-channel latent scale and shift (Open-Sora
# opensora/models/vae/vae.py ``OpenSoraVAE_V1_2``, ``VideoAutoencoderPipeline``
# ``scale`` / ``shift``; not in the repository): the sampler's latents z are
# the VAE's ``z * scale + shift``
OPEN_SORA_VAE_SCALE = (3.85, 2.32, 2.33, 3.06)
OPEN_SORA_VAE_SHIFT = (-0.10, 0.34, 0.27, 0.98)


class MicroFrameVAE(nn.Module):
    """Open-Sora 1.2's composite VAE (``VideoAutoencoderPipeline``,
    ``autoencoder_kl_open_sora.py:621-761``): a 2-D ``spatial`` VAE
    (``models.vae_sd.SDVAE``, or an ``ImageVAE``) over every frame, then a
    temporal causal VAE (``models.vae_temporal.VAETemporal``, or a
    ``CausalVAE``) over independent chunks of ``micro_frame_size`` frames
    (17; ``ceil(17 / time_factor)`` = 5 latents a chunk for the front-padding
    ``VAETemporal``, so 51 frames are 15 latents and decode back to 51;
    ``1 + (17 - 1) // time_factor`` for a ``CausalVAE``, which keeps frame 0
    and takes no frame count). The spatial VAE's ``micro_batch`` bounds the
    frames a spatial call takes.

    The reference's two latent scales: ``decode`` starts with ``z * scale +
    shift`` (per channel) and ``encode`` ends with its inverse; between the
    stages the spatial VAE's ``from_latent`` / ``to_latent`` (its
    ``scaling_factor``, 0.18215) is applied to each frame. The JAX composite
    applies neither; identity values (scale 1, shift 0, a spatial VAE with
    ``scaling_factor`` 1 and ``shift_factor`` 0) make this module that one.
    Channel-last f32 at the API: pixels ``[B, T, H, W, 3]``, latents ``[B,
    T', H/s, W/s, C]``."""

    def __init__(self, spatial: nn.Module, temporal: nn.Module, micro_frame_size: int = 17,
                 scale: Tuple[float, ...] = OPEN_SORA_VAE_SCALE,
                 shift: Tuple[float, ...] = OPEN_SORA_VAE_SHIFT):
        super().__init__()
        self.spatial, self.temporal = spatial, temporal
        self.micro_frame_size = micro_frame_size
        self.scale, self.shift = tuple(scale), tuple(shift)

    def init(self, generator: torch.Generator) -> "MicroFrameVAE":
        """Random weights for both stages from ``generator``."""
        self.spatial.init(generator)
        self.temporal.init(generator)
        return self

    def _affine(self, z: torch.Tensor):
        """The per-channel ``(scale, shift)`` as tensors on z's device."""
        return (torch.tensor(self.scale, dtype=torch.float32, device=z.device),
                torch.tensor(self.shift, dtype=torch.float32, device=z.device))

    def _spatial_encode(self, x: torch.Tensor) -> torch.Tensor:
        mean, _ = self.spatial.encode(x)
        return self.spatial.to_latent(mean)

    def _spatial_decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.spatial.decode(self.spatial.from_latent(z))

    @torch.inference_mode()
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Pixels ``[B, T, H, W, 3]`` in [-1, 1] -> latents ``[B, T', H/s,
        W/s, C]``: each chunk of ``micro_frame_size`` frames encoded alone
        (its temporal mean), then ``(z - shift) / scale``."""
        zs = self._spatial_encode(x)
        mf = self.micro_frame_size
        z = torch.cat([self.temporal.encode(zs[:, i:i + mf])[0]
                       for i in range(0, zs.shape[1], mf)], dim=1)
        scale, shift = self._affine(z)
        return (z - shift) / scale

    @torch.inference_mode()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents ``[B, T', h, w, C]`` -> pixels ``[B, T, s h, s w, 3]``:
        ``z * scale + shift``, then each chunk of latents (``ceil(
        micro_frame_size / time_factor)`` of them, decoded to at most
        ``micro_frame_size`` frames, where the temporal VAE front-pads; else
        ``1 + (micro_frame_size - 1) // time_factor``) decoded alone, frame by
        frame in space."""
        z = z.to(device=self.temporal.device, dtype=torch.float32)
        scale, shift = self._affine(z)
        z = z * scale + shift
        mf, tf = self.micro_frame_size, self.temporal.cfg.time_factor
        front_padded = getattr(self.temporal, "front_padded_latents", False)
        chunk = -(-mf // tf) if front_padded else 1 + (mf - 1) // tf
        outs = []
        for i in range(0, z.shape[1], chunk):
            zc = z[:, i:i + chunk]
            if front_padded:
                y = self.temporal.decode(zc, num_frames=min(mf, zc.shape[1] * tf))
            else:
                y = self.temporal.decode(zc)
            outs.append(self._spatial_decode(y))
        return torch.cat(outs, dim=1)


@dataclasses.dataclass(frozen=True)
class CausalVAEConfig:
    """The causal 3-D VAE (the JAX package's ``CausalVAEConfig``): stride
    (4, 8, 8) at the defaults, ``ch_mult`` levels with ``blocks_per_level``
    residual blocks each, a temporal stride 2 on each transition whose
    ``temporal_downsample`` entry is set. Its norms are channel RMS norms."""

    in_channels: int = 3
    z_channels: int = 16
    base: int = 96
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    blocks_per_level: int = 2
    temporal_downsample: Tuple[bool, ...] = (False, True, True, False)

    @property
    def chs(self) -> List[int]:
        return [self.base * m for m in self.ch_mult]

    @property
    def time_factor(self) -> int:
        return 2 ** sum(self.temporal_downsample)

    @staticmethod
    def tiny(**kw) -> "CausalVAEConfig":
        d = dict(base=8, ch_mult=(1, 2), blocks_per_level=1,
                 temporal_downsample=(True, False), z_channels=4)
        d.update(kw)
        return CausalVAEConfig(**d)


class CausalResBlock(nn.Module):
    """RMS norm (affine) -> SiLU -> causal conv, twice, plus a 1x1x1 ``skip``
    conv when the channels change."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.norm1, self.norm2 = GroupNormAffine(cin, device), GroupNormAffine(cout, device)
        self.conv1 = nn.Conv3d(cin, cout, 3, device=device)
        self.conv2 = nn.Conv3d(cout, cout, 3, device=device)
        self.skip = nn.Conv3d(cin, cout, 1, device=device) if cin != cout else None

    def forward(self, x: torch.Tensor, cache: Optional[dict] = None):
        """``x`` -> ``(out, new cache)``; ``cache`` holds the previous
        chunk's time caches of the two convs (``c1``, ``c2``; None at clip
        start)."""
        cache = cache or {}
        h = F.silu(channel_rms_norm(x, self.norm1.weight, self.norm1.bias))
        h, c1 = causal_conv3d(h, self.conv1.weight, self.conv1.bias, tcache=cache.get("c1"))
        h = F.silu(channel_rms_norm(h, self.norm2.weight, self.norm2.bias))
        h, c2 = causal_conv3d(h, self.conv2.weight, self.conv2.bias, tcache=cache.get("c2"))
        if self.skip is not None:
            x = self.skip(x)
        return x + h, {"c1": c1, "c2": c2}


class Level(nn.Module):
    """A VAE level: its residual ``blocks`` and its transition conv under
    ``name`` (``down`` or ``up``; None on the last level)."""

    def __init__(self, blocks: List[nn.Module], name: str, conv: Optional[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        setattr(self, name, conv)


class CausalVAEEncoder(nn.Module):
    def __init__(self, cfg: CausalVAEConfig, device=None):
        super().__init__()
        chs = cfg.chs
        self.stem = nn.Conv3d(cfg.in_channels, chs[0], 3, device=device)
        levels, c = [], chs[0]
        for li, ch in enumerate(chs):
            blocks = []
            for _ in range(cfg.blocks_per_level):
                blocks.append(CausalResBlock(c, ch, device))
                c = ch
            down = None
            if li < len(chs) - 1:
                kt = 3 if cfg.temporal_downsample[li] else 1
                down = nn.Conv3d(c, c, (kt, 3, 3), device=device)
            levels.append(Level(blocks, "down", down))
        self.levels = nn.ModuleList(levels)
        self.mid = CausalResBlock(c, c, device)
        self.out_norm = GroupNormAffine(c, device)
        self.out = nn.Conv3d(c, 2 * cfg.z_channels, 3, device=device)


class CausalVAEDecoder(nn.Module):
    """The encoder mirrored (JAX ``init_causal_vae_params``' ``decoder``):
    a level's ``up`` conv (1x3x3) makes ``2 ts`` times its channels, which a
    pixel shuffle turns into ``ts`` frames and 2x2 pixels at half the
    channels."""

    def __init__(self, cfg: CausalVAEConfig, device=None):
        super().__init__()
        chs = cfg.chs
        c = chs[-1]
        self.stem = nn.Conv3d(cfg.z_channels, c, 3, device=device)
        self.mid = CausalResBlock(c, c, device)
        levels = []
        for li, ch in enumerate(reversed(chs)):
            blocks = []
            for _ in range(cfg.blocks_per_level):
                blocks.append(CausalResBlock(c, ch, device))
                c = ch
            up = None
            if li < len(chs) - 1:
                ts = 2 if cfg.temporal_downsample[len(chs) - 2 - li] else 1
                up = nn.Conv3d(c, c * 2 * ts, (1, 3, 3), device=device)
                c //= 2
            levels.append(Level(blocks, "up", up))
        self.levels = nn.ModuleList(levels)
        self.out_norm = GroupNormAffine(c, device)
        self.out = nn.Conv3d(c, cfg.in_channels, 3, device=device)


class CausalVAE(nn.Module):
    """The causal 3-D VAE in f32 (JAX ``CausalVAE``). ``encode``: pixels
    ``[B, T, H, W, 3]`` -> ``(mean, logvar)``, each ``f32[B, 1 + (T-1)/4,
    H/8, W/8, z]`` at the default strides, the whole clip in one pass. Each
    downsample zero-pads one row and column on every side, pads time with
    ``kt - 1`` copies of the first frame (a strided transition has a time
    kernel of 3, else 1) and convolves at stride (ts, 2, 2). ``decode``:
    latents ``[B, T', h, w, z]`` -> pixels ``[B, 1 + 4 (T' - 1), 8h, 8w,
    3]``; ``decode_chunked`` streams over latent time with the causal
    convs' caches carried from chunk to chunk. Build on ``device``, then
    ``init(generator)`` or ``load_state_dict``
    (``models.convert.causal_vae_params_from_numpy``)."""

    # causal time compression keeps frame 0: a micro-frame chunk of m frames
    # is 1 + (m - 1) // time_factor latents, no frame-count hint
    front_padded_latents = False

    def __init__(self, cfg: CausalVAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        # the encoder first: its random draws do not depend on the decoder
        self.encoder = CausalVAEEncoder(cfg, device)
        self.decoder = CausalVAEDecoder(cfg, device)

    def init(self, generator: torch.Generator) -> "CausalVAE":
        """Random conv weights ``N(0, 1/fan_in)`` and zero biases from
        ``generator``, unit norm gains (``init_causal_vae_params``'s
        distributions; the draws differ)."""
        init_convs_(self, generator)
        return self

    @property
    def device(self) -> torch.device:
        return self.encoder.stem.weight.device

    @torch.inference_mode()
    def encode(self, x: torch.Tensor):
        p = self.encoder
        h = x.to(self.device).float().permute(0, 4, 1, 2, 3)
        h, _ = causal_conv3d(h, p.stem.weight, p.stem.bias)
        for li, lv in enumerate(p.levels):
            for blk in lv.blocks:
                h = blk(h)[0]
            if lv.down is not None:
                kt = lv.down.weight.shape[2]
                ts = 2 if self.cfg.temporal_downsample[li] else 1
                h = F.pad(h, (1, 1, 1, 1))
                if kt > 1:
                    h = torch.cat([h[:, :, :1].expand(-1, -1, kt - 1, -1, -1), h], dim=2)
                h = F.conv3d(h, lv.down.weight, lv.down.bias, stride=(ts, 2, 2))
        h = p.mid(h)[0]
        h = F.silu(channel_rms_norm(h, p.out_norm.weight, p.out_norm.bias))
        h, _ = causal_conv3d(h, p.out.weight, p.out.bias)
        mean, logvar = h.permute(0, 2, 3, 4, 1).chunk(2, dim=-1)
        return mean.contiguous(), logvar.contiguous()

    def _decode_core(self, z: torch.Tensor, caches: Optional[dict]):
        """Latents ``[B, z, T, h, w]`` -> (pixels ``[B, 3, T', H, W]``, the
        causal convs' caches); ``caches`` None starts a clip (JAX
        ``_decode_core``): its temporal upsamples drop the ``ts - 1``
        leading frames they fabricate for frame 0."""
        p, cfg = self.decoder, self.cfg
        tc = caches or {}
        new = {}

        def conv(name, x, m):
            y, new[name] = causal_conv3d(x, m.weight, m.bias, tcache=tc.get(name))
            return y

        def res(name, blk, x):
            y, new[name] = blk(x, tc.get(name))
            return y

        h = conv("stem", z, p.stem)
        h = res("mid", p.mid, h)
        n = len(cfg.ch_mult)
        for li, lv in enumerate(p.levels):
            for bi, blk in enumerate(lv.blocks):
                h = res(f"l{li}b{bi}", blk, h)
            if li < n - 1:
                ts = 2 if cfg.temporal_downsample[n - 2 - li] else 1
                h = conv(f"l{li}up", h, lv.up)
                b, c, t, hh, ww = h.shape
                h = h.reshape(b, ts, 2, 2, c // (4 * ts), t, hh, ww)
                h = h.permute(0, 4, 5, 1, 6, 2, 7, 3).reshape(b, -1, t * ts, 2 * hh, 2 * ww)
                if caches is None and ts > 1:
                    h = h[:, :, ts - 1:]
        h = F.silu(channel_rms_norm(h, p.out_norm.weight, p.out_norm.bias))
        return conv("outc", h, p.out), new

    @torch.inference_mode()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents ``[B, T', h, w, z]`` -> pixels ``[B, T, H, W, 3]`` f32, the
        whole clip in one pass."""
        z = z.to(device=self.device, dtype=torch.float32).permute(0, 4, 1, 2, 3)
        return self._decode_core(z, None)[0].permute(0, 2, 3, 4, 1)

    @torch.inference_mode()
    def decode_chunked(self, z: torch.Tensor, chunk: int = 2) -> torch.Tensor:
        """``decode`` over latent time in windows of ``chunk`` latents with the
        causal caches carried (JAX ``decode_chunked``); equal to ``decode``:
        the norms are position-local."""
        z = z.to(device=self.device, dtype=torch.float32).permute(0, 4, 1, 2, 3)
        caches, outs = None, []
        for i in range(0, z.shape[2], chunk):
            y, caches = self._decode_core(z[:, :, i:i + chunk], caches)
            outs.append(y)
        return torch.cat(outs, dim=2).permute(0, 2, 3, 4, 1)


@dataclasses.dataclass(frozen=True)
class ImageVAEConfig:
    """The compact SD-style 2-D VAE (the JAX package's ``ImageVAEConfig``):
    stride 8 at the defaults, GroupNorm of ``groups``."""

    in_channels: int = 3
    z_channels: int = 16
    base: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    blocks_per_level: int = 2
    groups: int = 32

    @property
    def chs(self) -> List[int]:
        return [self.base * m for m in self.ch_mult]

    @property
    def spatial_down(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)

    @staticmethod
    def tiny(**kw) -> "ImageVAEConfig":
        d = dict(base=8, ch_mult=(1, 2), blocks_per_level=1, z_channels=4, groups=4)
        d.update(kw)
        return ImageVAEConfig(**d)


class ImageResBlock(nn.Module):
    """GroupNorm -> SiLU -> 3x3 conv, twice, plus a 1x1 ``skip`` conv when the
    channels change."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.norm1, self.norm2 = GroupNormAffine(cin, device), GroupNormAffine(cout, device)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, device=device)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, device=device)
        self.skip = nn.Conv2d(cin, cout, 1, device=device) if cin != cout else None

    def forward(self, x: torch.Tensor, groups: int) -> torch.Tensor:
        h = self.conv1(F.silu(group_norm(x, self.norm1.weight, self.norm1.bias, groups)))
        h = self.conv2(F.silu(group_norm(h, self.norm2.weight, self.norm2.bias, groups)))
        return (x if self.skip is None else self.skip(x)) + h


class ImageCoder(nn.Module):
    """One side of ``ImageVAE``: ``stem``, (the decoder's ``mid``), the levels
    with their ``down`` (stride 2 after a zero pad of one row and column at
    the bottom and right) or ``up`` convs (4x the channels, then a 2x2 pixel
    shuffle), ``out_norm``, ``out``."""

    def __init__(self, cfg: ImageVAEConfig, decoder: bool, device=None):
        super().__init__()
        chs = cfg.chs
        c = chs[-1] if decoder else chs[0]
        self.stem = nn.Conv2d(cfg.z_channels if decoder else cfg.in_channels, c, 3,
                              padding=1, device=device)
        if decoder:
            self.mid = ImageResBlock(c, c, device)
        levels = []
        for li, ch in enumerate(reversed(chs) if decoder else chs):
            blocks = []
            for _ in range(cfg.blocks_per_level):
                blocks.append(ImageResBlock(c, ch, device))
                c = ch
            conv = None
            if li < len(chs) - 1:
                conv = nn.Conv2d(c, 4 * c if decoder else c, 3,
                                 padding=1 if decoder else 0,
                                 stride=1 if decoder else 2, device=device)
            levels.append(Level(blocks, "up" if decoder else "down", conv))
        self.levels = nn.ModuleList(levels)
        self.out_norm = GroupNormAffine(c, device)
        self.out = nn.Conv2d(c, cfg.in_channels if decoder else 2 * cfg.z_channels, 3,
                             padding=1, device=device)


class ImageVAE(nn.Module):
    """The compact 2-D VAE in f32 (JAX ``ImageVAE``): pixels ``[..., H, W,
    3]`` <-> latents ``[..., H/s, W/s, z]`` (s = ``cfg.spatial_down``), any
    leading dims, in chunks of ``micro_batch`` images. Its latents carry no
    scale (``to_latent`` and ``from_latent`` are the identity). Build on
    ``device``, then ``init(generator)`` or ``load_state_dict``
    (``models.convert.image_vae_params_from_numpy``)."""

    micro_batch = 8

    def __init__(self, cfg: ImageVAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = ImageCoder(cfg, False, device)
        self.decoder = ImageCoder(cfg, True, device)

    def init(self, generator: torch.Generator) -> "ImageVAE":
        """Random conv weights ``N(0, 1/fan_in)`` and zero biases from
        ``generator``, unit norm gains (``init_image_vae_params``'s
        distributions; the draws differ)."""
        init_convs_(self, generator)
        return self

    @property
    def device(self) -> torch.device:
        return self.encoder.stem.weight.device

    def _encode_nchw(self, x: torch.Tensor) -> torch.Tensor:
        p, g = self.encoder, self.cfg.groups
        h = p.stem(x)
        for lv in p.levels:
            for blk in lv.blocks:
                h = blk(h, g)
            if lv.down is not None:
                h = lv.down(F.pad(h, (0, 1, 0, 1)))
        return p.out(F.silu(group_norm(h, p.out_norm.weight, p.out_norm.bias, g)))

    def _decode_nchw(self, z: torch.Tensor) -> torch.Tensor:
        p, g = self.decoder, self.cfg.groups
        h = p.mid(p.stem(z), g)
        for lv in p.levels:
            for blk in lv.blocks:
                h = blk(h, g)
            if lv.up is not None:
                h = lv.up(h)
                b, c4, hh, ww = h.shape
                h = h.reshape(b, 2, 2, c4 // 4, hh, ww).permute(0, 3, 4, 1, 5, 2)
                h = h.reshape(b, c4 // 4, 2 * hh, 2 * ww)
        return p.out(F.silu(group_norm(h, p.out_norm.weight, p.out_norm.bias, g)))

    @torch.inference_mode()
    def encode(self, x: torch.Tensor):
        """Pixels ``[..., H, W, 3]`` -> ``(mean, logvar)``, each ``[..., H/s,
        W/s, z]`` f32."""
        h = chunked_images(self._encode_nchw, x, self.device, self.micro_batch)
        return h[..., :self.cfg.z_channels], h[..., self.cfg.z_channels:]

    @torch.inference_mode()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents ``[..., h, w, z]`` -> pixels ``[..., s h, s w, 3]`` f32."""
        return chunked_images(self._decode_nchw, z, self.device, self.micro_batch)

    @torch.inference_mode()
    def decode_tiled(self, z: torch.Tensor, tile: int = 32, overlap: int = 4) -> torch.Tensor:
        """``decode`` in overlapping ``tile`` x ``tile`` latent tiles blended
        as the JAX ``ImageVAE.decode_tiled`` blends them (``tiled_decode``)."""
        return tiled_decode(self.decode, z, tile, overlap, self.cfg.spatial_down)

    def to_latent(self, mean: torch.Tensor) -> torch.Tensor:
        return mean

    def from_latent(self, z: torch.Tensor) -> torch.Tensor:
        return z
