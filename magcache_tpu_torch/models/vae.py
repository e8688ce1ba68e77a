"""Causal-VAE primitives that the Wan, Open-Sora-Plan, CogVideoX, SD and
Open-Sora temporal VAEs are built from, Open-Sora 1.2's micro-frame
composite ``MicroFrameVAE``, and the encoder of the causal 3-D VAE
``CausalVAE`` (the ported part of ``magcache_tpu.models.vae``; Wan i2v's
random-weight fallback encoder when a pipeline has no VAE that encodes; its
decoder is not ported).

The JAX package keeps activations channel-last (NDHWC, XLA's TPU layout).
Here they are NCDHW, cuDNN's layout, with weights in PyTorch's conv layout
``[C_out, C_in, kt, kh, kw]``; the VAE's API converts at its boundary. The
convolutions are plain ``F.conv3d`` (cuDNN on a card): the JAX functions
reach no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["channel_rms_norm", "causal_conv3d", "group_norm", "GroupNormAffine",
           "init_convs_", "blend_edge", "stitch_tiles", "MicroFrameVAE",
           "OPEN_SORA_VAE_SCALE", "OPEN_SORA_VAE_SHIFT", "CausalVAEConfig", "CausalVAE"]


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


# Open-Sora 1.2's per-channel latent scale and shift (Open-Sora
# opensora/models/vae/vae.py ``OpenSoraVAE_V1_2``, ``VideoAutoencoderPipeline``
# ``scale`` / ``shift``; not in the repository): the sampler's latents z are
# the VAE's ``z * scale + shift``
OPEN_SORA_VAE_SCALE = (3.85, 2.32, 2.33, 3.06)
OPEN_SORA_VAE_SHIFT = (-0.10, 0.34, 0.27, 0.98)


class MicroFrameVAE(nn.Module):
    """Open-Sora 1.2's composite VAE (``VideoAutoencoderPipeline``,
    ``autoencoder_kl_open_sora.py:621-761``): a 2-D ``spatial`` VAE
    (``models.vae_sd.SDVAE``) over every frame, then a temporal causal VAE
    (``models.vae_temporal.VAETemporal``) over independent chunks of
    ``micro_frame_size`` frames (17; ``ceil(17 / time_factor)`` = 5 latents a
    chunk), so 51 frames are 15 latents and decode back to 51. The spatial
    VAE's ``micro_batch`` bounds the frames a spatial call takes.

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
        ``z * scale + shift``, then each chunk of ``ceil(micro_frame_size /
        time_factor)`` latents decoded alone to at most ``micro_frame_size``
        frames (the temporal VAE front-pads), frame by frame in space."""
        z = z.to(device=self.temporal.device, dtype=torch.float32)
        scale, shift = self._affine(z)
        z = z * scale + shift
        tf = self.temporal.cfg.time_factor
        chunk = -(-self.micro_frame_size // tf)
        outs = []
        for i in range(0, z.shape[1], chunk):
            zc = z[:, i:i + chunk]
            y = self.temporal.decode(zc, num_frames=min(self.micro_frame_size,
                                                         zc.shape[1] * tf))
            outs.append(self._spatial_decode(y))
        return torch.cat(outs, dim=1)


@dataclasses.dataclass(frozen=True)
class CausalVAEConfig:
    """The causal 3-D VAE (the JAX package's ``CausalVAEConfig``): stride
    (4, 8, 8) at the defaults, ``ch_mult`` levels with ``blocks_per_level``
    residual blocks each, a temporal stride 2 on each transition whose
    ``temporal_downsample`` entry is set. The encoder's norms are channel
    RMS norms."""

    in_channels: int = 3
    z_channels: int = 16
    base: int = 96
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    blocks_per_level: int = 2
    temporal_downsample: Tuple[bool, ...] = (False, True, True, False)

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(channel_rms_norm(x, self.norm1.weight, self.norm1.bias))
        h, _ = causal_conv3d(h, self.conv1.weight, self.conv1.bias)
        h = F.silu(channel_rms_norm(h, self.norm2.weight, self.norm2.bias))
        h, _ = causal_conv3d(h, self.conv2.weight, self.conv2.bias)
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class CausalDownLevel(nn.Module):
    def __init__(self, blocks: List[nn.Module], down: Optional[nn.Conv3d]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.down = down


class CausalVAEEncoder(nn.Module):
    def __init__(self, cfg: CausalVAEConfig, device=None):
        super().__init__()
        chs = [cfg.base * m for m in cfg.ch_mult]
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
            levels.append(CausalDownLevel(blocks, down))
        self.levels = nn.ModuleList(levels)
        self.mid = CausalResBlock(c, c, device)
        self.out_norm = GroupNormAffine(c, device)
        self.out = nn.Conv3d(c, 2 * cfg.z_channels, 3, device=device)


class CausalVAE(nn.Module):
    """The causal 3-D VAE's encoder in f32 (JAX ``CausalVAE.encode``):
    pixels ``[B, T, H, W, 3]`` -> ``(mean, logvar)``, each ``f32[B, 1 +
    (T-1)/4, H/8, W/8, z]`` at the default strides, the whole clip in one
    pass. Each downsample zero-pads one row and column on every side, pads
    time with ``kt - 1`` copies of the first frame (a strided transition has
    a time kernel of 3, else 1) and convolves at stride (ts, 2, 2). Build
    on ``device``, then ``init(generator)`` or ``load_state_dict``
    (``models.convert.causal_vae_params_from_numpy``)."""

    def __init__(self, cfg: CausalVAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = CausalVAEEncoder(cfg, device)

    def init(self, generator: torch.Generator) -> "CausalVAE":
        """Random conv weights ``N(0, 1/fan_in)`` and zero biases from
        ``generator``, unit norm gains (``init_causal_vae_params``'s
        distributions; the draws differ)."""
        init_convs_(self, generator)
        return self

    @torch.inference_mode()
    def encode(self, x: torch.Tensor):
        p = self.encoder
        h = x.to(p.stem.weight.device).float().permute(0, 4, 1, 2, 3)
        h, _ = causal_conv3d(h, p.stem.weight, p.stem.bias)
        for li, lv in enumerate(p.levels):
            for blk in lv.blocks:
                h = blk(h)
            if lv.down is not None:
                kt = lv.down.weight.shape[2]
                ts = 2 if self.cfg.temporal_downsample[li] else 1
                h = F.pad(h, (1, 1, 1, 1))
                if kt > 1:
                    h = torch.cat([h[:, :, :1].expand(-1, -1, kt - 1, -1, -1), h], dim=2)
                h = F.conv3d(h, lv.down.weight, lv.down.bias, stride=(ts, 2, 2))
        h = p.mid(h)
        h = F.silu(channel_rms_norm(h, p.out_norm.weight, p.out_norm.bias))
        h, _ = causal_conv3d(h, p.out.weight, p.out.bias)
        mean, logvar = h.permute(0, 2, 3, 4, 1).chunk(2, dim=-1)
        return mean.contiguous(), logvar.contiguous()
