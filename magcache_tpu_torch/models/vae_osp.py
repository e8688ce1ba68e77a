"""Open-Sora-Plan's CausalVAE decoder as PyTorch modules (the decode side of
``magcache_tpu.models.vae_osp``; reference ``videosys/models/autoencoders/
autoencoder_kl_open_sora_plan_v120.py``).

SD-VAE topology from causal 3-D blocks: a 1x1x1 post-quant conv, ``conv_in``,
a mid block (residual block, single-head per-frame spatial attention,
residual block), then per level (deepest first) ``num_res_blocks + 1``
residual blocks (GroupNorm -> SiLU -> causal conv, twice, and a 1x1x1
``nin_shortcut`` where the channels change) and the level's upsample;
GroupNorm -> SiLU -> ``conv_out`` to 3 pixel channels. The causal conv
replicates the first frame ``kt - 1`` times in front and zero-pads space
symmetrically. Upsamples: ``"s2t2"`` (frame 0 resized 2x in space on its
own, the other frames trilinear 2x in (t, h, w), then a 3x3x3 causal conv:
T' = 1 + 2(T - 1)), ``"spatial"`` (nearest 2x in space, a 1x3x3 conv) and
the parameter-free ``"time"`` slot (frame 0 kept, the rest trilinear 2x in
time).

``decode`` tiles as the reference does past 32 latent rows or columns or 16
latent frames: windows of 16 latent frames with one frame of overlap (later
windows drop their first output frame), each decoded in 32x32 latent tiles
overlapping by 1/8 and blended linearly over 32 pixel rows and columns.

The JAX default layout (``OSPVAEConfig()``, three ``"s2t2"`` levels)
compresses time 8x, but the Open-Sora-Plan pipeline counts latent frames at
4x (``(frames - 1) // 4 + 1``): it would return 57 frames for a 29-frame
request. The pipeline therefore takes the two 4x-time, 8x-space layouts
below, ``OSP_V120_VAE`` and ``OSP_V110_VAE``, and refuses a VAE whose
strides disagree with it.

Activations are NCDHW inside (cuDNN's layout); latents ``[B, F, H, W, C]``
and pixels ``[B, F, H, W, 3]`` f32 at the API, as in JAX. Everything runs in
f32 (the JAX module has no other dtype); the mid attention is plain PyTorch
(plain XLA in JAX, no Pallas kernel). The encoder is not ported;
``models.convert.osp_vae_params_from_numpy`` carries the JAX tree's decoder
over, and ``load_osp_vae_checkpoint`` reads a ``CausalVAEModel`` checkpoint
(``convert_osp_vae_state_dict``: the whole tree converts, so a missing
encoder key raises as in JAX; the decoder is kept).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from magcache_tpu_torch.models.vae import (GroupNormAffine, causal_conv3d, group_norm,
                                           init_convs_, stitch_tiles)

__all__ = ["OSPVAEConfig", "OSPCausalVAE", "OSP_V120_VAE", "OSP_V110_VAE", "t_chunks"]


@dataclasses.dataclass(frozen=True)
class OSPVAEConfig:
    hidden: int = 128
    z_channels: int = 4
    embed_dim: int = 4
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    groups: int = 32
    use_quant_layer: bool = True
    # per-level block types; "" = none (the encoder's ``down_types`` and
    # ``time_down_types`` are kept for the JAX fields; the decoder reads the
    # ``up`` ones)
    down_types: Tuple[str, ...] = ("s2t2", "s2t2", "s2t2", "")
    up_types: Tuple[str, ...] = ("", "s2t2", "s2t2", "s2t2")
    time_down_types: Tuple[str, ...] = ("", "", "", "")
    time_up_types: Tuple[str, ...] = ("", "", "", "")

    @property
    def chs(self):
        return [self.hidden * m for m in self.ch_mult]

    @property
    def time_stride(self) -> int:
        """Latent frames to pixel frames: ``1 + time_stride * (T - 1)``."""
        return 2 ** (self.up_types.count("s2t2") + self.time_up_types.count("time"))

    @property
    def space_stride(self) -> int:
        return 2 ** sum(1 for u in self.up_types if u)

    @staticmethod
    def tiny(**kw) -> "OSPVAEConfig":
        d = dict(hidden=8, ch_mult=(1, 2), num_res_blocks=1, groups=4,
                 down_types=("s2t2", ""), up_types=("", "s2t2"))
        d.update(kw)
        return OSPVAEConfig(**d)


# the two 4x-time, 8x-space layouts at the published widths (hidden 128,
# mults (1, 2, 4, 4)): v1.2's combined space-time blocks on the two middle
# levels and a spatial-only one; v1.1's spatial-only convs with the
# parameter-free time blocks
OSP_V120_VAE = OSPVAEConfig(down_types=("spatial", "s2t2", "s2t2", ""),
                            up_types=("", "s2t2", "s2t2", "spatial"))
OSP_V110_VAE = OSPVAEConfig(down_types=("spatial", "spatial", "spatial", ""),
                            time_down_types=("", "time", "time", ""),
                            up_types=("", "spatial", "spatial", "spatial"),
                            time_up_types=("", "time", "time", ""))


def t_chunks(t: int, size: int):
    """``[start, end)`` windows stepping ``size - 1`` with one frame of
    overlap (JAX ``_t_chunks``, the reference's tiled decode)."""
    idx = list(range(0, t, size - 1))
    if len(idx) == 1:
        return [(0, t)]
    se = [[idx[i], idx[i + 1] + 1] for i in range(len(idx) - 1)]
    if se[-1][-1] > t:
        se[-1][-1] = t
    elif se[-1][-1] < t:
        se.append([idx[-1], t])
    return [tuple(p) for p in se]


def _conv(cin, cout, k, device) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, k, device=device)


class ResBlock(nn.Module):
    def __init__(self, cin, cout, device):
        super().__init__()
        self.norm1, self.norm2 = GroupNormAffine(cin, device), GroupNormAffine(cout, device)
        self.conv1, self.conv2 = _conv(cin, cout, 3, device), _conv(cout, cout, 3, device)
        self.nin_shortcut = _conv(cin, cout, 1, device) if cin != cout else None


class AttnBlock(nn.Module):
    def __init__(self, c, device):
        super().__init__()
        self.norm = GroupNormAffine(c, device)
        self.q, self.k, self.v, self.proj_out = (_conv(c, c, 1, device) for _ in range(4))


class UpLevel(nn.Module):
    def __init__(self, cin, cout, blocks, kind, device):
        super().__init__()
        self.block = nn.ModuleList(ResBlock(cin if j == 0 else cout, cout, device)
                                   for j in range(blocks))
        k = {"s2t2": 3, "spatial": (1, 3, 3)}.get(kind)
        self.upsample = _conv(cout, cout, k, device) if k else None


class Decoder(nn.Module):
    def __init__(self, cfg: OSPVAEConfig, device):
        super().__init__()
        chs = cfg.chs
        self.conv_in = _conv(cfg.z_channels, chs[-1], 3, device)
        self.mid = nn.ModuleDict({"block_1": ResBlock(chs[-1], chs[-1], device),
                                  "attn_1": AttnBlock(chs[-1], device),
                                  "block_2": ResBlock(chs[-1], chs[-1], device)})
        levels, c = {}, chs[-1]
        for i in reversed(range(len(chs))):
            levels[i] = UpLevel(c, chs[i], cfg.num_res_blocks + 1, cfg.up_types[i], device)
            c = chs[i]
        self.up = nn.ModuleList(levels[i] for i in range(len(chs)))
        self.norm_out = GroupNormAffine(chs[0], device)
        self.conv_out = _conv(chs[0], 3, 3, device)


def _cconv(x: torch.Tensor, conv: nn.Conv3d) -> torch.Tensor:
    """OSP's CausalConv3d (stride 1): the first frame replicated ``kt - 1``
    times in front, symmetric zero padding in space."""
    return causal_conv3d(x, conv.weight, conv.bias)[0]


def _trilinear(x: torch.Tensor, size) -> torch.Tensor:
    return F.interpolate(x, size=size, mode="trilinear", align_corners=False)


def _up_s2t2(conv, x):
    """Frame 0 resized 2x in space alone, the others trilinear 2x in (t, h,
    w); then the causal conv (ref ``Spatial2xTime2x3DUpsample``)."""
    b, c, t, hh, ww = x.shape
    if t > 1:
        x = torch.cat([_trilinear(x[:, :, :1], (1, 2 * hh, 2 * ww)),
                       _trilinear(x[:, :, 1:], (2 * (t - 1), 2 * hh, 2 * ww))], dim=2)
    else:
        x = _trilinear(x, (t, 2 * hh, 2 * ww))
    return _cconv(x, conv)


def _up_spatial(conv, x):
    """Nearest 2x in space, then the (1, 3, 3) conv (ref ``SpatialUpsample2x``)."""
    return _cconv(x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4), conv)


def _time_up2x(x):
    """Frame 0 kept, the others trilinear 2x over time only (ref
    ``TimeUpsample2x``)."""
    b, c, t, hh, ww = x.shape
    if t == 1:
        return x
    return torch.cat([x[:, :, :1], _trilinear(x[:, :, 1:], (2 * (t - 1), hh, ww))], dim=2)


class OSPCausalVAE(nn.Module):
    """Latents ``[B, F, H, W, embed_dim]`` -> pixels ``[B, F', 8H, 8W, 3]``
    f32 (F' = 1 + time_stride (F - 1)). Build on ``device``, then
    ``init(generator)`` for random weights or ``load_state_dict``
    (``models/convert.py``). The tiling constants are the reference's
    (``autoencoder_kl_open_sora_plan_v120.py:798-805``), attributes as in
    JAX."""

    def __init__(self, cfg: OSPVAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.post_quant_conv = (_conv(cfg.embed_dim, cfg.z_channels, 1, device)
                                if cfg.use_quant_layer else None)
        self.decoder = Decoder(cfg, device)
        self.tile_sample_min_size = 256
        self.tile_latent_min_size = 256 // (2 ** (len(cfg.chs) - 1))
        self.tile_latent_min_size_t = 16
        self.tile_overlap_factor = 0.125

    def init(self, generator: torch.Generator) -> "OSPCausalVAE":
        """Random weights from ``generator`` (on its device), drawn as
        ``init_osp_vae_params`` draws them (the draws themselves differ):
        conv weights ``N(0, 1/fan_in)``, zero biases, unit and zero norms."""
        init_convs_(self, generator)
        return self

    def _res(self, blk: ResBlock, x):
        g = self.cfg.groups
        h = _cconv(F.silu(group_norm(x, blk.norm1.weight, blk.norm1.bias, g)), blk.conv1)
        h = _cconv(F.silu(group_norm(h, blk.norm2.weight, blk.norm2.bias, g)), blk.conv2)
        if blk.nin_shortcut is not None:
            x = _cconv(x, blk.nin_shortcut)
        return x + h

    def _attn(self, blk: AttnBlock, x):
        """Single-head softmax attention over each frame's H*W tokens, scale
        C^-1/2, with 1x1x1 projections (ref ``AttnBlock3DFix``)."""
        b, c, t, hh, ww = x.shape
        h = group_norm(x, blk.norm.weight, blk.norm.bias, self.cfg.groups)
        tokens = h.permute(0, 2, 3, 4, 1).reshape(b * t, hh * ww, c)

        def proj(conv, y):
            return F.linear(y, conv.weight.reshape(c, c), conv.bias)

        q, k, v = (proj(conv, tokens) for conv in (blk.q, blk.k, blk.v))
        a = torch.softmax(torch.bmm(q, k.transpose(1, 2)) * c ** -0.5, dim=-1)
        o = proj(blk.proj_out, torch.bmm(a, v))
        return x + o.reshape(b, t, hh, ww, c).permute(0, 4, 1, 2, 3)

    def _decode_one(self, z: torch.Tensor) -> torch.Tensor:
        """Latents ``[B, C, T, H, W]`` -> pixels ``[B, 3, T', H', W']``."""
        cfg, p = self.cfg, self.decoder
        if self.post_quant_conv is not None:
            z = _cconv(z, self.post_quant_conv)
        h = _cconv(z, p.conv_in)
        h = self._res(p.mid["block_1"], h)
        h = self._attn(p.mid["attn_1"], h)
        h = self._res(p.mid["block_2"], h)
        for i in reversed(range(len(cfg.chs))):
            lv = p.up[i]
            for blk in lv.block:
                h = self._res(blk, h)
            if lv.upsample is not None:
                up = _up_s2t2 if cfg.up_types[i] == "s2t2" else _up_spatial
                h = up(lv.upsample, h)
            if cfg.time_up_types[i] == "time":
                h = _time_up2x(h)
        h = F.silu(group_norm(h, p.norm_out.weight, p.norm_out.bias, cfg.groups))
        return _cconv(h, p.conv_out)

    def _tiled_decode2d(self, z: torch.Tensor) -> torch.Tensor:
        """Overlapping ``tile_latent_min_size`` tiles of ``[B, C, T, H, W]``,
        blended over ``ext`` pixels and cropped at ``lim``."""
        tile = self.tile_latent_min_size
        ov = int(tile * (1 - self.tile_overlap_factor))
        ext = int(self.tile_sample_min_size * self.tile_overlap_factor)
        lim = self.tile_sample_min_size - ext
        rows = [[self._decode_one(z[:, :, :, i:i + tile, j:j + tile])
                 for j in range(0, z.shape[4], ov)]
                for i in range(0, z.shape[3], ov)]
        return stitch_tiles(rows, ext, lim)

    @torch.inference_mode()
    def decode(self, z: torch.Tensor, use_tiling: Optional[bool] = None) -> torch.Tensor:
        """Latents ``[B, F, H, W, C]`` -> pixels ``[B, F', H', W', 3]`` f32;
        tiled (time windows, then 2-D tiles) past the reference's thresholds
        unless ``use_tiling`` says otherwise."""
        dev = self.decoder.conv_in.weight.device
        z = z.to(device=dev, dtype=torch.float32).permute(0, 4, 1, 2, 3)
        if use_tiling is None:
            use_tiling = (z.shape[3] > self.tile_latent_min_size
                          or z.shape[4] > self.tile_latent_min_size
                          or z.shape[2] > self.tile_latent_min_size_t)
        if not use_tiling:
            out = self._decode_one(z)
        else:
            outs = []
            for i, (s, e) in enumerate(t_chunks(z.shape[2], self.tile_latent_min_size_t)):
                d = self._tiled_decode2d(z[:, :, s:e])
                outs.append(d[:, :, 1:] if i else d)
            out = torch.cat(outs, dim=2)
        return out.permute(0, 2, 3, 4, 1)


# ---- CausalVAEModel checkpoints --------------------------------------------------

def convert_osp_vae_state_dict(sd: dict, cfg: OSPVAEConfig) -> dict:
    """A ``CausalVAEModel`` state dict as the JAX OSP VAE tree: a
    ``CausalConv3d``'s kernel under ``<name>.conv``, an old 2-D
    ``Downsample``'s as a one-frame causal kernel."""
    from magcache_tpu_torch.models.checkpoint import vec

    def ccv(name):
        p = {"w": vec(sd, f"{name}.conv.weight").permute(2, 3, 4, 1, 0)}
        if f"{name}.conv.bias" in sd:
            p["b"] = vec(sd, f"{name}.conv.bias")
        return p

    def nm(name):
        return {"w": vec(sd, f"{name}.weight"), "b": vec(sd, f"{name}.bias")}

    def res(base):
        p = {"norm1": nm(f"{base}.norm1"), "conv1": ccv(f"{base}.conv1"),
             "norm2": nm(f"{base}.norm2"), "conv2": ccv(f"{base}.conv2")}
        if f"{base}.nin_shortcut.conv.weight" in sd:
            p["nin_shortcut"] = ccv(f"{base}.nin_shortcut")
        return p

    def mid(side):
        a = f"{side}.mid.attn_1"
        return {"block_1": res(f"{side}.mid.block_1"), "block_2": res(f"{side}.mid.block_2"),
                "attn_1": {"norm": nm(f"{a}.norm"), "q": ccv(f"{a}.q"), "k": ccv(f"{a}.k"),
                           "v": ccv(f"{a}.v"), "proj_out": ccv(f"{a}.proj_out")}}

    def updown(base):
        if f"{base}.conv.conv.weight" in sd:        # a CausalConv3d wrapper
            return ccv(f"{base}.conv")
        return {"w": vec(sd, f"{base}.conv.weight").permute(2, 3, 1, 0)[None],
                "b": vec(sd, f"{base}.conv.bias")}

    nlv = len(cfg.ch_mult)
    enc = {"conv_in": ccv("encoder.conv_in"), "mid": mid("encoder"),
           "norm_out": nm("encoder.norm_out"), "conv_out": ccv("encoder.conv_out"),
           "down": [{"block": [res(f"encoder.down.{i}.block.{j}")
                               for j in range(cfg.num_res_blocks)],
                     "downsample": (updown(f"encoder.down.{i}.downsample")
                                    if cfg.down_types[i] else None)} for i in range(nlv)]}
    dec = {"conv_in": ccv("decoder.conv_in"), "mid": mid("decoder"),
           "norm_out": nm("decoder.norm_out"), "conv_out": ccv("decoder.conv_out"),
           "up": [{"block": [res(f"decoder.up.{i}.block.{j}")
                             for j in range(cfg.num_res_blocks + 1)],
                   "upsample": (updown(f"decoder.up.{i}.upsample")
                                if cfg.up_types[i] else None)} for i in range(nlv)]}
    tree = {"encoder": enc, "decoder": dec}
    if cfg.use_quant_layer:
        tree["quant_conv"] = ccv("quant_conv")
        tree["post_quant_conv"] = ccv("post_quant_conv")
    return tree


def load_osp_vae_checkpoint(path: str, cfg: Optional[OSPVAEConfig] = None, device="cuda"
                            ) -> "OSPCausalVAE":
    """An ``OSPCausalVAE`` (the decoder) from a ``CausalVAEModel`` checkpoint;
    ``cfg`` defaults to ``OSPVAEConfig()``, as in JAX."""
    from magcache_tpu_torch.models.checkpoint import load_safetensors_dir
    from magcache_tpu_torch.models.convert import osp_vae_params_from_numpy

    cfg = cfg or OSPVAEConfig()
    vae = OSPCausalVAE(cfg, torch.device(device))
    vae.load_state_dict(osp_vae_params_from_numpy(
        convert_osp_vae_state_dict(load_safetensors_dir(path), cfg), cfg, device))
    return vae.requires_grad_(False)
