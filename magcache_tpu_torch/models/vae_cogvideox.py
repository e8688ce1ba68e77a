"""CogVideoX's causal 3-D VAE decoder as PyTorch modules (the decode side of
``magcache_tpu.models.vae_cogvideox``; reference ``videosys/models/
autoencoders/autoencoder_kl_cogvideox.py``).

``conv_in``, two mid resnets, then per up block (deepest first)
``layers_per_block + 1`` resnets and, on every block but the last, an
upsample: nearest 2x in (t, h, w) on the first ``log2(temporal_compression)``
blocks (an odd frame count keeps frame 0 at one frame, resized in space
only), nearest 2x in space on the others, then a per-frame 3x3 conv; a
spatial norm, SiLU and ``conv_out`` to 3 pixel channels. Every norm is the
spatial norm ``GN(f) * conv_y(z~) + conv_b(z~)`` conditioned on the raw
latent z, nearest-resized to f's grid (frame 0 apart on an odd frame count;
the factors here are integers, which this module asserts, and there JAX's
``nearest`` resize and a repeat agree). The causal convs are
``models.vae.causal_conv3d`` (the reference's ``CausalConv3d`` at stride
1): the first frame replicated ``kt - 1`` times in front, or the carried
cache, the last ``kt - 1`` frames of the previous slice's padded input.

``decode_tiled`` is the reference's ``tiled_decode``: overlapping 32x32
latent tiles (overlap 1/4), each decoded in slices of ``frame_batch``
latent frames (the first slice ``frame_batch + T % frame_batch``) with the
conv caches carried from slice to slice, then blended over 64 pixel rows
and columns and cropped. GroupNorm's statistics span a slice's frames, so a
sliced decode is not the whole-clip ``decode``.

NCDHW inside; latents ``[B, F, H, W, C]`` and pixels ``[B, F, H, W, 3]`` f32
at the API; every weight and activation f32 (the JAX module's). Latents are
unscaled: the pipeline divides by ``cfg.scaling_factor``. The encoder is
not ported; ``models.convert.cogvideox_vae_params_from_numpy`` carries the
JAX tree's decoder over, and ``load_cogvideox_vae_checkpoint`` reads a
diffusers ``AutoencoderKLCogVideoX`` checkpoint
(``convert_cogvideox_vae_state_dict``; the decoder is kept).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from magcache_tpu_torch.models.vae import (GroupNormAffine, causal_conv3d, group_norm,
                                           init_convs_, stitch_tiles)

__all__ = ["CogVideoXVAEConfig", "CogVideoXVAE"]


@dataclasses.dataclass(frozen=True)
class CogVideoXVAEConfig:
    in_channels: int = 3
    z_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    layers_per_block: int = 3
    temporal_compression: int = 4
    groups: int = 32
    eps: float = 1e-6
    scaling_factor: float = 1.15258426   # the JAX default, commented "(2b)" there
    # tiling (decode): latent tile side + overlap fraction
    tile_latent: int = 32
    tile_overlap: float = 0.25
    frame_batch: int = 2                 # num_latent_frames_batch_size

    @property
    def temporal_levels(self) -> int:
        return int(math.log2(self.temporal_compression))

    @property
    def space_stride(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    @staticmethod
    def tiny(**kw) -> "CogVideoXVAEConfig":
        d = dict(block_out_channels=(8, 16), layers_per_block=1, z_channels=4, groups=4,
                 temporal_compression=2, tile_latent=4, tile_overlap=0.25)
        d.update(kw)
        return CogVideoXVAEConfig(**d)


def _conv(x: torch.Tensor, conv: nn.Conv3d, cache=None):
    return causal_conv3d(x, conv.weight, conv.bias, tcache=cache)


def _conv2d_frames(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A 'same' Conv2d on every frame of ``x [B, C, T, H, W]``."""
    kh, kw = conv.weight.shape[2:]
    return F.conv3d(x, conv.weight.unsqueeze(2), conv.bias, padding=(0, kh // 2, kw // 2))


def _nearest_x2(x: torch.Tensor, dims) -> torch.Tensor:
    for d in dims:
        x = x.repeat_interleave(2, dim=d)
    return x


def _time_upsample2(x: torch.Tensor) -> torch.Tensor:
    """compress_time upsample: nearest 2x in (t, h, w); an odd frame count
    (above one) keeps frame 0 at one frame, resized in space only."""
    t = x.shape[2]
    if t > 1 and t % 2 == 1:
        return torch.cat([_nearest_x2(x[:, :, :1], (3, 4)), _nearest_x2(x[:, :, 1:], (2, 3, 4))],
                         dim=2)
    return _nearest_x2(x, (2, 3, 4) if t > 1 else (3, 4))


def _resize_nearest(z: torch.Tensor, size) -> torch.Tensor:
    """Nearest resize of ``z [B, C, T, H, W]`` to ``size`` (T, H, W) by integer
    factors (a repeat)."""
    for dim, n in zip((2, 3, 4), size):
        if n % z.shape[dim]:
            raise ValueError(f"nearest resize {tuple(z.shape[2:])} -> {tuple(size)}: "
                             f"not an integer factor")
        z = z.repeat_interleave(n // z.shape[dim], dim=dim)
    return z


class SpatialNorm(nn.Module):
    def __init__(self, c, zc, device):
        super().__init__()
        self.norm = GroupNormAffine(c, device)
        self.conv_y = nn.Conv3d(zc, c, 1, device=device)
        self.conv_b = nn.Conv3d(zc, c, 1, device=device)


class ResNet(nn.Module):
    def __init__(self, cin, cout, zc, device):
        super().__init__()
        self.conv1 = nn.Conv3d(cin, cout, 3, device=device)
        self.conv2 = nn.Conv3d(cout, cout, 3, device=device)
        self.norm1, self.norm2 = SpatialNorm(cin, zc, device), SpatialNorm(cout, zc, device)
        self.shortcut = nn.Conv3d(cin, cout, 1, device=device) if cin != cout else None


class UpBlock(nn.Module):
    def __init__(self, cin, cout, n, zc, last, device):
        super().__init__()
        self.resnets = nn.ModuleList(ResNet(cin if j == 0 else cout, cout, zc, device)
                                     for j in range(n))
        self.up = None if last else nn.Conv2d(cout, cout, 3, device=device)


class Decoder(nn.Module):
    def __init__(self, cfg: CogVideoXVAEConfig, device):
        super().__init__()
        rev, zc = list(reversed(cfg.block_out_channels)), cfg.z_channels
        self.conv_in = nn.Conv3d(zc, rev[0], 3, device=device)
        self.mid = nn.ModuleList(ResNet(rev[0], rev[0], zc, device) for _ in range(2))
        cin = rev[0]
        for i, cout in enumerate(rev):
            self.add_module(f"up{i}", UpBlock(cin, cout, cfg.layers_per_block + 1, zc,
                                              i == len(rev) - 1, device))
            cin = cout
        self.norm_out = SpatialNorm(rev[-1], zc, device)
        self.conv_out = nn.Conv3d(rev[-1], cfg.in_channels, 3, device=device)


class CogVideoXVAE(nn.Module):
    """Latents ``[B, F, H, W, z]`` -> pixels ``[B, F', 8H, 8W, 3]`` f32. Build
    on ``device``, then ``init(generator)`` for random weights or
    ``load_state_dict`` (``models/convert.py``)."""

    def __init__(self, cfg: CogVideoXVAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.decoder = Decoder(cfg, device)

    def init(self, generator: torch.Generator) -> "CogVideoXVAE":
        """Random weights from ``generator`` (on its device), drawn as
        ``init_cogvideox_vae_params`` draws them (the draws themselves
        differ): conv weights ``N(0, 1/fan_in)``, zero biases, unit and zero
        norms."""
        init_convs_(self, generator)
        return self

    def _spatial_norm(self, f, zq, m: SpatialNorm, caches: dict, name: str):
        ft, fh, fw = f.shape[2:]
        if ft > 1 and ft % 2 == 1:
            zq = torch.cat([_resize_nearest(zq[:, :, :1], (1, fh, fw)),
                            _resize_nearest(zq[:, :, 1:], (ft - 1, fh, fw))], dim=2)
        else:
            zq = _resize_nearest(zq, (ft, fh, fw))
        y, caches[name + "/y"] = _conv(zq, m.conv_y, caches.get(name + "/y"))
        b, caches[name + "/b"] = _conv(zq, m.conv_b, caches.get(name + "/b"))
        cfg = self.cfg
        return group_norm(f, m.norm.weight, m.norm.bias, cfg.groups, cfg.eps) * y + b

    def _resnet(self, r: ResNet, x, zq, caches: dict, name: str):
        h = F.silu(self._spatial_norm(x, zq, r.norm1, caches, name + "/n1"))
        h, caches[name + "/c1"] = _conv(h, r.conv1, caches.get(name + "/c1"))
        h = F.silu(self._spatial_norm(h, zq, r.norm2, caches, name + "/n2"))
        h, caches[name + "/c2"] = _conv(h, r.conv2, caches.get(name + "/c2"))
        if r.shortcut is not None:
            x, _ = _conv(x, r.shortcut)
        return x + h

    def _decode_core(self, z: torch.Tensor, caches: Dict[str, torch.Tensor]):
        """Latents ``[B, z, T, H, W]`` -> (pixels ``[B, 3, T', H', W']``,
        caches). ``caches`` holds the previous slice's conv caches (empty at
        clip start) and is updated in place."""
        cfg, p = self.cfg, self.decoder
        h, caches["d_in"] = _conv(z, p.conv_in, caches.get("d_in"))
        for j, r in enumerate(p.mid):
            h = self._resnet(r, h, z, caches, f"dm{j}")
        for i in range(len(cfg.block_out_channels)):
            blk = getattr(p, f"up{i}")
            for j, r in enumerate(blk.resnets):
                h = self._resnet(r, h, z, caches, f"d{i}{j}")
            if blk.up is not None:
                h = _time_upsample2(h) if i < cfg.temporal_levels else _nearest_x2(h, (3, 4))
                h = _conv2d_frames(h, blk.up)
        h = F.silu(self._spatial_norm(h, z, p.norm_out, caches, "d_no"))
        h, caches["d_out"] = _conv(h, p.conv_out, caches.get("d_out"))
        return h, caches

    def _to_ncdhw(self, z: torch.Tensor) -> torch.Tensor:
        dev = self.decoder.conv_in.weight.device
        return z.to(device=dev, dtype=torch.float32).permute(0, 4, 1, 2, 3)

    @torch.inference_mode()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """The whole clip in one pass: latents ``[B, F, H, W, z]`` -> pixels
        ``[B, F', H', W', 3]`` f32."""
        return self._decode_core(self._to_ncdhw(z), {})[0].permute(0, 2, 3, 4, 1)

    def _decode_sliced(self, z: torch.Tensor) -> torch.Tensor:
        """One tile ``[B, C, T, h, w]`` in slices of ``frame_batch`` latent
        frames (the first ``frame_batch + T % frame_batch``) with the conv
        caches carried."""
        fb, t = self.cfg.frame_batch, z.shape[2]
        if t <= fb:
            return self._decode_core(z, {})[0]
        caches: Dict[str, torch.Tensor] = {}
        outs, s0 = [], 0
        while s0 < t:
            n = fb + t % fb if s0 == 0 else fb
            out, caches = self._decode_core(z[:, :, s0:s0 + n], caches)
            outs.append(out)
            s0 += n
        return torch.cat(outs, dim=2)

    @torch.inference_mode()
    def decode_tiled(self, z: torch.Tensor) -> torch.Tensor:
        """The memory-capped decode (the reference's ``tiled_decode``):
        latents ``[B, F, H, W, z]`` -> pixels ``[B, F', 8H, 8W, 3]`` f32."""
        cfg = self.cfg
        z = self._to_ncdhw(z)
        h_lat, w_lat = z.shape[3:]
        sp, tile = cfg.space_stride, cfg.tile_latent
        overlap = int(tile * (1 - cfg.tile_overlap))
        blend_px = int(tile * sp * cfg.tile_overlap)
        limit = tile * sp - blend_px
        rows = [[self._decode_sliced(z[:, :, :, i:i + tile, j:j + tile])
                 for j in range(0, w_lat, overlap)]
                for i in range(0, h_lat, overlap)]
        out = stitch_tiles(rows, blend_px, limit)[:, :, :, :h_lat * sp, :w_lat * sp]
        return out.permute(0, 2, 3, 4, 1)


# ---- diffusers AutoencoderKLCogVideoX checkpoints ----------------------------------

def convert_cogvideox_vae_state_dict(sd: dict, cfg: CogVideoXVAEConfig) -> dict:
    """A diffusers ``AutoencoderKLCogVideoX`` state dict as the JAX CogVideoX
    VAE tree (a ``CausalConv3d`` under ``<name>.conv``, the 1x1 shortcut a
    bare Conv3d; the decoder's spatial norms with ``conv_y`` / ``conv_b``)."""
    from magcache_tpu_torch.models.checkpoint import vec

    def c3(name):
        return {"w": vec(sd, f"{name}.weight").permute(2, 3, 4, 1, 0), "b": vec(sd, f"{name}.bias")}

    def c2(name):
        return {"w": vec(sd, f"{name}.weight").permute(2, 3, 1, 0), "b": vec(sd, f"{name}.bias")}

    def gn(name):
        return {"w": vec(sd, f"{name}.weight"), "b": vec(sd, f"{name}.bias")}

    def spatial_norm(name):
        return {"norm": gn(f"{name}.norm_layer"), "conv_y": c3(f"{name}.conv_y.conv"),
                "conv_b": c3(f"{name}.conv_b.conv")}

    def resnet(name, spatial):
        p = {"conv1": c3(f"{name}.conv1.conv"), "conv2": c3(f"{name}.conv2.conv")}
        for nm in ("norm1", "norm2"):
            p[nm] = spatial_norm(f"{name}.{nm}") if spatial else gn(f"{name}.{nm}")
        if f"{name}.conv_shortcut.weight" in sd:
            p["shortcut"] = c3(f"{name}.conv_shortcut")
        return p

    def sampler(base):
        return c2(f"{base}.0.conv") if f"{base}.0.conv.weight" in sd else None

    n = len(cfg.block_out_channels)
    enc = {"conv_in": c3("encoder.conv_in.conv"),
           "mid": [resnet(f"encoder.mid_block.resnets.{j}", False) for j in range(2)],
           "norm_out": gn("encoder.norm_out"), "conv_out": c3("encoder.conv_out.conv")}
    for i in range(n):
        enc[f"down{i}"] = {"resnets": [resnet(f"encoder.down_blocks.{i}.resnets.{j}", False)
                                       for j in range(cfg.layers_per_block)],
                           "down": sampler(f"encoder.down_blocks.{i}.downsamplers")}
    dec = {"conv_in": c3("decoder.conv_in.conv"),
           "mid": [resnet(f"decoder.mid_block.resnets.{j}", True) for j in range(2)],
           "norm_out": spatial_norm("decoder.norm_out"), "conv_out": c3("decoder.conv_out.conv")}
    for i in range(n):
        dec[f"up{i}"] = {"resnets": [resnet(f"decoder.up_blocks.{i}.resnets.{j}", True)
                                     for j in range(cfg.layers_per_block + 1)],
                         "up": sampler(f"decoder.up_blocks.{i}.upsamplers")}
    return {"encoder": enc, "decoder": dec}


def load_cogvideox_vae_checkpoint(path: str, cfg: Optional[CogVideoXVAEConfig] = None,
                                  device="cuda") -> "CogVideoXVAE":
    """A ``CogVideoXVAE`` (the decoder) from a diffusers ``vae/`` checkpoint;
    ``cfg`` defaults to ``CogVideoXVAEConfig()``, as the JAX CLI builds it."""
    from magcache_tpu_torch.models.checkpoint import load_safetensors_dir
    from magcache_tpu_torch.models.convert import cogvideox_vae_params_from_numpy

    cfg = cfg or CogVideoXVAEConfig()
    vae = CogVideoXVAE(cfg, torch.device(device))
    vae.load_state_dict(cogvideox_vae_params_from_numpy(
        convert_cogvideox_vae_state_dict(load_safetensors_dir(path), cfg), cfg, device))
    return vae.requires_grad_(False)
