"""CogVideoX T2V on zero-terminal-SNR DDIM (v-prediction), MagCache-enabled.

The ``magcache_tpu.pipelines.cogvideox`` pipeline (reference stack
``videosys/pipelines/cogvideox/pipeline_cogvideox.py``): T5 captions, seeded
noise latents, and the CogVideoX DDIM trajectory, whose eta = 0 step is
linear in (x, v) and so runs as ``sample_euler(x_coeffs=c_x, dts=c_v)``.
CFG is 2 sampler lanes ([cond, uncond]) under one cache lane (the joint
batch); ``use_dynamic_cfg`` ramps the guidance per step (``1 + g * (1 -
cos(pi * ((steps - t) / steps) ** 5)) / 2`` with t the timestep's value,
the reference's formula as written) through a step-indexed ``combine_fn``.

No MagCache ratios are published for CogVideoX: the default is all ones, and
the flow is calibrate-then-install (``magcache_calibration`` records one
joint lane, steps - 1 entries; ``magcache_ratios`` installs them as
``prepare_mag_ratios(lanes=1)`` does). ``skip_mask_for`` and
``generate(skip_override=)`` run any E/K/R triple's mask; a dynamic-CFG or
calibration request with an override raises ``ValueError``. PAB
(``enable_pab``, ``pab_config``, default ``COGVIDEOX_PAB``) runs alone or
under MagCache. The checkpoint-free path: ``MockTextEncoder``, random weights
from a seeded ``torch.Generator``; latents are the output unless a VAE is
given (``vae=``, a ``CogVideoXVAE``: the latents divided by its
``scaling_factor`` go through ``decode_tiled`` into ``video``, timed in
``timings["decode_s"]``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from magcache_tpu_torch.core.magcache import MagCacheConfig, prepare_mag_ratios
from magcache_tpu_torch.core.pab import COGVIDEOX_PAB, PABConfig
from magcache_tpu_torch.core.sampler import sample_euler
from magcache_tpu_torch.models.cogvideox import (CogVideoXConfig, CogVideoXModel,
                                                 make_cogvideox_core)
from magcache_tpu_torch.models.text import MockTextEncoder
from magcache_tpu_torch.pipelines.base import (BasePipeline, PipelineOutput,
                                               calibration_dict, cfg_combine, synced_clock,
                                               timed_encode)
from magcache_tpu_torch.schedulers.ddim_cogvideo import CogVideoDDIMSchedule
from magcache_tpu_torch.utils.misc import set_seed

# the CogVideoX VAE's strides: 4 in time, 8 in space
VAE_TEMPORAL_STRIDE, VAE_SPATIAL_STRIDE = 4, 8


@dataclasses.dataclass
class CogVideoXPipelineConfig:
    num_frames: int = 49
    height: int = 480
    width: int = 720
    num_inference_steps: int = 50
    guidance_scale: float = 6.0
    # per-step cosine-ramped guidance, host-precomputed per step
    use_dynamic_cfg: bool = False
    txt_len: int = 226
    use_magcache: bool = False
    magcache_ratios: Optional[tuple] = None   # recorded ratios; None = all ones
    # full-compute recording of the joint single-lane magnitude stats
    magcache_calibration: bool = False
    magcache_thresh: float = 0.12
    magcache_K: int = 3
    retention_ratio: float = 0.2
    enable_pab: bool = False
    pab_config: Optional[PABConfig] = None   # None: COGVIDEOX_PAB
    dtype: str = "float32"
    tiny: bool = False

    def model_config(self) -> CogVideoXConfig:
        if self.tiny:
            return CogVideoXConfig.tiny(dtype=self.dtype)
        return CogVideoXConfig(dtype=self.dtype)


class CogVideoXPipeline(BasePipeline):
    """CogVideoX T2V on ``device`` (the card unless told otherwise). Without
    ``model``, the transformer gets random weights from a generator (on the
    device) seeded with ``init_seed``; a given ``model`` brings its own
    configuration. ``vae`` (a ``CogVideoXVAE``) must have the latents'
    strides, and the latents an odd frame count."""

    def __init__(self, config: CogVideoXPipelineConfig, device="cuda", text_encoder=None,
                 model: Optional[CogVideoXModel] = None, init_seed: int = 0, vae=None):
        c = self.config = config
        if vae is not None and (vae.cfg.temporal_compression, vae.cfg.space_stride) != (
                VAE_TEMPORAL_STRIDE, VAE_SPATIAL_STRIDE):
            raise ValueError(f"the VAE's strides (time {vae.cfg.temporal_compression}, space "
                             f"{vae.cfg.space_stride}) are not the latents' "
                             f"({VAE_TEMPORAL_STRIDE}, {VAE_SPATIAL_STRIDE})")
        self.vae = vae
        self.device = torch.device(device)
        self.model_cfg = model.cfg if model is not None else c.model_config()
        lat_t = (c.num_frames - 1) // VAE_TEMPORAL_STRIDE + 1
        lat_h, lat_w = c.height // VAE_SPATIAL_STRIDE, c.width // VAE_SPATIAL_STRIDE
        p = self.model_cfg.patch
        self.latent_shape = (lat_t, lat_h, lat_w, self.model_cfg.in_channels)
        self.grid = (lat_t, lat_h // p, lat_w // p)
        if vae is not None and lat_t % 2 == 0:
            # the VAE keeps frame 0 apart only in an odd first slice
            raise ValueError(f"{c.num_frames} frames are {lat_t} latent frames, which the "
                             f"CogVideoX VAE decodes to {4 * lat_t} frames, not "
                             f"{1 + 4 * (lat_t - 1)}: take num_frames = 1 (mod 8)")
        self.schedule = CogVideoDDIMSchedule.create(c.num_inference_steps)
        if model is None:
            model = CogVideoXModel(self.model_cfg, self.device).init(
                set_seed(init_seed, device=self.device))
        self.model = model.requires_grad_(False).eval()
        self.core = make_cogvideox_core(
            self.model, c.txt_len, self.grid,
            pab=(c.pab_config or COGVIDEOX_PAB) if c.enable_pab else None,
            timesteps=self.schedule.timesteps.astype(np.float32))
        self.text_encoder = text_encoder or MockTextEncoder(c.txt_len, self.model_cfg.text_dim,
                                                            scale=0.5)

    def _cache_cfg_force(self, thresh=None, K=None, retention=None) -> MagCacheConfig:
        """The single-lane MagCacheConfig over the joint CFG batch whether or
        not ``use_magcache`` is set: the installed ratios (ones without
        ``magcache_ratios``) padded and resampled to the step count."""
        c = self.config
        ratios = c.magcache_ratios or tuple(np.ones(c.num_inference_steps - 1))
        ratios = prepare_mag_ratios(np.asarray(ratios), c.num_inference_steps, lanes=1)
        return MagCacheConfig(
            num_steps=c.num_inference_steps, mag_ratios=tuple(ratios),
            thresh=c.magcache_thresh if thresh is None else thresh,
            max_consecutive_skips=c.magcache_K if K is None else K,
            retention_ratio=c.retention_ratio if retention is None else retention,
            lanes=1)

    def skip_mask_for(self, thresh=None, K=None, retention_ratio=None,
                      use_magcache: bool = True) -> np.ndarray:
        """Host-precomputed ``bool[steps, 1]`` skip mask for an E/K/R triple
        (one cache lane over the joint CFG batch); all False without
        ``use_magcache``. Feed it to ``generate(skip_override=...)``."""
        return self._skip_mask_from_cfg(self._cache_cfg_force(thresh, K, retention_ratio),
                                        use_magcache)

    def guidance_scales(self) -> np.ndarray:
        """``f32[steps]``: the dynamic-CFG ramp over the schedule's
        timesteps (the constant guidance without ``use_dynamic_cfg``)."""
        c = self.config
        n, g = c.num_inference_steps, c.guidance_scale
        if not c.use_dynamic_cfg:
            return np.full(n, g, np.float32)
        return np.array([1 + g * (1 - math.cos(math.pi * ((n - float(t)) / n) ** 5.0)) / 2
                         for t in self.schedule.timesteps], np.float32)

    def _combine(self):
        if not self.config.use_dynamic_cfg:
            return cfg_combine(self.config.guidance_scale)
        gs = self.guidance_scales()

        def dynamic(chunks, step_idx):
            cond_o, uncond_o = chunks
            return uncond_o + float(gs[step_idx]) * (cond_o - uncond_o)

        return dynamic

    def _initial_noise(self, gen: torch.Generator) -> torch.Tensor:
        """The noise latents ``f32[1, T, H, W, C]`` on the CPU, drawn from the
        request's CPU generator, so every device gets the same draw."""
        return torch.randn((1,) + self.latent_shape, generator=gen, dtype=torch.float32)

    def generate(self, prompt: str, negative_prompt: str = "", seed: int = 42,
                 skip_override: Optional[np.ndarray] = None) -> PipelineOutput:
        """One video's latents ``f32[1, T, H, W, 16]`` (and with a VAE its
        pixels ``f32[1, 1 + 4 (T - 1), 8H, 8W, 3]``). ``skip_override``
        (``bool[steps, 1]``, from ``skip_mask_for``) replaces the cache
        schedule on the static-CFG path; ``skips`` holds the realized skip
        bits (none in calibration mode, which fills ``calibration``)."""
        t0 = time.time()
        c = self.config
        if skip_override is not None and (c.use_dynamic_cfg or c.magcache_calibration):
            raise ValueError("skip_override is a generation-path argument of the "
                             "static-CFG pipeline (not with use_dynamic_cfg or "
                             "magcache_calibration)")
        states, text_s = timed_encode(self.text_encoder, [prompt, negative_prompt],
                                      self.device)
        cond = {"txt": states}
        z = self._initial_noise(set_seed(seed)).to(self.device)
        c_x, c_v = self.schedule.step_arrays()
        common = dict(timesteps=self.schedule.timesteps.astype(np.float32), dts=c_v,
                      x_coeffs=c_x, lanes=2, combine_fn=self._combine())
        calibration = skips = None
        if c.magcache_calibration:
            latents, stats = sample_euler(self.core, z, cond, calibrate=True,
                                          calibrate_lanes=1, **common)
            calibration = calibration_dict(stats)
        else:
            cache_cfg = (self._cache_cfg_force()
                         if c.use_magcache or skip_override is not None else None)
            latents, skips = sample_euler(self.core, z, cond, cache_cfg=cache_cfg,
                                          skip_mask_override=skip_override,
                                          return_skips=True, **common)
        timings, video = {"text_s": text_s}, None
        if self.vae is not None:
            t1 = synced_clock(latents)
            video = self.vae.decode_tiled(latents / self.vae.cfg.scaling_factor)
            timings["decode_s"] = synced_clock(video) - t1
        timings["total_s"] = synced_clock(latents) - t0
        return PipelineOutput(latents=latents, calibration=calibration, timings=timings,
                              skips=skips, video=video)
