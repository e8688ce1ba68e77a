"""Vchitect-XL T2V on FlowMatch-Euler, MagCache-enabled.

The ``magcache_tpu.pipelines.vchitect`` pipeline (reference stack
``videosys/pipelines/vchitect/pipeline_vchitect.py``): text states and a
pooled vector, the FlowMatch Euler schedule (100 steps, shift 1.0, guidance
7.5) through ``sample_euler(timesteps=, dts=diff(sigmas))``, CFG as 2
batched sampler lanes ([cond, uncond]) and MagCache caching each lane
(``lanes=2``, ``num_steps`` = 2 x steps) on flat ratios or recorded ones
(``prepare_mag_ratios``). Calibration records both lanes on the same
trajectory. PAB (``enable_pab``) broadcasts the spatial (range 2) and
temporal (range 4) attentions inside (100, 800), and not the cross one, as
the JAX pipeline configures it.

The checkpoint-free path: ``MockTextEncoder`` (77 x 4096) and
``MockPooledEncoder`` (2048) by default, or ``models.text.Sd3TextStack``'s
``context`` and ``pooled`` (with ``txt_len`` 77 + 256), random weights from
a seeded ``torch.Generator``, and the request's initial noise from its seeded CPU
generator (the same draws on every device). With ``vae=`` (an ``SDVAE`` of
16 latent channels and stride 8, e.g. ``SD3_VAE``) ``from_latent`` undoes the
VAE's shift and scale and the latents decode frame by frame into ``video``
(the JAX pipeline hands the 5-D latents to the 2-D decode unscaled);
without one the latents are the output.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from magcache_tpu_torch.core.magcache import MagCacheConfig, prepare_mag_ratios
from magcache_tpu_torch.core.pab import PABConfig
from magcache_tpu_torch.core.sampler import lane_skip_masks, sample_euler
from magcache_tpu_torch.models.text import MockPooledEncoder, MockTextEncoder
from magcache_tpu_torch.models.vchitect import (VchitectConfig, VchitectModel,
                                                make_vchitect_core)
from magcache_tpu_torch.pipelines.base import (BasePipeline, PipelineOutput,
                                               calibration_dict, check_image_vae,
                                               decode_pixels, synced_clock, timed_encode)
from magcache_tpu_torch.schedulers.flow_match import FlowMatchSchedule
from magcache_tpu_torch.utils.misc import set_seed

# the SD VAE's spatial stride (the latents keep every frame)
VAE_SPATIAL_STRIDE = 8


@dataclasses.dataclass
class VchitectPipelineConfig:
    num_frames: int = 40
    height: int = 480
    width: int = 768
    num_inference_steps: int = 100
    guidance_scale: float = 7.5
    txt_len: int = 77
    sample_shift: float = 1.0            # FlowMatch shift (SD3 default 1.0)
    use_magcache: bool = False
    # full-compute recording of both lanes' magnitude stats
    magcache_calibration: bool = False
    magcache_ratios: Optional[tuple] = None   # recorded ratios; None = all ones
    magcache_thresh: float = 0.12
    magcache_K: int = 3
    retention_ratio: float = 0.2
    # PAB: spatial and temporal broadcast, no cross (the JAX pipeline's)
    enable_pab: bool = False
    pab_spatial_range: int = 2
    pab_temporal_range: int = 4
    pab_threshold: tuple = (100, 800)
    dtype: str = "float32"
    tiny: bool = False

    def model_config(self) -> VchitectConfig:
        if self.tiny:
            return VchitectConfig.tiny(dtype=self.dtype)
        return VchitectConfig(dtype=self.dtype)

    def pab(self) -> PABConfig:
        return PABConfig(spatial_broadcast=True, spatial_threshold=self.pab_threshold,
                         spatial_range=self.pab_spatial_range, temporal_broadcast=True,
                         temporal_threshold=self.pab_threshold,
                         temporal_range=self.pab_temporal_range)


class VchitectPipeline(BasePipeline):
    """Vchitect-XL T2V on ``device`` (the card unless told otherwise).
    Without ``model``, the transformer gets random weights from a generator
    (on the device) seeded with ``init_seed``; a given ``model`` brings its
    own configuration. ``vae`` (an ``SDVAE``) must have the model's latent
    channels and stride 8."""

    def __init__(self, config: VchitectPipelineConfig, device="cuda", text_encoder=None,
                 pooled_encoder=None, model: Optional[VchitectModel] = None,
                 init_seed: int = 0, vae=None):
        c = self.config = config
        self.device = torch.device(device)
        self.model_cfg = model.cfg if model is not None else c.model_config()
        check_image_vae(vae, self.model_cfg.in_channels, VAE_SPATIAL_STRIDE)
        self.vae = vae
        p = self.model_cfg.patch
        lat_h, lat_w = c.height // VAE_SPATIAL_STRIDE, c.width // VAE_SPATIAL_STRIDE
        self.latent_shape = (c.num_frames, lat_h, lat_w, self.model_cfg.in_channels)
        self.grid = (c.num_frames, lat_h // p, lat_w // p)
        self.schedule = FlowMatchSchedule.create(c.num_inference_steps, shift=c.sample_shift)
        if model is None:
            model = VchitectModel(self.model_cfg, self.device).init(
                set_seed(init_seed, device=self.device))
        self.model = model.requires_grad_(False).eval()
        self.core = make_vchitect_core(self.model, self.grid, c.txt_len,
                                       pab=c.pab() if c.enable_pab else None,
                                       timesteps=self.schedule.timesteps)
        self.text_encoder = text_encoder or MockTextEncoder(c.txt_len, self.model_cfg.text_dim,
                                                            scale=0.5)
        self.pooled_encoder = pooled_encoder or MockPooledEncoder(self.model_cfg.vec_dim)

    def _cache_cfg(self) -> Optional[MagCacheConfig]:
        """The 2-lane MagCacheConfig (``num_steps`` = 2 x steps), or None
        without ``use_magcache`` or when calibrating."""
        c = self.config
        if not c.use_magcache or c.magcache_calibration:
            return None
        n = c.num_inference_steps * 2
        ratios = (np.ones(n) if c.magcache_ratios is None else
                  prepare_mag_ratios(np.asarray(c.magcache_ratios), n, lanes=2))
        return MagCacheConfig(num_steps=n, mag_ratios=tuple(ratios), thresh=c.magcache_thresh,
                              max_consecutive_skips=c.magcache_K,
                              retention_ratio=c.retention_ratio, lanes=2)

    def skip_mask_for(self) -> np.ndarray:
        """The host-precomputed skip bits a request realizes: ``bool[steps,
        2]`` under MagCache, ``bool[steps, 1]`` of False without."""
        return lane_skip_masks(self._cache_cfg(), self.config.num_inference_steps)[0]

    def _initial_noise(self, gen: torch.Generator) -> torch.Tensor:
        """The noise latents ``f32[1, T, H, W, C]`` on the CPU, drawn from the
        request's CPU generator, so every device gets the same draw."""
        return torch.randn((1,) + self.latent_shape, generator=gen, dtype=torch.float32)

    def generate(self, prompt: str, negative_prompt: str = "", seed: int = 0
                 ) -> PipelineOutput:
        """One video's latents ``f32[1, T, H/8, W/8, 16]`` (and with a VAE its
        pixels ``video f32[1, T, H, W, 3]``); ``skips`` holds
        the realized skip bits ``bool[steps, 2]`` (none in calibration mode,
        which fills ``calibration``)."""
        t0 = time.time()
        c = self.config
        prompts = [prompt, negative_prompt]
        txt, txt_s = timed_encode(self.text_encoder, prompts, self.device)
        vec, vec_s = timed_encode(self.pooled_encoder, prompts, self.device)
        cond = {"txt": txt, "vec": vec}
        z = self._initial_noise(set_seed(seed)).to(self.device)
        sch = self.schedule
        common = dict(timesteps=sch.timesteps, dts=np.diff(sch.sigmas),
                      guidance_scale=c.guidance_scale)
        calibration = skips = None
        if c.magcache_calibration:
            latents, stats = sample_euler(self.core, z, cond, calibrate=True, **common)
            calibration = calibration_dict(stats)
        else:
            latents, skips = sample_euler(self.core, z, cond, cache_cfg=self._cache_cfg(),
                                          return_skips=True, **common)
        video, timings = decode_pixels(self.vae, latents)
        timings["text_s"] = txt_s + vec_s
        timings["total_s"] = synced_clock(latents) - t0
        return PipelineOutput(latents=latents, calibration=calibration, timings=timings,
                              skips=skips, video=video)
