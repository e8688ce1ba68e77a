"""Latte T2V on Latte-1 + epsilon-prediction DDIM, MagCache-enabled.

The ``magcache_tpu.pipelines.latte`` pipeline (reference stack
``videosys/pipelines/latte/pipeline_latte.py``): T5 captions (optionally
cleaned twice), seeded noise latents, and the diffusers ``DDIMScheduler``
trajectory (linear betas 1e-4..0.02, eps prediction, eta = 0), whose step is
linear in (x, eps) and so runs as ``sample_euler(x_coeffs=c_x, dts=c_eps)``.
CFG is one joint batch of 2 rows ([cond, uncond]) under a single cache lane;
the head's first C channels (eps) are combined, the variance half dropped.

No MagCache ratios are published for Latte: the default is all ones, and the
flow is calibrate-then-install: a ``magcache_calibration`` request records
the norm ratios (joint single lane, steps - 1 entries) and
``magcache_ratios`` installs them (padded and resampled as
``prepare_mag_ratios(lanes=1)`` does). The checkpoint-free path:
``MockTextEncoder`` and random Latte weights from a seeded
``torch.Generator``. With ``vae=`` (an ``SDVAE`` of 4 latent channels and
stride 8, e.g. ``SD_VAE_FT``) ``from_latent`` undoes the VAE's scale and the
latents decode frame by frame into ``video`` (the JAX pipeline hands the
5-D latents to the 2-D decode unscaled); without one the latents are the
output. Pyramid Attention Broadcast
(``enable_pab``, ``pab_config``, default ``LATTE_PAB``) runs on every
route over the DDIM timesteps, alone or under MagCache.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from magcache_tpu_torch.core.magcache import MagCacheConfig, prepare_mag_ratios
from magcache_tpu_torch.core.pab import LATTE_PAB, PABConfig
from magcache_tpu_torch.core.sampler import lane_skip_masks, sample_euler
from magcache_tpu_torch.models.latte import (LATTE_1, LatteConfig, LatteModel,
                                             make_latte_core)
from magcache_tpu_torch.models.published import load_latte_checkpoint
from magcache_tpu_torch.models.text import MockTextEncoder
from magcache_tpu_torch.pipelines.base import (BasePipeline, PipelineOutput,
                                               calibration_dict, cfg_combine,
                                               check_image_vae, decode_pixels, synced_clock,
                                               timed_encode)
from magcache_tpu_torch.pipelines.open_sora_cond import clean_caption
from magcache_tpu_torch.schedulers.ddim_eps import DDIMEpsSchedule
from magcache_tpu_torch.utils.misc import set_seed

VAE_SPATIAL_STRIDE = 8


@dataclasses.dataclass
class LattePipelineConfig:
    num_frames: int = 16
    height: int = 512
    width: int = 512
    num_sampling_steps: int = 50
    guidance_scale: float = 7.5
    caption_len: int = 120
    use_magcache: bool = False
    # full-compute recording of the joint single-lane magnitude stats
    magcache_calibration: bool = False
    # recorded calibration ratios (num_steps - 1 entries); None = all ones
    magcache_ratios: Optional[tuple] = None
    magcache_thresh: float = 0.12
    magcache_K: int = 3
    retention_ratio: float = 0.2
    enable_pab: bool = False
    pab_config: Optional[PABConfig] = None   # None: LATTE_PAB
    dtype: str = "float32"
    tiny: bool = False
    ckpt_dir: Optional[str] = None     # a published transformer checkpoint
    # T5 caption cleaning, applied twice (pipeline_latte.py:296,342,519-526)
    clean_caption: bool = False
    # None -> 8 for the full model (eps + variance), the tiny default for tiny
    out_channels: Optional[int] = None
    # the model's block composition: "packed", "grouped" or "vpu"
    route: str = "packed"

    def model_config(self) -> LatteConfig:
        if self.tiny:
            kw = {} if self.out_channels is None else {"out_channels": self.out_channels}
            return LatteConfig.tiny(dtype=self.dtype, **kw)
        return dataclasses.replace(LATTE_1, dtype=self.dtype,
                                   out_channels=self.out_channels or 8)


class LattePipeline(BasePipeline):
    """Latte T2V on ``device`` (the card unless told otherwise). Without
    ``model``, Latte gets random weights from a generator seeded with
    ``init_seed``; a given ``model`` brings its own configuration (widths,
    caption dim). ``vae`` (an ``SDVAE``) must have the model's latent
    channels and stride 8."""

    def __init__(self, config: LattePipelineConfig, device="cuda", text_encoder=None,
                 model: Optional[LatteModel] = None, init_seed: int = 0, vae=None):
        self.config = config
        c = config
        self.device = torch.device(device)
        self.model_cfg = model.cfg if model is not None else c.model_config()
        check_image_vae(vae, self.model_cfg.in_channels, VAE_SPATIAL_STRIDE)
        self.vae = vae
        p = self.model_cfg.patch
        lat_h, lat_w = c.height // VAE_SPATIAL_STRIDE, c.width // VAE_SPATIAL_STRIDE
        self.latent_shape = (c.num_frames, lat_h, lat_w, self.model_cfg.in_channels)
        self.grid = (c.num_frames, lat_h // p, lat_w // p)
        self.schedule = DDIMEpsSchedule.create(c.num_sampling_steps)
        if model is None:
            model = LatteModel(self.model_cfg, self.device)
            if c.ckpt_dir:
                model.load_state_dict(load_latte_checkpoint(c.ckpt_dir, self.model_cfg))
            else:
                model.init(set_seed(init_seed, device=self.device))
        self.model = model.requires_grad_(False).eval()
        self.core = make_latte_core(
            self.model, self.grid, c.caption_len, route=c.route,
            pab=(c.pab_config or LATTE_PAB) if c.enable_pab else None,
            timesteps=self.schedule.timesteps.astype(np.float32))
        self.text_encoder = text_encoder or MockTextEncoder(
            c.caption_len, self.model_cfg.caption_dim, scale=0.5)

    def _cache_cfg_force(self, thresh=None, K=None, retention=None) -> MagCacheConfig:
        """The single-lane MagCacheConfig over the joint CFG batch whether or
        not ``use_magcache`` is set: the installed ratios (ones without
        ``magcache_ratios``) padded and resampled to the step count."""
        c = self.config
        ratios = c.magcache_ratios or tuple(np.ones(c.num_sampling_steps - 1))
        ratios = prepare_mag_ratios(np.asarray(ratios), c.num_sampling_steps, lanes=1)
        return MagCacheConfig(
            num_steps=c.num_sampling_steps, mag_ratios=tuple(ratios),
            thresh=c.magcache_thresh if thresh is None else thresh,
            max_consecutive_skips=c.magcache_K if K is None else K,
            retention_ratio=c.retention_ratio if retention is None else retention,
            lanes=1)

    def skip_mask_for(self, thresh=None, K=None, retention_ratio=None,
                      use_magcache: bool = True) -> np.ndarray:
        """Host-precomputed ``bool[steps, 1]`` skip mask for an E/K/R triple
        (one cache lane over the joint CFG batch); all-False without
        ``use_magcache``. Feed it to ``generate(skip_override=...)``."""
        if not use_magcache:
            return np.zeros((self.config.num_sampling_steps, 1), bool)
        return lane_skip_masks(self._cache_cfg_force(thresh, K, retention_ratio),
                               self.config.num_sampling_steps)[0]

    def _initial_noise(self, gen: torch.Generator) -> torch.Tensor:
        """The noise latents ``f32[1, T, H, W, C]`` on the CPU, drawn from the
        request's CPU generator, so every device gets the same draw."""
        return torch.randn((1,) + self.latent_shape, generator=gen, dtype=torch.float32)

    def generate(self, prompt: str, negative_prompt: str = "", seed: int = 0,
                 skip_override: Optional[np.ndarray] = None) -> PipelineOutput:
        """One video's latents ``f32[1, T, H, W, 4]`` (and with a VAE its
        pixels ``video f32[1, T, 8H, 8W, 3]``). ``skip_override``
        (``bool[steps, 1]``, from ``skip_mask_for``) replaces the cache
        schedule; ``skips`` holds the realized skip bits (none in
        calibration mode, which fills ``calibration``)."""
        t0 = time.time()
        c = self.config
        if c.clean_caption:
            prompt = clean_caption(clean_caption(prompt))
            if negative_prompt:
                negative_prompt = clean_caption(clean_caption(negative_prompt))
        y, text_s = timed_encode(self.text_encoder, [prompt, negative_prompt], self.device)
        cond = {"y": y}
        z = self._initial_noise(set_seed(seed)).to(self.device)
        c_x, c_eps = self.schedule.step_arrays()
        common = dict(timesteps=self.schedule.timesteps.astype(np.float32), dts=c_eps,
                      x_coeffs=c_x, lanes=2,
                      combine_fn=cfg_combine(c.guidance_scale, self.model_cfg.in_channels))
        calibration = skips = None
        if c.magcache_calibration:
            if skip_override is not None:
                raise ValueError("skip_override is a generation-path argument; "
                                 "calibration runs full compute")
            latents, stats = sample_euler(self.core, z, cond, calibrate=True,
                                          calibrate_lanes=1, **common)
            calibration = calibration_dict(stats)
        else:
            cache_cfg = self._cache_cfg_force() if c.use_magcache else None
            latents, skips = sample_euler(self.core, z, cond, cache_cfg=cache_cfg,
                                          skip_mask_override=skip_override,
                                          return_skips=True, **common)
        video, timings = decode_pixels(self.vae, latents)
        timings["text_s"] = text_s
        timings["total_s"] = synced_clock(latents) - t0
        return PipelineOutput(latents=latents, calibration=calibration, timings=timings,
                              skips=skips, video=video)
