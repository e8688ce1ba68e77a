"""Open-Sora-Plan T2V pipeline (v1.1 and v1.2), MagCache-enabled.

The ``magcache_tpu.pipelines.open_sora_plan`` pipeline (reference stack
``videosys/pipelines/open_sora_plan/pipeline_open_sora_plan.py``, version
switch :173-206):

- ``version="v120"``: the full 3-D attention transformer
  (``models.open_sora_plan``) with Euler-Ancestral (150 steps, guidance
  7.5): ``sample_euler`` with the schedule's model-input scaling and
  ancestral noise, the initial latents scaled by ``init_noise_sigma``;
- ``version="v110"``: the Latte trunk (``models.latte``, 8 output channels)
  with PNDM (``sample_pndm``, n+1 model calls for n steps).

CFG runs as 2 sampler lanes ([cond, uncond]) and MagCache caches each lane
(``lanes=2``, ``num_steps`` = model calls x 2); the head's first 4 channels
(eps) are combined. Captions are cleaned twice (``clean_caption``, on by
default as in the reference). Calibration records on v1.2's Euler-Ancestral
trajectory; v1.1's PNDM raises ``ValueError`` as the JAX pipeline does. PAB
(``enable_pab``): ``OSP_V110_PAB`` with the configured windows and its
block-granular MLP anchors on v1.1, spatial + cross windows on v1.2;
``pab_config`` replaces either.

The checkpoint-free path: ``MockTextEncoder``, random weights from a seeded
``torch.Generator``; latents are the output unless a VAE is given (``vae=``,
an ``OSPCausalVAE`` of the version's layout, ``vae_config()``: its
``decode`` fills ``video`` and ``timings["decode_s"]``). The request's noise
(initial and ancestral) comes from its seeded CPU generator, so every device
gets the same draws.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from magcache_tpu_torch.core.magcache import MagCacheConfig, prepare_mag_ratios
from magcache_tpu_torch.core.pab import OSP_V110_PAB, PABConfig
from magcache_tpu_torch.core.sampler import sample_euler, sample_pndm
from magcache_tpu_torch.models.latte import LatteConfig, LatteModel, make_latte_core
from magcache_tpu_torch.models.open_sora_plan import (OpenSoraPlanConfig, OSPModel,
                                                      make_osp_core)
from magcache_tpu_torch.models.published import load_latte_checkpoint, load_osp_checkpoint
from magcache_tpu_torch.models.text import MockTextEncoder
from magcache_tpu_torch.models.vae_osp import OSP_V110_VAE, OSP_V120_VAE, OSPVAEConfig
from magcache_tpu_torch.pipelines.base import (BasePipeline, PipelineOutput,
                                               calibration_dict, cfg_combine, synced_clock,
                                               timed_encode)
from magcache_tpu_torch.pipelines.open_sora_cond import clean_caption
from magcache_tpu_torch.schedulers.euler_ancestral import EulerAncestralSchedule
from magcache_tpu_torch.schedulers.pndm import PNDMSchedule
from magcache_tpu_torch.utils.misc import set_seed

VERSIONS = ("v110", "v120")
# the CausalVAE's strides (v1.1 and v1.2): 4 in time, 8 in space
VAE_TEMPORAL_STRIDE, VAE_SPATIAL_STRIDE = 4, 8


@dataclasses.dataclass
class OpenSoraPlanPipelineConfig:
    version: str = "v120"                 # v110 (Latte trunk + PNDM) | v120 (3-D + EA)
    num_frames: int = 29
    height: int = 480
    width: int = 640
    num_inference_steps: int = 150
    guidance_scale: float = 7.5
    caption_len: int = 512
    use_magcache: bool = False
    # full-compute recording on v1.2's Euler-Ancestral trajectory (2 lanes)
    magcache_calibration: bool = False
    # recorded calibration ratios (2 lanes x (steps - 1)); None = all ones
    magcache_ratios: Optional[tuple] = None
    magcache_thresh: float = 0.12
    magcache_K: int = 3
    retention_ratio: float = 0.2
    # PAB: v1.2 spatial (100, 850) range 2 + cross range 6; v1.1 adds
    # temporal range 4 and the MLP anchors of OSP_V110_PAB
    enable_pab: bool = False
    pab_threshold: tuple = (100, 850)
    pab_spatial_range: int = 2
    pab_temporal_range: int = 4
    pab_cross_range: int = 6
    pab_config: Optional[PABConfig] = None   # replaces the windows above
    dtype: str = "float32"
    tiny: bool = False
    ckpt_dir: Optional[str] = None     # a published transformer checkpoint
    # None -> 8 for the full models (eps + variance), the tiny default for tiny
    out_channels: Optional[int] = None
    # mT5 caption cleaning, applied twice; the reference's generate() default
    clean_caption: bool = True
    # v1.2's block composition: "packed" or "unpacked" (v1.1 runs Latte's
    # packed route)
    route: str = "packed"

    def model_config(self):
        kw = {} if self.out_channels is None else {"out_channels": self.out_channels}
        if self.version == "v110":
            if self.tiny:
                return LatteConfig.tiny(dtype=self.dtype, **kw)
            return LatteConfig(dtype=self.dtype, out_channels=self.out_channels or 8)
        if self.tiny:
            return OpenSoraPlanConfig.tiny(dtype=self.dtype, **kw)
        return OpenSoraPlanConfig(dtype=self.dtype, out_channels=self.out_channels or 8)

    def vae_config(self) -> OSPVAEConfig:
        """The CausalVAE layout of this version, 4x in time and 8x in space as
        the latents are counted (not the JAX default layout, which is 8x in
        time)."""
        return OSP_V110_VAE if self.version == "v110" else OSP_V120_VAE

    def pab(self) -> PABConfig:
        """The PAB configuration of this version (``pab_config`` if set)."""
        if self.pab_config is not None:
            return self.pab_config
        if self.version == "v110":
            return dataclasses.replace(
                OSP_V110_PAB, spatial_threshold=self.pab_threshold,
                spatial_range=self.pab_spatial_range,
                temporal_threshold=self.pab_threshold,
                temporal_range=self.pab_temporal_range,
                cross_threshold=self.pab_threshold, cross_range=self.pab_cross_range)
        return PABConfig(spatial_broadcast=True, spatial_threshold=self.pab_threshold,
                         spatial_range=self.pab_spatial_range, cross_broadcast=True,
                         cross_threshold=self.pab_threshold,
                         cross_range=self.pab_cross_range)


class OpenSoraPlanPipeline(BasePipeline):
    """Open-Sora-Plan T2V on ``device`` (the card unless told otherwise).
    Without ``model``, the version's transformer gets random weights from a
    generator seeded with ``init_seed``; a given ``model`` (``OSPModel`` for
    v1.2, ``LatteModel`` for v1.1) brings its own configuration. ``vae``
    (an ``OSPCausalVAE``) must have the latents' strides."""

    def __init__(self, config: OpenSoraPlanPipelineConfig, device="cuda",
                 text_encoder=None, model=None, init_seed: int = 0, vae=None):
        c = self.config = config
        if c.version not in VERSIONS:
            raise ValueError(f"version must be one of {VERSIONS}, got {c.version!r}")
        if vae is not None and (vae.cfg.time_stride, vae.cfg.space_stride) != (
                VAE_TEMPORAL_STRIDE, VAE_SPATIAL_STRIDE):
            raise ValueError(f"the VAE's strides (time {vae.cfg.time_stride}, space "
                             f"{vae.cfg.space_stride}) are not the latents' "
                             f"({VAE_TEMPORAL_STRIDE}, {VAE_SPATIAL_STRIDE}): take "
                             f"config.vae_config()")
        self.vae = vae
        self.device = torch.device(device)
        self.model_cfg = model.cfg if model is not None else c.model_config()
        lat_t = (c.num_frames - 1) // VAE_TEMPORAL_STRIDE + 1
        lat_h, lat_w = c.height // VAE_SPATIAL_STRIDE, c.width // VAE_SPATIAL_STRIDE
        self.latent_shape = (lat_t, lat_h, lat_w, self.model_cfg.in_channels)
        if c.version == "v110":
            self.schedule = PNDMSchedule.create(c.num_inference_steps)
            p = self.model_cfg.patch
            self.grid = (lat_t, lat_h // p, lat_w // p)
            cls = LatteModel
        else:
            self.schedule = EulerAncestralSchedule.create(c.num_inference_steps)
            pt, ph, pw = self.model_cfg.patch
            self.grid = (lat_t // pt, lat_h // ph, lat_w // pw)
            cls = OSPModel
        if model is None:
            model = cls(self.model_cfg, self.device)
            if c.ckpt_dir:
                load = load_latte_checkpoint if c.version == "v110" else load_osp_checkpoint
                model.load_state_dict(load(c.ckpt_dir, self.model_cfg))
            else:
                model.init(set_seed(init_seed, device=self.device))
        self.model = model.requires_grad_(False).eval()
        pab = c.pab() if c.enable_pab else None
        ts = self.schedule.timesteps
        if c.version == "v110":
            self.core = make_latte_core(self.model, self.grid, c.caption_len,
                                        route="packed", pab=pab, timesteps=ts)
        else:
            self.core = make_osp_core(self.model, self.grid, c.caption_len, route=c.route,
                                      pab=pab, timesteps=ts)
        caption_dim = self.model_cfg.caption_dim
        self.text_encoder = text_encoder or MockTextEncoder(c.caption_len, caption_dim,
                                                            scale=0.5)

    def _cache_cfg(self) -> Optional[MagCacheConfig]:
        """The 2-lane MagCacheConfig over every model call (v1.1's PNDM makes
        n+1), or None without ``use_magcache`` or when calibrating."""
        c = self.config
        if not c.use_magcache or c.magcache_calibration:
            return None
        n = self.schedule.num_steps * 2
        ratios = (np.ones(n) if c.magcache_ratios is None else
                  prepare_mag_ratios(np.asarray(c.magcache_ratios), n, lanes=2))
        return MagCacheConfig(num_steps=n, mag_ratios=tuple(ratios),
                              thresh=c.magcache_thresh,
                              max_consecutive_skips=c.magcache_K,
                              retention_ratio=c.retention_ratio, lanes=2)

    def _initial_noise(self, gen: torch.Generator) -> torch.Tensor:
        """Unit noise latents ``f32[1, T, H, W, C]`` on the CPU from the
        request's CPU generator (``generate`` scales them by
        ``init_noise_sigma`` on v1.2)."""
        return torch.randn((1,) + self.latent_shape, generator=gen, dtype=torch.float32)

    def _noise_fn(self, gen: torch.Generator):
        """v1.2's ancestral noise source for ``sample_euler``: draws of the
        request's CPU generator."""
        return lambda step, shape: torch.randn(shape, generator=gen, dtype=torch.float32)

    def generate(self, prompt: str, negative_prompt: str = "", seed: int = 0
                 ) -> PipelineOutput:
        """One video's latents ``f32[1, T, H, W, 4]`` (and with a VAE its
        pixels ``f32[1, 1 + 4 (T - 1), 8H, 8W, 3]``); ``skips`` holds the
        realized skip bits ``bool[model calls, 2]`` (none in calibration
        mode, which fills ``calibration``)."""
        t0 = time.time()
        c = self.config
        if c.clean_caption:
            prompt = clean_caption(clean_caption(prompt))
            if negative_prompt:
                negative_prompt = clean_caption(clean_caption(negative_prompt))
        states, text_s = timed_encode(self.text_encoder, [prompt, negative_prompt],
                                      self.device)
        cond = {"y": states}
        gen = set_seed(seed)
        z = self._initial_noise(gen)
        common = dict(lanes=2, combine_fn=cfg_combine(c.guidance_scale,
                                                      self.model_cfg.in_channels))
        calibration = skips = None
        sch = self.schedule
        if c.version == "v110":
            if c.magcache_calibration:
                raise ValueError("magcache_calibration records on the v120 "
                                 "Euler-Ancestral path; v110's PNDM is not wired for "
                                 "recording")
            latents, skips = sample_pndm(self.core, z.to(self.device), cond, sch,
                                         cache_cfg=self._cache_cfg(), return_skips=True,
                                         **common)
        else:
            z = (z * sch.init_noise_sigma).to(self.device)
            common.update(timesteps=sch.timesteps, dts=sch.dts, in_scales=sch.in_scales,
                          noise_scales=sch.noise_scales, noise_fn=self._noise_fn(gen))
            if c.magcache_calibration:
                latents, stats = sample_euler(self.core, z, cond, calibrate=True, **common)
                calibration = calibration_dict(stats)
            else:
                latents, skips = sample_euler(self.core, z, cond, cache_cfg=self._cache_cfg(),
                                              return_skips=True, **common)
        timings, video = {"text_s": text_s}, None
        if self.vae is not None:
            t1 = synced_clock(latents)
            video = self.vae.decode(latents)
            timings["decode_s"] = synced_clock(video) - t1
        timings["total_s"] = synced_clock(latents) - t0
        return PipelineOutput(latents=latents, calibration=calibration, timings=timings,
                              skips=skips, video=video)
