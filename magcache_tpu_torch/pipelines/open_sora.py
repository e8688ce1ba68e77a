"""Open-Sora 1.2 text-to-video on STDiT3 + RFLOW, MagCache-enabled.

The plain t2v path of ``magcache_tpu.pipelines.open_sora`` (reference stack
``videosys/pipelines/open_sora/pipeline_open_sora.py``): prompt score
appending and T5 caption cleaning -> text encode -> seeded noise latents ->
Euler RFLOW loop with CFG as one joint batch of 2 rows ([cond, uncond]), so
MagCache keeps a single cache lane over the joint batch (the eval harness's
configuration, ``eval/magcache/experiments/opensora.py``). The
checkpoint-free path: ``MockTextEncoder``, random STDiT3 weights from a
seeded ``torch.Generator``, no VAE decode (latents are the output).

Latent geometry: VAE stride 8 in space and ``get_latent_t`` in time (51
frames -> 15 latents), 4 channels; DiT patch (1, 2, 2). Not ported yet
(raise): PAB, the mask strategy and references, looped generation, the
rolling cache policy.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from magcache_tpu_torch.core.presets import make_config
from magcache_tpu_torch.core.sampler import sample_euler
from magcache_tpu_torch.models.stdit3 import (STDIT3_XL_2, STDiT3Config,
                                              STDiT3Model, make_stdit3_core)
from magcache_tpu_torch.models.text import MockTextEncoder
from magcache_tpu_torch.pipelines import open_sora_cond as oc
from magcache_tpu_torch.pipelines.base import BasePipeline, PipelineOutput, calibration_dict
from magcache_tpu_torch.schedulers.rflow import RFlowSchedule
from magcache_tpu_torch.utils.misc import set_seed

VAE_SPATIAL_STRIDE = 8


@dataclasses.dataclass
class OpenSoraPipelineConfig:
    num_frames: int = 51
    height: int = 480
    width: int = 848
    # named bucket selection; when set these override height/width
    resolution: Optional[str] = None          # "480p", "720p", ...
    aspect_ratio: Optional[str] = None        # "9:16", "16:9", ...
    num_sampling_steps: int = 30
    cfg_scale: float = 7.0
    caption_len: int = 300
    fps: int = 24
    use_magcache: bool = False
    # full-compute recording of the joint single-lane magnitude stats
    magcache_calibration: bool = False
    magcache_thresh: Optional[float] = None
    magcache_K: Optional[int] = None
    retention_ratio: Optional[float] = None
    # recorded calibration ratios (num_steps - 1 entries); None = published
    magcache_ratios: Optional[tuple] = None
    cache_policy: str = "adapter"
    enable_pab: bool = False
    dtype: str = "float32"
    tiny: bool = False

    def __post_init__(self):
        if self.cache_policy != "adapter":
            raise NotImplementedError(
                f"cache_policy {self.cache_policy!r} is not ported yet; only "
                "'adapter' (the published opensora-v1.2 rule) is")
        if self.enable_pab:
            raise NotImplementedError("PAB is not ported yet")
        if self.resolution is not None:
            ar = self.aspect_ratio or "9:16"
            self.height, self.width = oc.get_image_size(self.resolution, ar)
        self.num_frames = oc.get_num_frames(self.num_frames)

    def model_config(self) -> STDiT3Config:
        if self.tiny:
            return STDiT3Config.tiny(dtype=self.dtype)
        return dataclasses.replace(STDIT3_XL_2, dtype=self.dtype)


class OpenSoraPipeline(BasePipeline):
    """Open-Sora 1.2 t2v on ``device``. Without ``model``, STDiT3 gets random
    weights from a generator seeded with ``init_seed``."""

    def __init__(self, config: OpenSoraPipelineConfig, device,
                 text_encoder=None, model: Optional[STDiT3Model] = None,
                 init_seed: int = 0):
        self.config = config
        c = config
        self.device = torch.device(device)
        self.model_cfg = c.model_config()
        lat_t = oc.get_latent_t(c.num_frames)
        lat_h, lat_w = c.height // VAE_SPATIAL_STRIDE, c.width // VAE_SPATIAL_STRIDE
        self.latent_shape = (lat_t, lat_h, lat_w, self.model_cfg.in_channels)
        pt, ph, pw = self.model_cfg.patch
        self.grid = (lat_t // pt, lat_h // ph, lat_w // pw)
        self.schedule = RFlowSchedule.create(
            c.num_sampling_steps, use_timestep_transform=True, height=c.height,
            width=c.width, num_frames=c.num_frames)
        if model is None:
            model = STDiT3Model(self.model_cfg, self.device).init(
                set_seed(init_seed, device=self.device))
        self.model = model.requires_grad_(False).eval()
        self.core = make_stdit3_core(self.model, self.grid,
                                     pixel_size=(c.height, c.width))
        self.text_encoder = text_encoder or MockTextEncoder(
            c.caption_len, self.model_cfg.caption_dim, scale=0.5)

    def _cache_cfg(self):
        """The single-lane MagCacheConfig over the joint CFG batch, or None
        when caching is off."""
        c = self.config
        if not c.use_magcache or c.magcache_calibration:
            return None
        return make_config("opensora-v1.2", c.num_sampling_steps,
                           thresh=c.magcache_thresh, K=c.magcache_K,
                           retention_ratio=c.retention_ratio,
                           ratios=c.magcache_ratios)

    def _combine(self):
        g = self.config.cfg_scale
        C = self.model_cfg.in_channels

        def combine(chunks):
            # the model predicts 2C channels; RFLOW takes the first C
            cond_o, uncond_o = chunks[0][..., :C], chunks[1][..., :C]
            return uncond_o + g * (cond_o - uncond_o)

        return combine

    def _initial_noise(self, seed: int) -> torch.Tensor:
        """Seeded noise latents ``f32[1, T, H, W, C]`` (a CPU generator, so
        the draw is the same on every device)."""
        return torch.randn((1,) + self.latent_shape, generator=set_seed(seed),
                           dtype=torch.float32).to(self.device)

    def _prompt(self, prompt: str, aes, flow, camera_motion,
                use_text_preprocessing: bool) -> str:
        """Score appending + twice-applied caption cleaning of a one-loop
        prompt (``pipeline_open_sora.py:532-605``)."""
        prompts, _, _ = oc.extract_json_from_prompts([prompt], [""], [""])
        segs, idxs = oc.split_prompt(prompts[0])
        segs = oc.append_score_to_prompts(segs, aes=aes, flow=flow,
                                          camera_motion=camera_motion)
        segs = [oc.text_preprocessing(s, use_text_preprocessing) for s in segs]
        return oc.extract_prompts_loop([oc.merge_prompt(segs, idxs)], 0)[0]

    def generate(self, prompt: str, negative_prompt: str = "", seed: int = 0,
                 loop: int = 1, ms: str = "", refs: str = "",
                 aes: Optional[float] = 6.5, flow: Optional[float] = None,
                 camera_motion: Optional[str] = None,
                 use_text_preprocessing: bool = True) -> PipelineOutput:
        """One video's latents ``f32[1, T, H, W, 4]``. ``skips`` holds the
        realized skip bits ``bool[steps, 1]`` (none in calibration mode, which
        fills ``calibration``). ``loop > 1``, ``ms`` and ``refs`` are not
        ported yet."""
        if loop != 1 or ms or refs or "{" in prompt:
            raise NotImplementedError("looped generation, the mask strategy "
                                      "and references are not ported yet")
        t0 = time.time()
        c = self.config
        calibrate = c.magcache_calibration
        text = self._prompt(prompt, aes, flow, camera_motion,
                            use_text_preprocessing)
        y = self.text_encoder([text, negative_prompt], device=self.device)
        fps = float(c.fps if self.latent_shape[0] > 1 else oc.IMG_FPS)
        cond = {"y": y, "fps": torch.full((2,), fps, dtype=torch.float32,
                                          device=self.device)}
        z = self._initial_noise(seed)
        sch = self.schedule
        common = dict(timesteps=sch.timesteps, dts=sch.dts(), lanes=2,
                      combine_fn=self._combine())
        if calibrate:
            latents, stats = sample_euler(self.core, z, cond, calibrate=True,
                                          calibrate_lanes=1, **common)
            calibration, skips = calibration_dict(stats), None
        else:
            latents, skips = sample_euler(self.core, z, cond,
                                          cache_cfg=self._cache_cfg(),
                                          return_skips=True, **common)
            calibration = None
        if latents.is_cuda:
            torch.cuda.synchronize(latents.device)
        return PipelineOutput(latents=latents, calibration=calibration,
                              timings={"total_s": time.time() - t0},
                              skips=skips)
