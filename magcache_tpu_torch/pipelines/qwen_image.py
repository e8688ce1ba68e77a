"""Qwen-Image and Qwen-Image-Edit pipeline: true CFG over two cache lanes.

The checkpoint-free path of ``magcache_tpu.pipelines.qwen_image`` (reference
``MagCache4QwenImage/magcache_generate.py`` and the Edit adapter): Qwen-Image
is not guidance-distilled, so every Euler step runs the cond and the uncond
forward (``[prompt, negative_prompt]``, the negative a single space as the
reference scripts pass it) and MagCache keeps two lanes (``num_steps =
sample_steps * 2``; presets ``qwen-image`` / ``qwen-image-edit``, E 0.06 K 2
R 0.2). The schedule is FLUX's: ``linspace(1, 1/n, n)`` shifted by the
resolution-dependent ``mu``. Edit (a model key with "edit") appends one
reference image's packed latents to the image tokens of both lanes.

The DiT loads ``ckpt_dir`` (a diffusers ``transformer/`` directory) or
takes random weights from a seeded ``torch.Generator`` (or is a given
model); the text encoder slot defaults to the prompt-hashed mock (a
``LlamaTextEncoder`` with the Qwen template or a ``QwenVLTextEncoder``
fills it). The output is the packed latents, as in JAX, whose pipeline
never decodes: its ``vae`` (a ``WanVAE``, or None) only encodes Edit's
reference image (``encode_image``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from magcache_tpu_torch.core.magcache import MagCacheConfig
from magcache_tpu_torch.core.presets import make_config
from magcache_tpu_torch.core.sampler import sample_euler
from magcache_tpu_torch.models.flux import pack_latents
from magcache_tpu_torch.models.published import load_qwen_image_checkpoint
from magcache_tpu_torch.models.qwen_image import (QWEN_IMAGE, QwenImageConfig,
                                                  QwenImageModel, make_qwen_image_core)
from magcache_tpu_torch.models.text import MockTextEncoder
from magcache_tpu_torch.pipelines.base import (BasePipeline, PipelineOutput,
                                               calibration_dict, synced_clock, timed_encode)
from magcache_tpu_torch.pipelines.flux import image_to_grid_latent
from magcache_tpu_torch.schedulers.flow_match import FlowMatchSchedule
from magcache_tpu_torch.utils.misc import set_seed

QWEN_MODELS = ("qwen-image", "qwen-image-edit")


@dataclasses.dataclass
class QwenImagePipelineConfig:
    model: str = "qwen-image"            # qwen-image | qwen-image-edit
    height: int = 1024
    width: int = 1024
    sample_steps: int = 50
    true_cfg_scale: float = 4.0
    txt_len: int = 256
    use_magcache: bool = False
    magcache_thresh: Optional[float] = None
    magcache_K: Optional[int] = None
    retention_ratio: Optional[float] = None
    magcache_calibration: bool = False
    # recorded norm_ratio list from a calibration run; replaces the
    # published table through the same pad and resample path
    mag_ratios_override: Optional[tuple] = None
    dtype: str = "bfloat16"
    tiny: bool = False
    ckpt_dir: Optional[str] = None     # a published transformer checkpoint

    def __post_init__(self):
        if self.model not in QWEN_MODELS:
            raise ValueError(f"Qwen-Image model {self.model!r}: one of {QWEN_MODELS}")

    def model_config(self) -> QwenImageConfig:
        if self.tiny:
            return QwenImageConfig.tiny(dtype=self.dtype)
        return dataclasses.replace(QWEN_IMAGE, dtype=self.dtype)

    def packed_grid(self) -> Tuple[int, int]:
        # pixels -> VAE/8 latents -> 2x2 packed tokens
        return (self.height // 16, self.width // 16)


class QwenImagePipeline(BasePipeline):
    """Qwen-Image / Qwen-Image-Edit on ``device`` (the card unless told
    otherwise). Without ``model``, the DiT of ``config.model_config()`` gets
    random weights from a generator seeded with ``init_seed``; a given
    ``model`` brings its own config. ``vae`` (a ``WanVAE`` of 16 latent
    channels) encodes Edit's reference image."""

    def __init__(self, config: QwenImagePipelineConfig, device="cuda", text_encoder=None,
                 model: Optional[QwenImageModel] = None, init_seed: int = 0, vae=None):
        self.config = c = config
        self.device = torch.device(device)
        self.vae = vae
        self.grid = c.packed_grid()
        self.ref_images = 1 if "edit" in c.model else 0
        if model is None:
            model = QwenImageModel(c.model_config(), self.device)
            if c.ckpt_dir:
                model.load_state_dict(load_qwen_image_checkpoint(c.ckpt_dir, model.cfg))
            else:
                model.init(set_seed(init_seed, device=self.device))
        self.model_cfg = model.cfg
        self.model = model.requires_grad_(False).eval()
        self.core = make_qwen_image_core(self.model, c.txt_len, *self.grid,
                                         ref_images=self.ref_images)
        self.text_encoder = text_encoder or MockTextEncoder(
            c.txt_len, self.model_cfg.text_dim, scale=0.5)
        gh, gw = self.grid
        self.schedule = FlowMatchSchedule.create(
            c.sample_steps, mu=FlowMatchSchedule.flux_mu(gh * gw), linspace_endpoint=True)

    def _cache_cfg(self, thresh=None, K=None, retention=None) -> MagCacheConfig:
        """The preset's two-lane MagCacheConfig with the config's (or the
        given) E/K/R and ``mag_ratios_override``."""
        c = self.config
        return make_config(
            c.model, c.sample_steps,
            thresh=c.magcache_thresh if thresh is None else thresh,
            K=c.magcache_K if K is None else K,
            retention_ratio=c.retention_ratio if retention is None else retention,
            ratios=c.mag_ratios_override)

    def skip_mask_for(self, thresh=None, K=None, retention_ratio=None,
                      use_magcache: bool = True) -> np.ndarray:
        """Host-precomputed ``bool[steps, 2]`` skip mask (cond, uncond lanes)
        for an E/K/R triple, for ``generate(skip_override=...)``; all-False
        is full compute."""
        return self._skip_mask_from_cfg(self._cache_cfg(thresh, K, retention_ratio),
                                        use_magcache)

    def encode_image(self, img: np.ndarray) -> torch.Tensor:
        """Edit's reference image ``[H, W, 3]`` in [0, 1] -> its packed
        latents ``f32[1, gh*gw, in_channels]`` on the pipeline's device (for
        ``generate(ref_latents=...)``): the pipeline's VAE encode of one
        frame, or without a VAE the nearest resize and channel tile (the JAX
        CLI's ``_image_to_grid_latent``)."""
        gh, gw = self.grid
        lat = image_to_grid_latent(self.vae, img, 2 * gh, 2 * gw,
                                   self.model_cfg.in_channels // 4)
        return pack_latents(torch.from_numpy(np.ascontiguousarray(lat))[None]).to(self.device)

    def _initial_noise(self, seed: int) -> torch.Tensor:
        """Seeded packed noise ``f32[1, gh*gw, in_channels]`` (a CPU
        generator, so the draw is the same on every device)."""
        gh, gw = self.grid
        return torch.randn((1, gh * gw, self.model_cfg.in_channels), generator=set_seed(seed),
                           dtype=torch.float32).to(self.device)

    def generate(self, prompt: str, negative_prompt: str = " ", seed: int = 0,
                 ref_latents: Optional[torch.Tensor] = None,
                 skip_override: Optional[np.ndarray] = None) -> PipelineOutput:
        """One image's packed latents ``f32[1, gh*gw, in_channels]``.

        ``ref_latents`` (Edit: ``[1, gh*gw, in_channels]`` packed, zeros when
        not given) rides both CFG lanes; ``skip_override`` (``bool[steps,
        2]`` from ``skip_mask_for``) replaces the config's schedule. ``skips``
        holds the realized skip bits (none in calibration mode, which fills
        ``calibration``)."""
        t0 = time.time()
        c = self.config
        calibrate = c.magcache_calibration
        if calibrate and skip_override is not None:
            raise ValueError("skip_override is a generation-path surface")
        txt, txt_s = timed_encode(self.text_encoder, [prompt, negative_prompt], self.device)
        cond = {"txt": txt}
        if self.ref_images:
            gh, gw = self.grid
            ref = (torch.zeros((1, gh * gw, self.model_cfg.in_channels)) if ref_latents is None
                   else torch.as_tensor(ref_latents)).float().to(self.device)
            cond["ref"] = torch.cat([ref, ref], dim=0)     # both lanes see the reference
        x0 = self._initial_noise(seed)
        sch = self.schedule
        common = dict(timesteps=sch.timesteps, dts=np.diff(sch.sigmas),
                      guidance_scale=c.true_cfg_scale)
        if calibrate:
            latents, stats = sample_euler(self.core, x0, cond, calibrate=True, **common)
            calibration, skips = calibration_dict(stats), None
        else:
            cache_cfg = (self._cache_cfg()
                         if c.use_magcache or skip_override is not None else None)
            latents, skips = sample_euler(self.core, x0, cond, cache_cfg=cache_cfg,
                                          skip_mask_override=skip_override,
                                          return_skips=True, **common)
            if skips.shape[1] == 1:          # full compute: one bit for both lanes
                skips = np.repeat(skips, 2, axis=1)
            calibration = None
        return PipelineOutput(latents=latents, calibration=calibration,
                              timings={"text_s": txt_s, "total_s": synced_clock(latents) - t0},
                              skips=skips)
