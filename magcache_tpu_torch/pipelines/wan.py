"""Wan 2.1 generation pipeline (t2v), MagCache-enabled.

Text encode -> seeded noise latents -> cached UniPC denoise loop. The
checkpoint-free path: ``MockTextEncoder``, random DiT weights from a seeded
``torch.Generator``, no VAE decode (latents are the output).

Wan latent geometry: VAE stride (4, 8, 8), 16 channels; DiT patch (1, 2, 2).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from magcache_tpu_torch.core.magcache import MagCacheConfig, prepare_mag_ratios
from magcache_tpu_torch.core.presets import PRESETS, make_config
from magcache_tpu_torch.core.sampler import _lane_masks, calibrate_unipc, sample_unipc
from magcache_tpu_torch.models.text import MockTextEncoder
from magcache_tpu_torch.models.wan import WAN_1_3B, WanConfig, WanModel, make_wan_core
from magcache_tpu_torch.pipelines.base import BasePipeline, PipelineOutput, calibration_dict
from magcache_tpu_torch.schedulers.unipc import UniPCSchedule
from magcache_tpu_torch.utils.misc import set_seed

# the Wan default negative prompt (wan.configs' sample_neg_prompt)
DEFAULT_NEGATIVE = (
    "色调艳丽，过曝，静态，细节模糊不清，字幕，风格，作品，画作，画面，静止，"
    "整体发灰，最差质量，低质量，JPEG压缩残留，丑陋的，残缺的，多余的手指，"
    "画得不好的手部，画得不好的脸部，畸形的，毁容的，形态畸形的肢体，"
    "手指融合，静止不动的画面，杂乱的背景，三条腿，背景人很多，倒着走"
)

VAE_STRIDE = (4, 8, 8)
LATENT_CHANNELS = 16


@dataclasses.dataclass
class WanPipelineConfig:
    model: str = "wan2.1-t2v-1.3B"       # preset key; also selects the size
    task: str = "t2v"
    size: Tuple[int, int] = (832, 480)   # (W, H) pixels
    frame_num: int = 81
    sample_steps: int = 50
    sample_shift: float = 8.0
    sample_solver: str = "unipc"
    guide_scale: float = 6.0
    use_magcache: bool = False
    magcache_thresh: Optional[float] = None
    magcache_K: Optional[int] = None
    retention_ratio: Optional[float] = None
    magcache_calibration: bool = False
    # user-calibrated ratios (unpadded, as calibration mode saves them)
    mag_ratios_override: Optional[tuple] = None
    dtype: str = "bfloat16"
    tiny: bool = False                   # toy-size model for smoke runs
    model_cfg_override: Optional[WanConfig] = None

    def __post_init__(self):
        if self.task != "t2v" or self.model != "wan2.1-t2v-1.3B":
            raise NotImplementedError(
                f"Wan {self.model!r} task {self.task!r} is not ported yet; "
                "only wan2.1-t2v-1.3B t2v is")
        if self.sample_solver != "unipc":
            raise NotImplementedError(
                f"sample_solver {self.sample_solver!r} is not ported yet; "
                "only unipc is")

    def model_config(self) -> WanConfig:
        if self.model_cfg_override is not None:
            return self.model_cfg_override
        if self.tiny:
            return WanConfig.tiny(dtype=self.dtype)
        return dataclasses.replace(WAN_1_3B, dtype=self.dtype)

    def latent_grid(self) -> Tuple[int, int, int]:
        w, h = self.size
        f = (self.frame_num - 1) // VAE_STRIDE[0] + 1
        return (f, h // VAE_STRIDE[1], w // VAE_STRIDE[2])


class WanPipeline(BasePipeline):
    """Wan2.1 t2v pipeline on ``device``. Without ``model``, the DiT gets
    random weights from a generator seeded with ``init_seed``."""

    def __init__(self, config: WanPipelineConfig, device,
                 text_encoder=None, model: Optional[WanModel] = None,
                 init_seed: int = 0):
        self.config = config
        self.device = torch.device(device)
        self.model_cfg = config.model_config()
        lf, lh, lw = config.latent_grid()
        pt, ph, pw = self.model_cfg.patch
        self.grid = (lf // pt, lh // ph, lw // pw)
        self.latent_shape = (lf, lh, lw, LATENT_CHANNELS)
        if model is None:
            model = WanModel(self.model_cfg, self.device).init(
                set_seed(init_seed, device=self.device))
        self.model = model.requires_grad_(False).eval()
        self.core = make_wan_core(self.model, self.grid)
        self.text_encoder = text_encoder or MockTextEncoder(
            self.model_cfg.text_len, self.model_cfg.text_dim, scale=0.5)

    def _schedule(self) -> UniPCSchedule:
        c = self.config
        return UniPCSchedule.create(c.sample_steps, shift=c.sample_shift)

    def _cache_cfg(self, *, thresh=None, K=None, retention=None,
                   force: bool = False) -> Optional[MagCacheConfig]:
        """The run's MagCacheConfig (None when caching is off, unless
        ``force``); ``thresh``/``K``/``retention`` override the config's
        E/K/R."""
        c = self.config
        if not c.use_magcache and not force:
            return None
        thresh = c.magcache_thresh if thresh is None else thresh
        K = c.magcache_K if K is None else K
        retention = c.retention_ratio if retention is None else retention
        if c.mag_ratios_override is not None:
            p = PRESETS[c.model]
            num_steps = c.sample_steps * p.lanes
            ratios = prepare_mag_ratios(np.asarray(c.mag_ratios_override),
                                        num_steps, lanes=p.lanes, pad=p.lanes)
            return MagCacheConfig(
                num_steps=num_steps, mag_ratios=tuple(ratios),
                thresh=p.thresh if thresh is None else thresh,
                max_consecutive_skips=p.K if K is None else K,
                retention_ratio=p.retention_ratio if retention is None else retention,
                lanes=p.lanes)
        return make_config(c.model, c.sample_steps, thresh=thresh, K=K,
                           retention_ratio=retention)

    def skip_mask_for(self, thresh=None, K=None, retention_ratio=None,
                      use_magcache: bool = True) -> np.ndarray:
        """Host-precomputed ``bool[num_steps, lanes]`` skip mask for an E/K/R
        triple, for ``generate(skip_override=...)``; all-False is full
        compute."""
        cfg = self._cache_cfg(thresh=thresh, K=K, retention=retention_ratio,
                              force=True)
        steps = self.config.sample_steps
        if not use_magcache:
            return np.zeros((steps, cfg.lanes), bool)
        return _lane_masks(cfg, steps)[0]

    def _sample_fn(self, calibrate: bool,
                   skip_override: Optional[np.ndarray] = None):
        """``(x0, cond) -> (latents, aux)``: the calibration run (aux = stats
        ``[steps-1, 2, 3]``) or the cached sampler (aux = realized skip bits);
        ``skip_override`` replaces the config's schedule."""
        c = self.config
        sch = self._schedule()
        if calibrate:
            if skip_override is not None:
                raise ValueError("skip_override is a generation-path surface")
            return lambda x0, cond: calibrate_unipc(
                self.core, x0, cond, sch, lanes=2, guidance_scale=c.guide_scale)
        # with an override, the cache config only supplies the lane structure
        cache_cfg = self._cache_cfg(force=skip_override is not None)
        return lambda x0, cond: sample_unipc(
            self.core, x0, cond, sch, cache_cfg=cache_cfg,
            guidance_scale=c.guide_scale, skip_mask_override=skip_override,
            return_skips=True)

    def generate(self, prompt: str, negative_prompt: str = DEFAULT_NEGATIVE,
                 seed: int = 0,
                 skip_override: Optional[np.ndarray] = None) -> PipelineOutput:
        """One video's latents ``f32[1, F, H, W, 16]``. ``skips`` in the output
        holds the realized skip bits ``bool[num_steps, lanes]`` (none in
        calibration mode, which fills ``calibration`` instead)."""
        t0 = time.time()
        calibrate = self.config.magcache_calibration
        fn = self._sample_fn(calibrate, skip_override)
        cond = {"context": self.text_encoder([prompt, negative_prompt],
                                             device=self.device)}
        x0 = torch.randn((1,) + self.latent_shape, generator=set_seed(seed),
                         dtype=torch.float32).to(self.device)
        latents, aux = fn(x0, cond)
        calibration = calibration_dict(aux) if calibrate else None
        skips = None if calibrate else aux
        if latents.is_cuda:
            torch.cuda.synchronize(latents.device)
        return PipelineOutput(latents=latents, calibration=calibration,
                              timings={"total_s": time.time() - t0},
                              skips=skips)
