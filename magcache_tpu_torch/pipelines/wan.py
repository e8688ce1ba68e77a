"""Wan 2.1 generation pipeline (t2v), MagCache-enabled.

Text encode -> seeded noise latents -> cached denoise loop (UniPC, or
DPM-Solver++(2M) or Euler on the same flow sigmas) -> VAE decode when the
pipeline has a VAE (``models.vae_wan.WanVAE``, streamed one
latent frame a call), as the JAX pipeline does. The checkpoint-free path:
``MockTextEncoder`` (or ``models.umt5.UMT5Encoder`` with random weights and
the hash tokenizer), random DiT weights from a seeded ``torch.Generator``,
and latents as the output unless a VAE is given.

Wan latent geometry: VAE stride (4, 8, 8), 16 channels; DiT patch (1, 2, 2).

Sequence parallelism (``sp > 1``): the pipeline object is one rank's. It is
built with the rank's ``plan`` (``parallel.mesh.MeshPlan``: a process group
under ``torchrun``, or a local rank of ``run_local_ranks``). Every rank
encodes the same text and draws the same noise from the seeded CPU
generator, runs the sampler on its ``1/sp`` of the tokens, and returns the
whole latents.

Cache policies: MagCache's release adapter rule (``cache_policy="adapter"``,
the presets) or the eval scripts' rolling rule (``"rolling"``,
``core.rolling``), and the TeaCache comparator (``enable_teacache``, per
CFG lane, UniPC only, exclusive with MagCache). Under ``sp > 1`` only UniPC
with the adapter rule is ported; the others raise.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from magcache_tpu_torch.core.magcache import MagCacheConfig, prepare_mag_ratios
from magcache_tpu_torch.core.presets import PRESETS, make_config
from magcache_tpu_torch.core.rolling import RollingCacheConfig
from magcache_tpu_torch.core.sampler import (calibrate_unipc, lane_skip_masks, sample_euler,
                                             sample_unipc)
from magcache_tpu_torch.core.teacache import TeaCacheLanes, wan_teacache_settings
from magcache_tpu_torch.models.text import MockTextEncoder
from magcache_tpu_torch.models.wan import WAN_1_3B, WanConfig, WanModel, make_wan_core
from magcache_tpu_torch.pipelines.base import (BasePipeline, PipelineOutput, calibration_dict,
                                               synced_clock, timed_encode)
from magcache_tpu_torch.schedulers.dpm_flow import dpmpp_2m_flow_coeffs
from magcache_tpu_torch.schedulers.flow_match import FlowMatchSchedule
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
    sample_solver: str = "unipc"         # unipc | dpm++ | euler
    guide_scale: float = 6.0
    use_magcache: bool = False
    magcache_thresh: Optional[float] = None
    magcache_K: Optional[int] = None
    retention_ratio: Optional[float] = None
    magcache_calibration: bool = False
    # "adapter": the release MagCache rule; "rolling": the eval scripts' rule
    # behind the published VBench numbers (core/rolling.py)
    cache_policy: str = "adapter"
    # TeaCache: per-lane activation-gated skips (wan_teacache.py:533-590)
    enable_teacache: bool = False
    teacache_thresh: float = 0.2
    use_ret_steps: bool = False
    # user-calibrated ratios (unpadded, as calibration mode saves them)
    mag_ratios_override: Optional[tuple] = None
    dtype: str = "bfloat16"
    tiny: bool = False                   # toy-size model for smoke runs
    model_cfg_override: Optional[WanConfig] = None
    sp: int = 1                          # sequence-parallel ranks
    sp_impl: str = "auto"                # "auto" | "ulysses" | "ring"

    def __post_init__(self):
        if self.task != "t2v" or self.model != "wan2.1-t2v-1.3B":
            raise NotImplementedError(
                f"Wan {self.model!r} task {self.task!r} is not ported yet; "
                "only wan2.1-t2v-1.3B t2v is")
        if self.sample_solver not in ("unipc", "dpm++", "euler"):
            raise ValueError(f"sample_solver must be unipc, dpm++ or euler, got "
                             f"{self.sample_solver!r}")
        if self.cache_policy not in ("adapter", "rolling"):
            raise ValueError(f"cache_policy must be adapter or rolling, got "
                             f"{self.cache_policy!r}")
        if self.sp > 1 and (self.sample_solver != "unipc" or self.enable_teacache
                            or self.cache_policy != "adapter"):
            raise NotImplementedError(
                "under sp > 1 only the unipc solver with the adapter cache policy "
                "is ported yet (not dpm++, euler, rolling or TeaCache)")

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
    """Wan2.1 t2v pipeline on ``device`` (the card unless told otherwise).
    Without ``model``, the DiT gets random weights from a generator seeded
    with ``init_seed`` (the same on every rank). With ``config.sp > 1`` it is
    one rank's pipeline and needs that rank's ``plan``; local ranks may share
    one ``model``. ``text_encoder(prompts, device=)`` gives the context
    ``[2, text_len, text_dim]`` (default: the mock); with ``vae``
    (``WanVAE``) ``generate`` also decodes the latents to ``video``."""

    def __init__(self, config: WanPipelineConfig, device="cuda",
                 text_encoder=None, model: Optional[WanModel] = None,
                 init_seed: int = 0, plan=None, vae=None):
        if (plan.sp if plan is not None else 1) != config.sp:
            raise ValueError(
                f"WanPipeline: config.sp = {config.sp} needs a plan of that many "
                f"ranks, got {'none' if plan is None else plan.sp} (start the "
                f"ranks with torchrun, or with parallel.mesh.run_local_ranks)")
        self.config = config
        self.plan = plan
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
        self.core = make_wan_core(self.model, self.grid, plan,
                                  sp_impl=config.sp_impl)
        self.text_encoder = text_encoder or MockTextEncoder(
            self.model_cfg.text_len, self.model_cfg.text_dim, scale=0.5)
        self.vae = vae

    def _schedule(self):
        """UniPC's schedule, or the flow-matching sigmas dpm++ and Euler
        step on."""
        c = self.config
        if c.sample_solver == "unipc":
            return UniPCSchedule.create(c.sample_steps, shift=c.sample_shift)
        return FlowMatchSchedule.create(c.sample_steps, shift=c.sample_shift)

    def _cache_cfg(self, *, thresh=None, K=None, retention=None,
                   force: bool = False):
        """The run's MagCacheConfig, or its RollingCacheConfig under the
        rolling policy (None when caching is off, unless ``force``);
        ``thresh``/``K``/``retention`` override the config's E/K/R."""
        c = self.config
        if not c.use_magcache and not force:
            return None
        thresh = c.magcache_thresh if thresh is None else thresh
        K = c.magcache_K if K is None else K
        retention = c.retention_ratio if retention is None else retention
        if c.cache_policy == "rolling":
            # the eval scripts' defaults (0.015, K -1) never skip; the
            # published runs pass 0.12 and K 2
            return RollingCacheConfig(
                num_steps=c.sample_steps * 2, thresh=0.015 if thresh is None else thresh,
                K=-1 if K is None else K, retention=0.2 if retention is None else retention)
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
        return lane_skip_masks(cfg, steps)[0]

    def _teacache_lanes(self) -> TeaCacheLanes:
        """The per-lane TeaCache policy from the published Wan settings: the
        signal is ``e0`` with ret steps, else the time embedding ``e``
        (``wan_teacache.py:534``)."""
        c = self.config
        coeffs, ret, cutoff = wan_teacache_settings("t2v-1.3B", c.sample_steps,
                                                    c.use_ret_steps)
        key = "e0" if c.use_ret_steps else "e"
        return TeaCacheLanes(thresh=c.teacache_thresh, coefficients=coeffs,
                             ret_steps=ret, cutoff_steps=cutoff, lanes=2,
                             signal_fn=lambda hidden, ctx: ctx[key])

    def _sample_fn(self, calibrate: bool,
                   skip_override: Optional[np.ndarray] = None):
        """``(x0, cond) -> (latents, aux)``: the calibration run (aux = stats
        ``[steps-1, 2, 3]``) or the sampler (aux = realized skip bits) of the
        config's solver and policy; ``skip_override`` replaces the config's
        schedule."""
        c = self.config
        sch = self._schedule()
        g = c.guide_scale
        dpm = dpmpp_2m_flow_coeffs(sch.sigmas) if c.sample_solver == "dpm++" else None
        if calibrate and skip_override is not None:
            raise ValueError("skip_override is a generation-path surface")
        if calibrate and c.sample_solver == "unipc":
            return lambda x0, cond: calibrate_unipc(
                self.core, x0, cond, sch, lanes=2, guidance_scale=g, plan=self.plan)
        if calibrate:
            # calibration rides the trajectory generation uses
            return lambda x0, cond: sample_euler(
                self.core, x0, cond, timesteps=sch.timesteps, dts=np.diff(sch.sigmas),
                guidance_scale=g, dpm_coeffs=dpm, calibrate=True)
        tea = None
        if c.enable_teacache:
            if c.use_magcache:
                raise ValueError("enable_teacache and use_magcache are mutually exclusive")
            if c.sample_solver != "unipc":
                raise ValueError("Wan TeaCache rides the UniPC trajectory (the "
                                 "reference eval's solver); set sample_solver='unipc'")
            if skip_override is not None:
                raise ValueError("skip_override and enable_teacache are mutually "
                                 "exclusive (TeaCache decides from activations)")
            tea = self._teacache_lanes()
        # with an override, the cache config only supplies the lane structure
        cache_cfg = self._cache_cfg(force=skip_override is not None)
        if c.sample_solver == "unipc":
            return lambda x0, cond: sample_unipc(
                self.core, x0, cond, sch, cache_cfg=cache_cfg, guidance_scale=g,
                skip_mask_override=skip_override, dynamic_skip=tea, return_skips=True)
        return lambda x0, cond: sample_euler(
            self.core, x0, cond, timesteps=sch.timesteps, dts=np.diff(sch.sigmas),
            cache_cfg=cache_cfg, guidance_scale=g, dpm_coeffs=dpm,
            skip_mask_override=skip_override, return_skips=True)

    def _initial_noise(self, gen: torch.Generator) -> torch.Tensor:
        """The noise latents ``f32[1, F, H, W, 16]`` on the CPU, drawn from
        the request's CPU generator, so every device and rank gets the same
        draw."""
        return torch.randn((1,) + self.latent_shape, generator=gen, dtype=torch.float32)

    def generate(self, prompt: str, negative_prompt: str = DEFAULT_NEGATIVE,
                 seed: int = 0,
                 skip_override: Optional[np.ndarray] = None) -> PipelineOutput:
        """One video's latents ``f32[1, F, H, W, 16]``, and with a VAE its
        pixels ``video`` ``f32[1, frames, H_px, W_px, 3]``. ``skips`` in the
        output holds the realized skip bits ``bool[num_steps, lanes]`` (none
        in calibration mode, which fills ``calibration`` instead)."""
        t0 = time.time()
        calibrate = self.config.magcache_calibration
        fn = self._sample_fn(calibrate, skip_override)
        context, text_s = timed_encode(self.text_encoder, [prompt, negative_prompt],
                                       self.device)
        cond = {"context": context}
        x0 = self._initial_noise(set_seed(seed)).to(self.device)
        latents, aux = fn(x0, cond)
        calibration = calibration_dict(aux) if calibrate else None
        skips = None if calibrate else aux
        timings, video = {"text_s": text_s}, None
        if self.vae is not None:
            t1 = synced_clock(latents)
            video = self.vae.decode(latents)
            timings["decode_s"] = synced_clock(video) - t1
        timings["total_s"] = synced_clock(latents) - t0
        return PipelineOutput(latents=latents, calibration=calibration,
                              timings=timings, skips=skips, video=video)

