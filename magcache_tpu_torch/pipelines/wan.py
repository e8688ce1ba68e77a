"""Wan 2.1 generation pipeline (t2v, i2v and flf2v), MagCache-enabled.

Text encode -> (i2v, flf2v) image encode -> seeded noise latents -> cached
denoise loop (UniPC, or DPM-Solver++(2M) or Euler on the same flow sigmas)
-> VAE decode when the pipeline has a VAE (``models.vae_wan.WanVAE``,
streamed one latent frame a call), as the JAX pipeline does. The
checkpoint-free path: ``MockTextEncoder`` (or ``models.umt5.UMT5Encoder``
with random weights and the hash tokenizer), random DiT weights from a
seeded ``torch.Generator``, and latents as the output unless a VAE is given.

Models: ``wan2.1-t2v-1.3B`` and ``wan2.1-t2v-14B`` take task t2v;
``wan2.1-i2v-480p`` and ``-720p`` (the 14B trunk with 36 input channels)
take i2v (one image) and flf2v (first and last frame; twice the CLIP
tokens). The image encode (``encode_image``, ``encode_flf``; JAX
``WanPipeline.encode_image`` / ``encode_flf``): the CLIP vision tower's
penultimate states of each image (a random-weight ViT sized to the model's
``clip_dim`` and ``clip_tokens`` unless ``clip=`` gives one), and the VAE
latents of the bicubically resized image in [-1, 1] followed by zero frames
(flf2v: the last image as the last frame) under 4 mask channels: latent
frame 0 is 1 in all four, and flf2v's last pixel frame marks channel 3 of
the last latent frame. The VAE that encodes is the pipeline's ``vae``,
else a random-weight ``models.vae.CausalVAE`` with the Wan strides, as in
JAX.

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
CFG lane, UniPC only, exclusive with MagCache; no published coefficients
for flf2v, which raises). Under ``sp > 1`` only t2v with UniPC and the
adapter rule is ported; the others raise.
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
from magcache_tpu_torch.models.clip import (CLIPVisionConfig, CLIPVisionModel,
                                            clip_vision_forward, preprocess_clip_image)
from magcache_tpu_torch.models.text import MockTextEncoder
from magcache_tpu_torch.models.vae import CausalVAE, CausalVAEConfig
from magcache_tpu_torch.models.wan import WAN_1_3B, WAN_14B, WanConfig, WanModel, make_wan_core
from magcache_tpu_torch.pipelines.base import (BasePipeline, PipelineOutput, calibration_dict,
                                               synced_clock, timed_encode)
from magcache_tpu_torch.schedulers.dpm_flow import dpmpp_2m_flow_coeffs
from magcache_tpu_torch.schedulers.flow_match import FlowMatchSchedule
from magcache_tpu_torch.schedulers.unipc import UniPCSchedule
from magcache_tpu_torch.utils.misc import resize_bicubic, set_seed

# the Wan default negative prompt (wan.configs' sample_neg_prompt)
DEFAULT_NEGATIVE = (
    "色调艳丽，过曝，静态，细节模糊不清，字幕，风格，作品，画作，画面，静止，"
    "整体发灰，最差质量，低质量，JPEG压缩残留，丑陋的，残缺的，多余的手指，"
    "画得不好的手部，画得不好的脸部，畸形的，毁容的，形态畸形的肢体，"
    "手指融合，静止不动的画面，杂乱的背景，三条腿，背景人很多，倒着走"
)

VAE_STRIDE = (4, 8, 8)
LATENT_CHANNELS = 16
# the ported models and the tasks each takes
MODEL_TASKS = {"wan2.1-t2v-1.3B": ("t2v",), "wan2.1-t2v-14B": ("t2v",),
               "wan2.1-i2v-480p": ("i2v", "flf2v"), "wan2.1-i2v-720p": ("i2v", "flf2v")}
IMAGE_TASKS = ("i2v", "flf2v")


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
        if self.task not in ("t2v",) + IMAGE_TASKS or self.model not in MODEL_TASKS:
            raise NotImplementedError(
                f"Wan {self.model!r} task {self.task!r} is not ported yet; ported: "
                f"{', '.join(f'{m} {t}' for m, ts in MODEL_TASKS.items() for t in ts)}")
        if self.task not in MODEL_TASKS[self.model]:
            raise ValueError(f"Wan {self.model!r} takes task "
                             f"{' or '.join(MODEL_TASKS[self.model])}, not {self.task!r}")
        if self.sp > 1 and self.task != "t2v":
            raise NotImplementedError(f"under sp > 1 only t2v is ported yet, not {self.task}")
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
        """The trunk: ``WAN_1_3B`` for wan2.1-t2v-1.3B, else ``WAN_14B`` (the
        i2v presets included: the JAX package's config builds the 1.3B width
        for them, which no published i2v model has); i2v and flf2v with 36
        input channels, flf2v with two images' CLIP tokens."""
        if self.model_cfg_override is not None:
            return self.model_cfg_override
        if self.tiny:
            base = WanConfig.tiny()
        else:
            base = WAN_1_3B if self.model == "wan2.1-t2v-1.3B" else WAN_14B
        base = dataclasses.replace(base, dtype=self.dtype)
        if self.task in IMAGE_TASKS:
            base = dataclasses.replace(base, model_type="i2v", in_channels=36)
        if self.task == "flf2v":
            base = dataclasses.replace(base, clip_tokens=2 * base.clip_tokens)
        return base

    def latent_grid(self) -> Tuple[int, int, int]:
        w, h = self.size
        f = (self.frame_num - 1) // VAE_STRIDE[0] + 1
        return (f, h // VAE_STRIDE[1], w // VAE_STRIDE[2])


class WanPipeline(BasePipeline):
    """Wan2.1 t2v, i2v and flf2v pipeline on ``device`` (the card unless
    told otherwise). Without ``model``, the DiT gets random weights from a
    generator seeded with ``init_seed`` (the same on every rank). With
    ``config.sp > 1`` it is one rank's pipeline and needs that rank's
    ``plan``; local ranks may share one ``model``. ``text_encoder(prompts,
    device=)`` gives the context ``[2, text_len, text_dim]`` (default: the
    mock); with ``vae`` (``WanVAE``) ``generate`` also decodes the latents to
    ``video``. i2v and flf2v: ``clip`` (a ``CLIPVisionModel``) and ``vae``
    encode the images; unset, the tower and a causal VAE are built at the
    first image encode with random weights from generators seeded 7 and
    11."""

    def __init__(self, config: WanPipelineConfig, device="cuda",
                 text_encoder=None, model: Optional[WanModel] = None,
                 init_seed: int = 0, plan=None, vae=None,
                 clip: Optional[CLIPVisionModel] = None):
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
        self.clip = clip
        self.image_vae = None

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
        if c.task == "i2v":
            model_key = "i2v-720P" if c.size[1] >= 720 else "i2v-480P"
        elif c.task == "t2v":
            model_key = "t2v-14B" if "14B" in c.model else "t2v-1.3B"
        else:
            raise ValueError(f"enable_teacache: no published coefficients for task "
                             f"{c.task!r} (Wan2.1 t2v and i2v only); use use_magcache")
        coeffs, ret, cutoff = wan_teacache_settings(model_key, c.sample_steps,
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

    # ---- i2v / flf2v image encoding ---------------------------------------
    def _i2v_encoders(self):
        """``(clip, image_vae)``, built at the first call when not given: the
        CLIP tower sized so its tokens are the model's per-image
        ``clip_tokens`` (257 -> 224 px at patch 14; 2 blocks when tiny, else
        32) and, without a VAE that encodes, the causal VAE with the Wan
        strides (as the JAX pipeline's ``_i2v_encoders``)."""
        cfg, tiny = self.model_cfg, self.config.tiny
        if self.clip is None and cfg.has_clip:
            per_image = cfg.clip_tokens // (2 if self.config.task == "flf2v" else 1)
            side = int(round((per_image - 1) ** 0.5))
            ccfg = CLIPVisionConfig(dim=cfg.clip_dim, layers=2 if tiny else 32,
                                    heads=16 if cfg.clip_dim % 16 == 0 else 4,
                                    image_size=14 * side)
            self.clip = CLIPVisionModel(ccfg, self.device).init(
                set_seed(7, device=self.device)).requires_grad_(False)
        if self.image_vae is None:
            if self.vae is not None:
                self.image_vae = self.vae
            else:
                vcfg = CausalVAEConfig(base=8 if tiny else 96,
                                       ch_mult=(1, 1, 2, 2) if tiny else (1, 2, 4, 4),
                                       blocks_per_level=1 if tiny else 2)
                self.image_vae = CausalVAE(vcfg, self.device).init(
                    set_seed(11, device=self.device)).requires_grad_(False)
        return self.clip, self.image_vae

    def _clip_features(self, images) -> Optional[torch.Tensor]:
        """The CLIP tower's states of each image, concatenated on tokens
        (``f32[1, clip_tokens, clip_dim]``), or None without the branch."""
        clip, _ = self._i2v_encoders()
        if clip is None:
            return None
        return torch.cat([clip_vision_forward(clip, preprocess_clip_image(img, clip.cfg))
                          for img in images], dim=1)

    def _conditioning(self, first, last=None) -> torch.Tensor:
        """``y f32[1, F_lat, lh, lw, 20]``: the 4 mask channels, then the VAE
        mean of [first; zero frames] (or [first; zero frames; last])."""
        _, vae = self._i2v_encoders()
        w, h = self.config.size
        n = self.config.frame_num

        def pixels(img):
            r = resize_bicubic(torch.from_numpy(img)[None], (h, w)).to(self.device)
            return r.clamp(0.0, 1.0)[:, None] * 2.0 - 1.0

        ends = [pixels(first)] + ([] if last is None else [pixels(last)])
        zeros = torch.zeros((1, n - len(ends), h, w, 3), device=self.device)
        mean, _ = vae.encode(torch.cat(ends[:1] + [zeros] + ends[1:], dim=1))
        lf, lh, lw, _ = self.latent_shape
        if tuple(mean.shape[1:4]) != (lf, lh, lw):
            raise ValueError(f"the image VAE's latents {tuple(mean.shape)} do not fit the "
                             f"latent grid {self.latent_shape}")
        msk = torch.zeros((1, lf, lh, lw, 4), device=mean.device)
        msk[:, 0] = 1.0
        if last is not None:
            # the last pixel frame is slot 3 of the last latent frame's group
            # of 4 (frame 0 is repeated into all four slots of latent frame 0)
            msk[:, lf - 1, :, :, 3] = 1.0
        return torch.cat([msk, mean.float()], dim=-1)

    @staticmethod
    def _image(image) -> np.ndarray:
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        return np.asarray(img, np.float32)

    def encode_image(self, image) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """An image ``[H, W, 3]``, uint8 or float in [0, 1] -> ``(y,
        clip_fea)``: the conditioning latents ``f32[1, F_lat, lh, lw, 20]``
        (latent frame 0 masked 1) and the CLIP features ``f32[1, tokens,
        clip_dim]`` (None for a model without the CLIP branch)."""
        img = self._image(image)
        return self._conditioning(img), self._clip_features([img])

    def encode_flf(self, first_image, last_image):
        """First and last frame -> ``(y, clip_fea)``: the VAE latents of
        [first; zeros; last] with latent frame 0 masked 1 and channel 3 of
        the last latent frame masked 1, and both images' CLIP tokens."""
        first, last = self._image(first_image), self._image(last_image)
        return self._conditioning(first, last), self._clip_features([first, last])

    def _image_cond(self, image, last_image, image_latents, clip_features) -> dict:
        """The i2v / flf2v conditioning entries of ``cond``, one copy per CFG
        lane, encoding the images unless their latents are given."""
        task = self.config.task
        if image_latents is None:
            if image is None or (task == "flf2v" and last_image is None):
                raise ValueError(f"{task} needs image={'' if task == 'i2v' else ' and last_image='}"
                                 f" or image_latents=")
            if task == "flf2v":
                image_latents, clip_features = self.encode_flf(image, last_image)
            else:
                image_latents, clip_features = self.encode_image(image)
        cond = {"y": torch.cat([image_latents.to(self.device, torch.float32)] * 2)}
        if self.model_cfg.has_clip:
            if clip_features is None:
                raise ValueError(f"{task}: the model's CLIP branch needs clip_features=")
            cond["clip_fea"] = torch.cat([clip_features.to(self.device, torch.float32)] * 2)
        return cond

    def generate(self, prompt: str, negative_prompt: str = DEFAULT_NEGATIVE,
                 seed: int = 0, image=None, last_image=None,
                 image_latents: Optional[torch.Tensor] = None,
                 clip_features: Optional[torch.Tensor] = None,
                 skip_override: Optional[np.ndarray] = None) -> PipelineOutput:
        """One video's latents ``f32[1, F, H, W, 16]``, and with a VAE its
        pixels ``video`` ``f32[1, frames, H_px, W_px, 3]``. ``skips`` in the
        output holds the realized skip bits ``bool[num_steps, lanes]`` (none
        in calibration mode, which fills ``calibration`` instead). i2v takes
        ``image``, flf2v ``image`` and ``last_image`` (or their encodings,
        ``image_latents`` and ``clip_features``); ``timings["image_s"]`` is
        the image encode's time."""
        t0 = time.time()
        calibrate = self.config.magcache_calibration
        image_task = self.config.task in IMAGE_TASKS
        if not image_task and (image is not None or last_image is not None
                               or image_latents is not None):
            raise ValueError(f"image conditioning is for i2v and flf2v, not "
                             f"{self.config.task}")
        fn = self._sample_fn(calibrate, skip_override)
        context, text_s = timed_encode(self.text_encoder, [prompt, negative_prompt],
                                       self.device)
        cond = {"context": context}
        timings = {"text_s": text_s}
        if image_task:
            t1 = time.time()
            cond.update(self._image_cond(image, last_image, image_latents, clip_features))
            timings["image_s"] = synced_clock(cond["y"]) - t1
        x0 = self._initial_noise(set_seed(seed)).to(self.device)
        latents, aux = fn(x0, cond)
        calibration = calibration_dict(aux) if calibrate else None
        skips = None if calibrate else aux
        video = None
        if self.vae is not None:
            t1 = synced_clock(latents)
            video = self.vae.decode(latents)
            timings["decode_s"] = synced_clock(video) - t1
        timings["total_s"] = synced_clock(latents) - t0
        return PipelineOutput(latents=latents, calibration=calibration,
                              timings=timings, skips=skips, video=video)

