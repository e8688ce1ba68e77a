"""Wan 2.1 / 2.2 generation pipeline (t2v, i2v, flf2v, VACE and ti2v, and
the Wan2.2 A14B two-expert MoE), MagCache-enabled.

Text encode -> (i2v, flf2v, ti2v, VACE) image or video encode -> seeded
noise latents -> cached denoise loop (UniPC, or DPM-Solver++(2M) or Euler on
the same flow sigmas) -> VAE decode when the pipeline has a VAE
(``models.vae_wan.WanVAE``, streamed one latent frame a call), as the JAX
pipeline does. The DiT loads a published checkpoint (``ckpt_dir``) or takes
random weights from a seeded ``torch.Generator``; the text encoder is
``MockTextEncoder`` unless one is given (``models.umt5.UMT5Encoder`` of a
checkpoint or of random weights, with the hash tokenizer); the output is
latents unless a VAE is given.

Models and tasks (``MODEL_TASKS``):

- ``wan2.1-t2v-1.3B`` and ``wan2.1-t2v-14B`` take t2v;
- ``wan2.1-i2v-480p`` and ``-720p`` (the 14B trunk with 36 input channels)
  take i2v (one image) and flf2v (first and last frame; twice the CLIP
  tokens). The image encode (``encode_image``, ``encode_flf``; JAX
  ``WanPipeline.encode_image`` / ``encode_flf``): the CLIP vision tower's
  penultimate states of each image (a random-weight ViT sized to the
  model's ``clip_dim`` and ``clip_tokens`` unless ``clip=`` gives one), and
  the VAE latents of the bicubically resized image in [-1, 1] followed by
  zero frames (flf2v: the last image as the last frame) under 4 mask
  channels: latent frame 0 is 1 in all four, and flf2v's last pixel frame
  marks channel 3 of the last latent frame;
- ``wan2.1-vace-1.3B`` and ``-14B`` take vace: the t2v trunk with a VACE
  block every 5th layer. ``encode_vace``: the VAE latents of the inactive
  (``video * (1 - mask)``) and reactive (``video * mask``) halves of the
  source video, bicubically resized in time and space, and the mask
  resized to the latent frames by nearest neighbour and folded 8x8 into 64
  channels; R2V reference images are encoded as one-frame clips and
  prepended as latent frames (16 channels, 80 zeros), and trimmed from the
  sampled latents before the decode;
- ``wan2.2-ti2v-5B-t2v`` and ``-i2v`` take ti2v: ``WAN_5B`` on the Wan2.2
  VAE's 48-channel latents at stride (4, 16, 16). With an image
  (``encode_ti2v``: the VAE's latents of the resized image, or without a
  VAE that encodes, the image nearest-resized to the latent grid times a
  fixed random 3 x 48 projection), the image latents are latent frame 0 of
  the noise, re-imposed after every solver step, and its tokens run at
  t = 0 (the model's per-token timestep);
- ``wan2.2-t2v-A14B`` (t2v) and ``wan2.2-i2v-A14B`` (i2v, conditioned by
  the ``y`` concat alone: no CLIP branch): two full ``WAN_14B`` experts,
  the high-noise one (``model``) for the steps with ``t >= moe_boundary *
  T`` and the low-noise one (``model_low``) after, each with its own CFG
  scale (``guide_scale`` = (low, high)). One UniPC carry, the MagCache
  residual included, crosses the switch; the skip schedule re-gates its
  retention around ``split_step`` (the boundary in forward indices).
  UniPC only; calibration runs the high-noise expert alone.

The VAE that encodes is the pipeline's ``vae``, else a random-weight
``models.vae.CausalVAE`` with the Wan strides, as in JAX.

Parallel ranks (``dp * sp * tp > 1``): the pipeline object is one rank's
of the (dp, sp, tp) grid. It is built with the rank's ``plan``
(``parallel.mesh.MeshPlan``: process groups under ``torchrun``, or a local
rank of ``run_local_ranks``). Every rank encodes the same text, images and
source video and draws the same noise from the seeded CPU generator, runs
the sampler on its ``1/sp`` of the tokens with its ``1/tp`` of the heads
(``parallel.shard``: views of a shared ``model`` on local ranks, its own
slices otherwise, of both MoE experts), and returns the whole latents.
``generate`` at dp 2 runs one CFG lane a dp rank (``core.sampler``); larger
dp refuses it. ``generate_batch`` at dp d gives each dp rank ``B / d``
whole prompts with both lanes, no collective per step, and gathers the
latents over dp at the end. Every model, task, solver and cache policy runs
so.

Cache policies: MagCache's release adapter rule (``cache_policy="adapter"``,
the presets) or the eval scripts' rolling rule (``"rolling"``,
``core.rolling``; not on the MoE), and the TeaCache comparator
(``enable_teacache``, per CFG lane, UniPC only, exclusive with MagCache;
published coefficients for Wan2.1 t2v and i2v only, the other tasks and
Wan2.2 raise).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from magcache_tpu_torch.core.magcache import MagCacheConfig, prepare_mag_ratios
from magcache_tpu_torch.core.presets import PRESETS, make_config
from magcache_tpu_torch.core.rolling import RollingCacheConfig
from magcache_tpu_torch.core.sampler import (calibrate_unipc, lane_skip_masks, sample_euler,
                                             sample_unipc, unipc_executor)
from magcache_tpu_torch.core.teacache import TeaCacheLanes, wan_teacache_settings
from magcache_tpu_torch.models.clip import (CLIPVisionConfig, CLIPVisionModel,
                                            clip_vision_forward, load_clip_vision,
                                            preprocess_clip_image)
from magcache_tpu_torch.models.published import load_wan_checkpoint
from magcache_tpu_torch.models.text import MockTextEncoder
from magcache_tpu_torch.models.vae import CausalVAE, CausalVAEConfig
from magcache_tpu_torch.models.wan import (VACE_IN_CHANNELS, WAN_1_3B, WAN_5B, WAN_14B,
                                           WanConfig, WanModel, make_wan_core)
from magcache_tpu_torch.parallel.shard import slice_wan, wan_from_state_dict
from magcache_tpu_torch.pipelines.base import (BasePipeline, PipelineOutput, calibration_dict,
                                               synced_clock, timed_encode)
from magcache_tpu_torch.schedulers.dpm_flow import dpmpp_2m_flow_coeffs
from magcache_tpu_torch.schedulers.flow_match import FlowMatchSchedule
from magcache_tpu_torch.schedulers.unipc import UniPCSchedule
from magcache_tpu_torch.utils.misc import (resize_bicubic, resize_nearest, resize_video_bicubic,
                                           set_seed)

# the Wan default negative prompt (wan.configs' sample_neg_prompt)
DEFAULT_NEGATIVE = (
    "色调艳丽，过曝，静态，细节模糊不清，字幕，风格，作品，画作，画面，静止，"
    "整体发灰，最差质量，低质量，JPEG压缩残留，丑陋的，残缺的，多余的手指，"
    "画得不好的手部，画得不好的脸部，畸形的，毁容的，形态畸形的肢体，"
    "手指融合，静止不动的画面，杂乱的背景，三条腿，背景人很多，倒着走"
)

VAE_STRIDE = (4, 8, 8)
LATENT_CHANNELS = 16
VAE_STRIDE_22 = (4, 16, 16)     # the Wan2.2 VAE (TI2V-5B): a 2x2 pixel shuffle
LATENT_CHANNELS_22 = 48
# the models and the tasks each takes
MODEL_TASKS = {"wan2.1-t2v-1.3B": ("t2v",), "wan2.1-t2v-14B": ("t2v",),
               "wan2.1-i2v-480p": ("i2v", "flf2v"), "wan2.1-i2v-720p": ("i2v", "flf2v"),
               "wan2.1-vace-1.3B": ("vace",), "wan2.1-vace-14B": ("vace",),
               "wan2.2-t2v-A14B": ("t2v",), "wan2.2-i2v-A14B": ("i2v",),
               "wan2.2-ti2v-5B-t2v": ("ti2v",), "wan2.2-ti2v-5B-i2v": ("ti2v",)}
IMAGE_TASKS = ("i2v", "flf2v")
# the A14B experts' switch: the high-noise expert runs the steps with
# t >= boundary * T (wan.configs' t2v_A14B / i2v_A14B boundary)
MOE_BOUNDARIES = {"wan2.2-t2v-A14B": 0.875, "wan2.2-i2v-A14B": 0.900}
# the ti2v mock encode's fixed projection of 3 pixel channels to the latents'
TI2V_PROJECTION_SEED = 13


def _ti2v_post(cond: dict):
    """The ti2v latent replacement: the image latents re-imposed as latent
    frame 0 after every solver step (None without an image)."""
    img = cond.get("ti2v_img")
    if img is None:
        return None
    return lambda x: torch.cat([img.to(x.dtype), x[:, 1:]], dim=1)


@dataclasses.dataclass
class WanPipelineConfig:
    model: str = "wan2.1-t2v-1.3B"       # preset key; also selects the size
    task: str = "t2v"
    size: Tuple[int, int] = (832, 480)   # (W, H) pixels
    frame_num: int = 81
    sample_steps: int = 50
    sample_shift: float = 8.0
    sample_solver: str = "unipc"         # unipc | dpm++ | euler
    # a float, or the A14B MoE's (low_noise, high_noise) pair
    guide_scale: Union[float, Tuple[float, float]] = 6.0
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
    # the (dp, sp, tp) grid of the rank's plan
    dp: int = 1                          # data-parallel ranks (CFG lanes, prompts)
    sp: int = 1                          # sequence-parallel ranks
    tp: int = 1                          # tensor-parallel ranks (heads)
    sp_impl: str = "auto"                # "auto" | "ulysses" | "ring"
    vace_ref_images: int = 0             # VACE R2V: the reference images
    # a published DiT checkpoint (safetensors, sharded or not); random if None
    ckpt_dir: Optional[str] = None
    clip_ckpt: Optional[str] = None      # the CLIP vision tower's weights (i2v)

    def __post_init__(self):
        if self.model not in MODEL_TASKS:
            raise NotImplementedError(
                f"Wan {self.model!r} is not ported yet; ported: "
                f"{', '.join(f'{m} {t}' for m, ts in MODEL_TASKS.items() for t in ts)}")
        if self.task not in MODEL_TASKS[self.model]:
            raise ValueError(f"Wan {self.model!r} takes task "
                             f"{' or '.join(MODEL_TASKS[self.model])}, not {self.task!r}")
        if self.vace_ref_images and self.task != "vace":
            raise ValueError("vace_ref_images is for the vace task")
        if self.sample_solver not in ("unipc", "dpm++", "euler"):
            raise ValueError(f"sample_solver must be unipc, dpm++ or euler, got "
                             f"{self.sample_solver!r}")
        if self.cache_policy not in ("adapter", "rolling"):
            raise ValueError(f"cache_policy must be adapter or rolling, got "
                             f"{self.cache_policy!r}")
        if min(self.dp, self.sp, self.tp) < 1:
            raise ValueError(f"dp, sp and tp must be at least 1, got {self.dp}, {self.sp}, "
                             f"{self.tp}")

    @property
    def moe_boundary(self) -> Optional[float]:
        """The A14B MoE's expert switch in [0, 1]; None on a dense model."""
        return MOE_BOUNDARIES.get(self.model)

    @property
    def guide_pair(self) -> Tuple[float, float]:
        """The (low_noise, high_noise) CFG scales; a float gives both."""
        g = self.guide_scale
        if isinstance(g, (tuple, list)):
            return float(g[0]), float(g[1])
        return float(g), float(g)

    def model_config(self) -> WanConfig:
        """The trunk: ``WAN_1_3B`` for the 1.3B models, ``WAN_5B`` for
        TI2V-5B, else ``WAN_14B`` (the i2v presets included: the JAX
        package's config builds the 1.3B width for them, which no published
        i2v model has); i2v and flf2v with 36 input channels, flf2v with two
        images' CLIP tokens, Wan2.2 i2v without the CLIP branch, VACE with a
        VACE block every 5th layer."""
        if self.model_cfg_override is not None:
            return self.model_cfg_override
        if self.tiny:
            base = WanConfig.tiny()
        elif "5B" in self.model:
            base = WAN_5B
        else:
            base = WAN_1_3B if "1.3B" in self.model else WAN_14B
        base = dataclasses.replace(base, dtype=self.dtype)
        if self.task in IMAGE_TASKS:
            base = dataclasses.replace(base, model_type="i2v", in_channels=36)
        if self.task == "i2v" and self.model.startswith("wan2.2"):
            base = dataclasses.replace(base, clip_tokens=0)
        if self.task == "flf2v":
            base = dataclasses.replace(base, clip_tokens=2 * base.clip_tokens)
        if self.task == "vace":
            base = dataclasses.replace(base, vace_layers=tuple(range(0, base.layers, 5)))
        return base

    @property
    def vae_stride(self) -> Tuple[int, int, int]:
        return VAE_STRIDE_22 if "5B" in self.model and not self.tiny else VAE_STRIDE

    @property
    def latent_channels(self) -> int:
        return LATENT_CHANNELS_22 if "5B" in self.model and not self.tiny else LATENT_CHANNELS

    def latent_grid(self) -> Tuple[int, int, int]:
        """(F, H, W) of the latents; VACE's R2V references add leading
        frames."""
        w, h = self.size
        st, sh, sw = self.vae_stride
        f = (self.frame_num - 1) // st + 1
        if self.task == "vace":
            f += self.vace_ref_images
        return (f, h // sh, w // sw)


class WanPipeline(BasePipeline):
    """Wan pipeline on ``device`` (the card unless told otherwise). Without
    ``model``, the DiT loads ``config.ckpt_dir`` (a published checkpoint,
    ``models.published.load_wan_checkpoint``) or gets random weights from a
    generator seeded with ``init_seed`` (the same on every rank); on an A14B
    model without ``model_low``, the low-noise expert gets its own from
    ``init_seed + 1`` (a checkpoint holds one expert, as in JAX).
    With ``config.dp * sp * tp > 1`` it is one rank's pipeline and needs
    that rank's ``plan`` (of the same grid); local ranks may share one whole
    ``model``, which tp ranks slice as views. Without ``model`` a tp rank
    keeps only its own slices (of the checkpoint, or of the seeded random
    weights, which it draws whole first). ``text_encoder(prompts,
    device=)`` gives the context ``[2, text_len, text_dim]`` (default: the
    mock); with ``vae`` (``WanVAE``) ``generate`` also decodes the latents to
    ``video``. i2v, flf2v and VACE: ``clip`` (a ``CLIPVisionModel``) and
    ``vae`` encode the images and videos; unset, the tower and a causal VAE
    are built at the first encode with random weights from generators seeded
    7 and 11. ti2v encodes its image with ``vae``, or without one with the
    mock projection."""

    def __init__(self, config: WanPipelineConfig, device="cuda",
                 text_encoder=None, model: Optional[WanModel] = None,
                 init_seed: int = 0, plan=None, vae=None,
                 clip: Optional[CLIPVisionModel] = None,
                 model_low: Optional[WanModel] = None):
        want = (config.dp, config.sp, config.tp)
        got = (plan.dp, plan.sp, plan.tp) if plan is not None else (1, 1, 1)
        if got != want:
            raise ValueError(
                f"WanPipeline: config dp {config.dp} x sp {config.sp} x tp {config.tp} needs "
                f"a plan of that grid, got "
                f"{'none' if plan is None else plan.describe()} (start the ranks with "
                f"torchrun, or with parallel.mesh.run_local_ranks)")
        if model_low is not None and config.moe_boundary is None:
            raise ValueError(f"model_low is the A14B MoE's low-noise expert; "
                             f"{config.model} is dense")
        self.config = config
        self.plan = plan
        self.device = torch.device(device)
        self.model_cfg = config.model_config()
        lf, lh, lw = config.latent_grid()
        pt, ph, pw = self.model_cfg.patch
        self.grid = (lf // pt, lh // ph, lw // pw)
        self.latent_shape = (lf, lh, lw, config.latent_channels)

        tp = plan.tp if plan is not None else 1

        def expert(m, seed, ckpt_dir=None):
            if m is not None:
                return m.requires_grad_(False).eval()
            if ckpt_dir and tp > 1:     # only this rank's slices reach the device
                sd = load_wan_checkpoint(ckpt_dir, self.model_cfg, device="cpu")
                return wan_from_state_dict(self.model_cfg, sd, plan.tp_rank, tp, self.device)
            m = WanModel(self.model_cfg, self.device)
            if ckpt_dir:
                m.load_state_dict(load_wan_checkpoint(ckpt_dir, self.model_cfg))
            else:
                m.init(set_seed(seed, device=self.device))
            m = m.requires_grad_(False).eval()
            if tp > 1:                  # the seeded weights drawn whole, then sliced
                m = slice_wan(m, plan.tp_rank, tp, copy=True)
            return m

        self.model = expert(model, init_seed, config.ckpt_dir)
        self.core = make_wan_core(self.model, self.grid, plan,
                                  sp_impl=config.sp_impl)
        self.model_low = self.core_low = None
        if config.moe_boundary is not None:
            self.model_low = expert(model_low, init_seed + 1)
            self.core_low = make_wan_core(self.model_low, self.grid, plan,
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
            if c.moe_boundary is not None:
                raise ValueError("the rolling policy is the Wan2.1 eval variant; "
                                 "it has no MoE split")
            # the eval scripts' defaults (0.015, K -1) never skip; the
            # published runs pass 0.12 and K 2
            return RollingCacheConfig(
                num_steps=c.sample_steps * 2, thresh=0.015 if thresh is None else thresh,
                K=-1 if K is None else K, retention=0.2 if retention is None else retention)
        # the MoE re-gates retention around the expert switch (forward indices)
        split_step, mode = None, "t2v"
        if c.moe_boundary is not None:
            split_step, mode = self.boundary_step() * 2, c.task
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
                lanes=p.lanes, split_step=split_step, mode=mode)
        return make_config(c.model, c.sample_steps, thresh=thresh, K=K,
                           retention_ratio=retention, split_step=split_step, mode=mode)

    def boundary_step(self) -> Optional[int]:
        """The MoE's first low-noise step (None on a dense model)."""
        if self.config.moe_boundary is None:
            return None
        sch = self._schedule()
        return FlowMatchSchedule(sch.sigmas, sch.timesteps).boundary_step(
            self.config.moe_boundary)

    def skip_mask_for(self, thresh=None, K=None, retention_ratio=None,
                      use_magcache: bool = True) -> np.ndarray:
        """Host-precomputed ``bool[num_steps, lanes]`` skip mask for an E/K/R
        triple, for ``generate(skip_override=...)``; all-False is full
        compute. Not on the MoE."""
        if self.config.moe_boundary is not None:
            raise ValueError("per-request cache overrides do not cover the Wan2.2 MoE "
                             "two-expert path")
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
        if c.model.startswith("wan2.2") or c.task not in ("t2v", "i2v"):
            raise ValueError(f"enable_teacache: no published coefficients for task "
                             f"{c.task!r} of {c.model!r} (Wan2.1 t2v and i2v only); "
                             f"use use_magcache")
        if c.task == "i2v":
            model_key = "i2v-720P" if c.size[1] >= 720 else "i2v-480P"
        else:
            model_key = "t2v-14B" if "14B" in c.model else "t2v-1.3B"
        coeffs, ret, cutoff = wan_teacache_settings(model_key, c.sample_steps,
                                                    c.use_ret_steps)
        key = "e0" if c.use_ret_steps else "e"
        return TeaCacheLanes(thresh=c.teacache_thresh, coefficients=coeffs,
                             ret_steps=ret, cutoff_steps=cutoff, lanes=2,
                             signal_fn=lambda hidden, ctx: ctx[key])

    def _sample_fn(self, calibrate: bool,
                   skip_override: Optional[np.ndarray] = None, plan=None):
        """``(x0, cond) -> (latents, aux)``: the calibration run (aux = stats
        ``[steps-1, 2, 3]``) or the sampler (aux = realized skip bits) of the
        config's solver and policy; ``skip_override`` replaces the config's
        schedule. The MoE samples through ``_sample_fn_moe``; its
        calibration runs the high-noise expert alone at its scale. ``plan``:
        the sampler's (default the pipeline's; ``generate_batch`` passes it
        without its dp axis)."""
        c = self.config
        plan = self.plan if plan is None else plan
        if c.moe_boundary is not None and not calibrate:
            if skip_override is not None:
                raise ValueError("per-request cache overrides do not cover the Wan2.2 "
                                 "MoE two-expert path")
            return self._sample_fn_moe(plan=plan)
        sch = self._schedule()
        g = c.guide_pair[1]
        dpm = dpmpp_2m_flow_coeffs(sch.sigmas) if c.sample_solver == "dpm++" else None
        if calibrate and skip_override is not None:
            raise ValueError("skip_override is a generation-path surface")
        if calibrate and c.sample_solver == "unipc":
            return lambda x0, cond: calibrate_unipc(
                self.core, x0, cond, sch, lanes=2, guidance_scale=g, plan=plan)
        if calibrate:
            # calibration rides the trajectory generation uses
            return lambda x0, cond: sample_euler(
                self.core, x0, cond, timesteps=sch.timesteps, dts=np.diff(sch.sigmas),
                guidance_scale=g, dpm_coeffs=dpm, calibrate=True, plan=plan)
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
                skip_mask_override=skip_override, dynamic_skip=tea, return_skips=True,
                post_step=_ti2v_post(cond), plan=plan)
        return lambda x0, cond: sample_euler(
            self.core, x0, cond, timesteps=sch.timesteps, dts=np.diff(sch.sigmas),
            cache_cfg=cache_cfg, guidance_scale=g, dpm_coeffs=dpm,
            skip_mask_override=skip_override, return_skips=True,
            post_step=_ti2v_post(cond), plan=plan)

    def _sample_fn_moe(self, batch: int = 1, plan=None):
        """The A14B two-expert sampler over ``batch`` videos: UniPC steps
        ``[0, boundary)`` on the high-noise expert at the high scale, then
        ``[boundary, n)`` on the low-noise expert at the low scale, one carry
        (samples, UniPC history, MagCache residual) across the switch.
        Returns the realized skip bits as aux."""
        c = self.config
        if c.enable_teacache:
            self._teacache_lanes()          # raises: no Wan2.2 coefficients
        if c.sample_solver != "unipc":
            raise ValueError(f"the Wan2.2 MoE samples with UniPC, not {c.sample_solver}")
        sch = self._schedule()
        boundary = self.boundary_step()
        cache_cfg = self._cache_cfg()
        g_low, g_high = c.guide_pair
        init_carry, step_high = unipc_executor(self.core, sch, cache_cfg=cache_cfg,
                                               guidance_scale=g_high, batch=batch, plan=plan)
        _, step_low = unipc_executor(self.core_low, sch, cache_cfg=cache_cfg,
                                     guidance_scale=g_low, batch=batch, plan=plan)

        @torch.inference_mode()
        def run(x0, cond):
            carry, skips = init_carry(x0), []
            for i in range(sch.num_steps):
                carry, bits = (step_high if i < boundary else step_low)(carry, i, cond)
                skips.append(bits)
            return carry[0], np.stack(skips)

        return run

    def _initial_noise(self, gen: torch.Generator) -> torch.Tensor:
        """The noise latents ``f32[1, F, H, W, C]`` on the CPU, drawn from
        the request's CPU generator, so every device and rank gets the same
        draw."""
        return torch.randn((1,) + self.latent_shape, generator=gen, dtype=torch.float32)

    # ---- image and video encoding ------------------------------------------
    def _i2v_encoders(self):
        """``(clip, image_vae)``, built at the first call when not given: the
        CLIP tower sized so its tokens are the model's per-image
        ``clip_tokens`` (257 -> 224 px at patch 14; 2 blocks when tiny, else
        32), with ``config.clip_ckpt``'s weights or random ones, and, without
        a VAE that encodes, the causal VAE with the Wan
        strides (as the JAX pipeline's ``_i2v_encoders``)."""
        cfg, tiny = self.model_cfg, self.config.tiny
        if self.clip is None and cfg.has_clip:
            per_image = cfg.clip_tokens // (2 if self.config.task == "flf2v" else 1)
            side = int(round((per_image - 1) ** 0.5))
            ccfg = CLIPVisionConfig(dim=cfg.clip_dim, layers=2 if tiny else 32,
                                    heads=16 if cfg.clip_dim % 16 == 0 else 4,
                                    image_size=14 * side)
            if self.config.clip_ckpt:
                self.clip = load_clip_vision(self.config.clip_ckpt, ccfg, self.device)
            else:
                self.clip = CLIPVisionModel(ccfg, self.device).init(set_seed(7, device=self.device))
            self.clip.requires_grad_(False)
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
        ends = [self._pixels(img)[:, None] for img in (first, last) if img is not None]
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

    def _pixels(self, img: np.ndarray) -> torch.Tensor:
        """An image ``[H, W, 3]`` in [0, 1] resized to the canvas, in [-1, 1]:
        ``f32[1, h, w, 3]`` on the pipeline's device."""
        w, h = self.config.size
        r = resize_bicubic(torch.from_numpy(img)[None], (h, w)).to(self.device)
        return r.clamp(0.0, 1.0) * 2.0 - 1.0

    def encode_ti2v(self, image) -> torch.Tensor:
        """The ti2v image -> one latent frame ``f32[1, 1, lh, lw, C]``: the
        VAE's latents of the resized image, or without a VAE that encodes,
        the image nearest-resized to the latent grid times a fixed random
        projection of its 3 channels to the C latent ones (a generator
        seeded 13; the JAX package draws its own)."""
        lf, lh, lw, c = self.latent_shape
        px = self._pixels(self._image(image))
        if self.vae is not None:
            mean, _ = self.vae.encode(px[:, None])
        else:
            lat = resize_nearest(px.permute(0, 3, 1, 2), (lh, lw)).permute(0, 2, 3, 1)
            proj = torch.randn((3, c), generator=set_seed(TI2V_PROJECTION_SEED)) / np.sqrt(3.0)
            mean = (lat @ proj.to(lat.device))[:, None]
        if tuple(mean.shape) != (1, 1, lh, lw, c):
            raise ValueError(f"the ti2v image latents {tuple(mean.shape)} do not fit the "
                             f"latent grid {self.latent_shape}")
        return mean.float()

    def encode_vace(self, src_video=None, src_mask=None, src_ref_images=None) -> torch.Tensor:
        """The VACE conditioning context ``f32[1, F_lat, lh, lw, 96]``: the
        VAE latents of the inactive and reactive halves of ``src_video``
        (``[F, H, W, 3]`` in [0, 1]; None: zeros, pure generation) under
        ``src_mask`` (``[F, H, W]`` in [0, 1]; None: ones, edit everywhere),
        16 + 16 channels, and the mask at the latent frames folded 8x8 into
        64; each of ``src_ref_images`` (``config.vace_ref_images`` of them)
        encoded as a one-frame clip and prepended as a latent frame (16
        channels and 80 zeros)."""
        lf_all, lh, lw, _ = self.latent_shape
        refs = list(src_ref_images or [])
        n_ref = self.config.vace_ref_images
        if len(refs) != n_ref:
            raise ValueError(f"config.vace_ref_images = {n_ref}, but {len(refs)} reference "
                             f"images were given")
        lf = lf_all - n_ref
        w, h = self.config.size
        n = self.config.frame_num
        dev = self.device
        if src_video is None:
            ctx = torch.zeros((1, lf, lh, lw, VACE_IN_CHANNELS), device=dev)
        else:
            _, vae = self._i2v_encoders()
            vid = resize_video_bicubic(torch.from_numpy(np.asarray(src_video, np.float32))[None],
                                       (n, h, w)).to(dev)
            vid = vid.clamp(0.0, 1.0) * 2.0 - 1.0
            if src_mask is None:
                m = torch.ones((1, n, h, w), device=dev)
            else:
                m = resize_nearest(torch.from_numpy(np.asarray(src_mask, np.float32))[None],
                                   (n, h, w)).to(dev)
            inactive, _ = vae.encode(vid * (1.0 - m[..., None]))
            reactive, _ = vae.encode(vid * m[..., None])
            # the mask at the latent frames (nearest in time), 8x8 space-to-depth
            m_lat = resize_nearest(m, (lf, lh * 8, lw * 8)).reshape(1, lf, lh, 8, lw, 8)
            m_lat = m_lat.permute(0, 1, 2, 4, 3, 5).reshape(1, lf, lh, lw, 64)
            ctx = torch.cat([inactive.float(), reactive.float(), m_lat], dim=-1)
        if refs:
            _, vae = self._i2v_encoders()
            lat = torch.cat([vae.encode(self._pixels(self._image(img))[:, None])[0][:, :1]
                             for img in refs], dim=1).float()
            ref_ctx = torch.cat([lat, torch.zeros((1, n_ref, lh, lw, VACE_IN_CHANNELS - lat.shape[-1]),
                                                 device=dev)], dim=-1)
            ctx = torch.cat([ref_ctx, ctx], dim=1)
        return ctx

    def generate(self, prompt: str, negative_prompt: str = DEFAULT_NEGATIVE,
                 seed: int = 0, image=None, last_image=None,
                 image_latents: Optional[torch.Tensor] = None,
                 clip_features: Optional[torch.Tensor] = None,
                 src_video=None, src_mask=None, src_ref_images=None,
                 vace_context: Optional[torch.Tensor] = None,
                 skip_override: Optional[np.ndarray] = None) -> PipelineOutput:
        """One video's latents ``f32[1, F, H, W, C]``, and with a VAE its
        pixels ``video`` ``f32[1, frames, H_px, W_px, 3]``. ``skips`` in the
        output holds the realized skip bits ``bool[num_steps, lanes]`` (none
        in calibration mode, which fills ``calibration`` instead). i2v takes
        ``image``, flf2v ``image`` and ``last_image`` (or their encodings,
        ``image_latents`` and ``clip_features``); ti2v optionally ``image``
        (or its latents, ``image_latents``); VACE ``src_video``, ``src_mask``
        and ``src_ref_images`` (or their context, ``vace_context``).
        ``timings["image_s"]`` is the image or video encode's time."""
        t0 = time.time()
        c = self.config
        calibrate = c.magcache_calibration
        images = image is not None or last_image is not None or image_latents is not None
        if images and c.task not in IMAGE_TASKS + ("ti2v",):
            raise ValueError(f"image conditioning is for i2v and flf2v (and ti2v's one "
                             f"image), not {c.task}")
        if c.task == "ti2v" and (last_image is not None or clip_features is not None):
            raise ValueError("ti2v takes one image (image= or image_latents=)")
        if c.task != "vace" and any(a is not None for a in (src_video, src_mask,
                                                            src_ref_images, vace_context)):
            raise ValueError(f"src_video, src_mask, src_ref_images and vace_context are "
                             f"for the vace task, not {c.task}")
        if self.plan is not None and self.plan.dp > 2:
            raise ValueError(
                f"generate() at dp = {self.plan.dp}: the CFG batch holds two rows (the "
                f"cond and the uncond lane), one a dp rank, so generate() runs at dp 1 "
                f"or 2; generate_batch takes dp prompts at a time")
        fn = self._sample_fn(calibrate, skip_override)
        context, text_s = timed_encode(self.text_encoder, [prompt, negative_prompt],
                                       self.device)
        cond = {"context": context}
        timings = {"text_s": text_s}
        t1, encoded = time.time(), None
        if c.task in IMAGE_TASKS:
            cond.update(self._image_cond(image, last_image, image_latents, clip_features))
            encoded = cond["y"]
        elif c.task == "vace":
            if vace_context is None:
                vace_context = self.encode_vace(src_video, src_mask, src_ref_images)
            encoded = cond["vace_context"] = torch.cat(
                [vace_context.to(self.device, torch.float32)] * 2)
        elif c.task == "ti2v" and images:
            if image_latents is None:
                image_latents = self.encode_ti2v(image)
            encoded = cond["ti2v_img"] = image_latents.to(self.device, torch.float32)
        if encoded is not None:
            timings["image_s"] = synced_clock(encoded) - t1
        x0 = self._initial_noise(set_seed(seed)).to(self.device)
        if "ti2v_img" in cond:
            x0 = torch.cat([cond["ti2v_img"], x0[:, 1:]], dim=1)
        latents, aux = fn(x0, cond)
        calibration = calibration_dict(aux) if calibrate else None
        skips = None if calibrate else aux
        if c.vace_ref_images:
            # the prepended reference frames go before the decode
            latents = latents[:, c.vace_ref_images:]
        video = None
        if self.vae is not None:
            t1 = synced_clock(latents)
            video = self.vae.decode(latents)
            timings["decode_s"] = synced_clock(video) - t1
        timings["total_s"] = synced_clock(latents) - t0
        return PipelineOutput(latents=latents, calibration=calibration,
                              timings=timings, skips=skips, video=video)

    # ---- batched generation ----------------------------------------------
    def generate_batch(self, prompts, negative_prompt: str = DEFAULT_NEGATIVE,
                       seed: int = 0, seeds=None) -> PipelineOutput:
        """Several text-only prompts through one batched denoise: latents
        ``f32[B, F, H, W, C]`` and ``timings {"total_s", "prompts"}``, no
        decode (as the JAX ``generate_batch``). The CFG rows are
        ``[cond x B; uncond x B]``, so each cache lane holds one CFG branch of
        every element and the static schedule skips all of a lane's rows
        together, exactly as in a single run. Element ``j`` draws its noise
        as ``generate(seed=seeds[j])`` does, so it reproduces that run;
        without ``seeds`` it draws from ``seed + j``. ``total_s`` is the
        sampling's, as in JAX (the text encode before it is left out).
        TeaCache decides each lane from the mean over all its rows; Wan's
        signal (``e`` or ``e0``) depends on the step alone, so that mean is
        each element's own.

        Under a plan of dp d, dp rank r takes elements ``[r B/d, (r+1) B/d)``
        with both their CFG lanes (its sp and tp axes split each as in
        ``generate``), no collective runs across dp per step, and the
        latents are all-gathered over dp at the end, so every rank returns
        all ``B`` (the JAX package splits its rows over dp in the layout of
        its lane-stacked batch; the elements are independent, so the numbers
        are the same)."""
        c = self.config
        plan = self.plan
        dp, rank = (plan.dp, plan.dp_rank) if plan is not None else (1, 0)
        if c.task not in ("t2v", "ti2v"):
            raise ValueError(f"generate_batch takes text prompts only (t2v, ti2v "
                             f"without an image), not {c.task}")
        if c.magcache_calibration:
            raise ValueError("generate_batch is a generation-path surface; "
                             "calibrate with generate()")
        b = len(prompts)
        if seeds is not None and len(seeds) != b:
            raise ValueError(f"{len(seeds)} seeds for {b} prompts")
        if b % dp:
            raise ValueError(f"generate_batch at dp = {dp}: {b} prompts do not divide "
                             f"over the dp ranks")
        mine = range(rank * (b // dp), (rank + 1) * (b // dp))
        gens = [set_seed(seeds[j]) if seeds is not None else set_seed(seed, dp_rank=j)
                for j in mine]
        cond_c = self.text_encoder([prompts[j] for j in mine], device=self.device)
        cond_u = self.text_encoder([negative_prompt] * len(mine), device=self.device)
        cond = {"context": torch.cat([cond_c, cond_u])}
        x0 = torch.cat([self._initial_noise(g) for g in gens]).to(self.device)
        t0 = synced_clock(x0)
        inner = plan.without_dp() if plan is not None else None
        if c.moe_boundary is not None:
            latents, _ = self._sample_fn_moe(batch=len(mine), plan=inner)(x0, cond)
        else:
            latents, _ = self._sample_fn(False, plan=inner)(x0, cond)
        if dp > 1:
            latents = plan.dp_group.all_gather(latents, 0)
        return PipelineOutput(latents=latents,
                              timings={"total_s": synced_clock(latents) - t0,
                                       "prompts": b})
