"""Open-Sora 1.2 video generation on STDiT3 + RFLOW, MagCache-enabled.

The ``magcache_tpu.pipelines.open_sora`` pipeline (reference stack
``videosys/pipelines/open_sora/pipeline_open_sora.py``): prompt score
appending and T5 caption cleaning -> text encode -> seeded noise latents ->
Euler RFLOW loop with CFG as one joint batch of 2 rows ([cond, uncond]), so
MagCache keeps a single cache lane over the joint batch (the eval harness's
configuration, ``eval/magcache/experiments/opensora.py``). With a mask
strategy, ``.npy`` latent references or ``loop > 1`` it runs the masked-frame
sampler (``sample_rflow_masked``): references pasted into the noise, frames
frozen or re-noised by their edit ratio, and each follow-on clip conditioned
on the previous clip's last latents. The checkpoint-free path:
``MockTextEncoder`` and random STDiT3 weights from a seeded
``torch.Generator``. With ``vae=`` (a ``models.vae.MicroFrameVAE`` of the
SD spatial VAE and the temporal VAE, as ``open_sora_vae`` builds it) the
latents, looped clips trimmed and joined, decode into ``video``, and image
and video references encode through it; both apply the VAE's latent
scales, which the JAX pipeline leaves out. Without a VAE the latents are
the output and image and video references raise.

``route`` picks STDiT3's block composition (``models.stdit3``: "packed",
"grouped" or "vpu"), for the masked-frame sampler too.

Cache policies: the published opensora-v1.2 MagCache rule
(``cache_policy="adapter"``) or the eval scripts' rolling rule
(``"rolling"``, ``core.rolling.RollingCacheConfig.opensora``); Pyramid
Attention Broadcast (``enable_pab``, ``pab_config``, default
``OPEN_SORA_PAB``) on every route, over the schedule's own timesteps, alone
or under MagCache, with references and loops too (the masked sampler
carries the PAB state).

Latent geometry: VAE stride 8 in space and ``get_latent_t`` in time (51
frames -> 15 latents), 4 channels; DiT patch (1, 2, 2).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from magcache_tpu_torch.core.pab import OPEN_SORA_PAB, PABConfig
from magcache_tpu_torch.core.presets import make_config
from magcache_tpu_torch.core.rolling import RollingCacheConfig
from magcache_tpu_torch.core.sampler import (lane_skip_masks, sample_euler,
                                             sample_rflow_masked)
from magcache_tpu_torch.models.published import load_stdit3_checkpoint
from magcache_tpu_torch.models.stdit3 import (STDIT3_XL_2, STDiT3Config,
                                              STDiT3Model, make_stdit3_core)
from magcache_tpu_torch.models.text import MockTextEncoder
from magcache_tpu_torch.pipelines import open_sora_cond as oc
from magcache_tpu_torch.pipelines.base import (BasePipeline, PipelineOutput,
                                               calibration_dict, cfg_combine, synced_clock,
                                               timed_encode)
from magcache_tpu_torch.schedulers.rflow import RFlowSchedule
from magcache_tpu_torch.utils.misc import set_seed

VAE_SPATIAL_STRIDE = 8
VAE_TEMPORAL_STRIDE = 4
MICRO_FRAME_SIZE = 17      # get_latent_t's chunk: 17 frames -> 5 latents


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
    # "adapter": the published opensora-v1.2 rule; "rolling": the eval
    # scripts' single-lane rule (experiments/opensora.py:296-312)
    cache_policy: str = "adapter"
    enable_pab: bool = False
    pab_config: PABConfig = OPEN_SORA_PAB
    dtype: str = "float32"
    tiny: bool = False
    ckpt_dir: Optional[str] = None     # a published transformer checkpoint
    route: str = "packed"                     # STDiT3's block composition

    def __post_init__(self):
        if self.cache_policy not in ("adapter", "rolling"):
            raise ValueError(f"cache_policy must be adapter or rolling, got "
                             f"{self.cache_policy!r}")
        if self.resolution is not None:
            ar = self.aspect_ratio or "9:16"
            self.height, self.width = oc.get_image_size(self.resolution, ar)
        self.num_frames = oc.get_num_frames(self.num_frames)

    def model_config(self) -> STDiT3Config:
        if self.tiny:
            return STDiT3Config.tiny(dtype=self.dtype)
        return dataclasses.replace(STDIT3_XL_2, dtype=self.dtype)


class OpenSoraPipeline(BasePipeline):
    """Open-Sora 1.2 on ``device`` (the card unless told otherwise).
    Without ``model``, STDiT3 gets random weights from a generator seeded
    with ``init_seed``; a given ``model`` brings its own configuration
    (widths, caption dim). ``vae`` (a ``MicroFrameVAE``) must have the
    latents' geometry: chunks of 17 frames, 4x in time, 8x in space, the
    model's latent channels."""

    def __init__(self, config: OpenSoraPipelineConfig, device="cuda",
                 text_encoder=None, model: Optional[STDiT3Model] = None,
                 init_seed: int = 0, vae=None):
        self.config = config
        c = config
        self.device = torch.device(device)
        self.model_cfg = model.cfg if model is not None else c.model_config()
        if vae is not None:
            got = (vae.micro_frame_size, vae.temporal.cfg.time_factor,
                   vae.spatial.cfg.spatial_down, vae.temporal.cfg.embed_dim)
            want = (MICRO_FRAME_SIZE, VAE_TEMPORAL_STRIDE, VAE_SPATIAL_STRIDE,
                    self.model_cfg.in_channels)
            if got != want:
                raise ValueError(f"the VAE's (micro-frame size, time stride, space "
                                 f"stride, latent channels) {got} are not the "
                                 f"latents' {want}")
        self.vae = vae
        lat_t = oc.get_latent_t(c.num_frames)
        lat_h, lat_w = c.height // VAE_SPATIAL_STRIDE, c.width // VAE_SPATIAL_STRIDE
        self.latent_shape = (lat_t, lat_h, lat_w, self.model_cfg.in_channels)
        pt, ph, pw = self.model_cfg.patch
        self.grid = (lat_t // pt, lat_h // ph, lat_w // pw)
        self.schedule = RFlowSchedule.create(
            c.num_sampling_steps, use_timestep_transform=True, height=c.height,
            width=c.width, num_frames=c.num_frames)
        if model is None:
            model = STDiT3Model(self.model_cfg, self.device)
            if c.ckpt_dir:
                model.load_state_dict(load_stdit3_checkpoint(c.ckpt_dir, self.model_cfg))
            else:
                model.init(set_seed(init_seed, device=self.device))
        self.model = model.requires_grad_(False).eval()
        self.core = make_stdit3_core(self.model, self.grid, route=c.route,
                                     pab=c.pab_config if c.enable_pab else None,
                                     timesteps=self.schedule.timesteps,
                                     pixel_size=(c.height, c.width))
        self.text_encoder = text_encoder or MockTextEncoder(
            c.caption_len, self.model_cfg.caption_dim, scale=0.5)

    def _cache_cfg(self):
        """The single-lane cache config over the joint CFG batch (MagCache's,
        or the rolling rule's), or None when caching is off."""
        c = self.config
        if not c.use_magcache or c.magcache_calibration:
            return None
        if c.cache_policy == "rolling":
            st = (None if c.retention_ratio is None
                  else int(c.num_sampling_steps * c.retention_ratio))
            return RollingCacheConfig.opensora(
                c.num_sampling_steps, thresh=0.12 if c.magcache_thresh is None
                else c.magcache_thresh, K=3 if c.magcache_K is None else c.magcache_K,
                skip_time=st)
        return self._cache_cfg_force()

    def _cache_cfg_force(self, thresh=None, K=None, retention=None):
        """The adapter rule's single-lane config whatever ``use_magcache``
        and ``cache_policy`` say, with ``thresh``/``K``/``retention``
        replacing the config's E/K/R: the schedule of a per-request
        override."""
        c = self.config
        return make_config("opensora-v1.2", c.num_sampling_steps,
                           thresh=c.magcache_thresh if thresh is None else thresh,
                           K=c.magcache_K if K is None else K,
                           retention_ratio=c.retention_ratio if retention is None else retention,
                           ratios=c.magcache_ratios)

    def skip_mask_for(self, thresh=None, K=None, retention_ratio=None,
                      use_magcache: Optional[bool] = None) -> np.ndarray:
        """Host-precomputed ``bool[steps, 1]`` skip bits of one loop's steps
        (one lane over the joint CFG batch). With no argument: the config's
        own schedule (all False when caching is off). With any: the
        opensora-v1.2 adapter rule at that E/K/R (the config's for those
        left None), all False for ``use_magcache=False``, as JAX's
        ``skip_mask_for``; feed it to ``generate(skip_override=...)``."""
        if thresh is None and K is None and retention_ratio is None and use_magcache is None:
            return lane_skip_masks(self._cache_cfg(), self.config.num_sampling_steps)[0]
        return self._skip_mask_from_cfg(self._cache_cfg_force(thresh, K, retention_ratio),
                                        use_magcache is not False)

    def _initial_noise(self, gen: torch.Generator) -> torch.Tensor:
        """A loop's noise latents ``f32[1, T, H, W, C]`` on the CPU, drawn
        from the request's CPU generator, so every device gets the same
        draw."""
        return torch.randn((1,) + self.latent_shape, generator=gen,
                           dtype=torch.float32)

    def _renoise_fn(self, gen: torch.Generator):
        """A loop's re-noise source for ``sample_rflow_masked``: draws of the
        request's CPU generator."""
        return lambda step, shape: torch.randn(shape, generator=gen,
                                               dtype=torch.float32)

    def encode_reference(self, frames: np.ndarray) -> np.ndarray:
        """Reference frames ``[T, H, W, 3]`` in [-1, 1] -> latents ``f32 [T',
        H/8, W/8, C]`` on the host, through the VAE's ``encode`` (its latent
        scales included)."""
        if self.vae is None:
            raise ValueError("image and video references are encoded by the "
                             "pipeline's VAE: pass vae=, or .npy latents [T, H, W, C]")
        lat = self.vae.encode(torch.from_numpy(np.asarray(frames, np.float32))[None])
        return lat[0].float().cpu().numpy()

    def _collect_references(self, reference_paths: List[str]) -> List[list]:
        """Per-batch lists of reference latents ``[T, H, W, C]``
        (``pipeline_open_sora.py:736-751``) from ';'-separated paths: ``.npy``
        latents as they are, image and video files read with the
        ``resize_crop`` transform and encoded by the VAE (``ValueError``
        without one, before the file is read)."""
        refs_x = []
        for reference_path in reference_paths:
            ref = []
            for r_path in (reference_path or "").split(";") if reference_path else []:
                if r_path.endswith(".npy"):
                    lat = np.asarray(np.load(r_path), np.float32)
                    if lat.ndim != 4:
                        raise ValueError(f"reference {r_path!r}: latents must be "
                                         f"[T, H, W, C], got {lat.shape}")
                elif self.vae is None:
                    raise ValueError(f"reference {r_path!r}: image and video references "
                                     "are encoded by the pipeline's VAE: pass vae=, or "
                                     ".npy latents [T, H, W, C]")
                else:
                    c = self.config
                    lat = self.encode_reference(oc.read_from_path(r_path, (c.height, c.width)))
                ref.append(lat)
            refs_x.append(ref)
        return refs_x

    def _prompt(self, prompt: str, aes, flow, camera_motion,
                use_text_preprocessing: bool) -> str:
        """Score appending + twice-applied caption cleaning of each loop
        segment (``pipeline_open_sora.py:532-605``), merged back into one
        ``|i|``-indexed prompt."""
        segs, idxs = oc.split_prompt(prompt)
        segs = oc.append_score_to_prompts(segs, aes=aes, flow=flow,
                                          camera_motion=camera_motion)
        segs = [oc.text_preprocessing(s, use_text_preprocessing) for s in segs]
        return oc.merge_prompt(segs, idxs)

    def generate(self, prompt: str, negative_prompt: str = "", seed: int = 0,
                 loop: int = 1, ms: str = "", refs: str = "",
                 aes: Optional[float] = 6.5, flow: Optional[float] = None,
                 camera_motion: Optional[str] = None,
                 condition_frame_length: int = 5, align: Optional[int] = 5,
                 condition_frame_edit: float = 0.0,
                 use_text_preprocessing: bool = True,
                 skip_override: Optional[np.ndarray] = None) -> PipelineOutput:
        """One video's latents ``f32[1, T', H, W, 4]`` (and with a VAE its
        pixels ``video f32[1, F, 8H, 8W, 3]``, 17 frames for each 5 latents).

        ``ms`` (the mask strategy, ``loop,ref,ref_start,target_start,length,
        edit_ratio;...``) and ``refs`` (';'-separated ``.npy`` latent paths),
        or the same keys in a trailing JSON object of ``prompt``, condition
        frames on references; ``loop > 1`` generates follow-on clips, each
        conditioned on the last ``condition_frame_length`` latents of the one
        before (edit ratio ``condition_frame_edit``), trimmed of them and
        concatenated in time, so T' = T + (loop - 1) * (T -
        condition_frame_length). ``align`` snaps the strategy's start frames.
        A mask of all ones is the plain t2v loop. ``skips`` holds the realized
        skip bits ``bool[loop * steps, 1]``, loop after loop (none in
        calibration mode, which fills ``calibration`` and takes no mask
        strategy). ``skip_override`` (``bool[steps, 1]`` from
        ``skip_mask_for``) replaces the config's schedule on the plain t2v
        path only.
        """
        t0 = time.time()
        c = self.config
        calibrate = c.magcache_calibration
        if skip_override is not None and calibrate:
            raise ValueError("skip_override is a generation-path argument; "
                             "calibration runs full compute")
        cache_cfg = self._cache_cfg() if skip_override is None else self._cache_cfg_force()
        prompts, refs_l, ms_l = oc.extract_json_from_prompts([prompt], [refs], [ms])
        refs_x = self._collect_references(refs_l)
        merged = self._prompt(prompts[0], aes, flow, camera_motion,
                              use_text_preprocessing)
        fps = float(c.fps if self.latent_shape[0] > 1 else oc.IMG_FPS)
        sch = self.schedule
        common = dict(timesteps=sch.timesteps, dts=sch.dts(), lanes=2,
                      combine_fn=cfg_combine(c.cfg_scale, self.model_cfg.in_channels))
        gen = set_seed(seed)
        clips, all_skips, calibration, text_s = [], [], None, 0.0
        for loop_i in range(loop):
            if loop_i > 0:
                refs_x, ms_l = oc.append_generated(
                    None, [clips[-1][0].cpu().numpy()], refs_x, ms_l, loop_i,
                    condition_frame_length, condition_frame_edit)
            text = oc.extract_prompts_loop([merged], loop_i)[0]
            y, secs = timed_encode(self.text_encoder, [text, negative_prompt], self.device)
            text_s += secs
            cond = {"y": y, "fps": torch.full((2,), fps, dtype=torch.float32, device=self.device)}
            z = self._initial_noise(gen).numpy().copy()
            masks = oc.apply_mask_strategy(z, refs_x, ms_l, loop_i, align=align)
            if masks is not None and (masks >= 1.0).all():
                # mask-1 frames are never re-noised or reverted and see the
                # step's modulation: exactly the plain loop on the pasted z
                masks = None
            z = torch.from_numpy(z).to(self.device)
            if calibrate:
                if masks is not None:
                    raise ValueError("calibration records the plain t2v trajectory; "
                                     "drop the mask strategy and loop conditioning")
                latents, stats = sample_euler(self.core, z, cond, calibrate=True,
                                              calibrate_lanes=1, **common)
                calibration = calibration_dict(stats)
            elif masks is None:
                latents, skips = sample_euler(self.core, z, cond, cache_cfg=cache_cfg,
                                              skip_mask_override=skip_override,
                                              return_skips=True, **common)
            elif skip_override is not None:
                raise ValueError("skip_override covers the plain t2v path, not a mask "
                                 "strategy or a looped clip")
            else:
                latents, skips = sample_rflow_masked(
                    self.core, z, cond, num_train_timesteps=sch.num_train_timesteps,
                    mask=masks, noise_fn=self._renoise_fn(gen),
                    cache_cfg=cache_cfg, return_skips=True, **common)
            if not calibrate:
                all_skips.append(skips)
            clips.append(latents)
        latents = torch.cat([clips[0]] + [cl[:, condition_frame_length:]
                                          for cl in clips[1:]], dim=1)
        timings, video = {"text_s": text_s}, None
        if self.vae is not None:
            t1 = synced_clock(latents)
            video = self.vae.decode(latents)
            timings["decode_s"] = synced_clock(video) - t1
        timings["total_s"] = synced_clock(latents) - t0
        return PipelineOutput(latents=latents, calibration=calibration, timings=timings,
                              skips=None if calibrate else np.concatenate(all_skips),
                              video=video)
