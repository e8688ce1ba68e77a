"""OmniGen2 text-to-image and edit pipeline: N-branch CFG with a MagCache
lane per guidance branch (``magcache_tpu.pipelines.omnigen2``; reference
``MagCache4OmniGen2``).

The guidance branches are cache lanes, each with its own calibrated ratio
array (``omnigen2-t2i_cond`` ... ``omnigen2-edit_ref``), interleaved into
one ``MagCacheConfig`` in the reference's call order (cond, uncond[, ref]).
Text-to-image is two-branch CFG through ``sample_euler``. Edit combines

    pred = uncond + ig * (ref - uncond) + tg * (cond - ref)

over two programs, as the reference's forward set has it: its uncond
predict drops the reference tokens from the sequence, so the cond and ref
rows run through the with-refs core (a two-lane cache, the half-batch
partial trunk where they disagree) and the uncond row through a ref-free
core (a one-lane cache): two trunks, three caches, one loop. Guidance
scales drop to 1 outside ``cfg_range`` (a window on ``step / steps``).

Every sampling route of the JAX pipeline: Euler or DPM-Solver++(2M) on the
flow sigmas (``scheduler="dpmsolver++"``), with MagCache or at full
compute; calibration (stats in lane order cond, uncond[, ref], step 0
dropped); the TaylorSeer and TeaCache comparators (Euler only: under them
``dpmsolver++`` prints a warning and runs Euler, as the JAX pipeline does).
TaylorSeer keeps its derivative stacks in f32 in both modes; the JAX edit
route keeps them in the trunk's dtype (ROADMAP §3).

The DiT loads ``ckpt_dir`` (an OmniGen2 ``transformer/`` directory, under
the config's model configuration as in JAX; with ``lora_path`` an adapter
merged in first, scaled by ``lora_scale``), or takes random weights from a
seeded ``torch.Generator`` (or is a given model); the text slot defaults to
the prompt-hashed mock. The output is the latents, as in JAX, whose
pipeline never decodes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from magcache_tpu_torch.core.calibration import calibration_stats
from magcache_tpu_torch.core.magcache import (MagCacheConfig, compute_skip_schedule,
                                              prepare_mag_ratios)
from magcache_tpu_torch.core.sampler import _cached_trunk, _decide, sample_euler
from magcache_tpu_torch.core.taylorseer import (TaylorSeerConfig, sample_euler_taylorseer,
                                                taylor_forecast, taylor_update,
                                                taylorseer_schedule)
from magcache_tpu_torch.core.teacache import TeaCacheLanes
from magcache_tpu_torch.data import get_calibrated_ratios
from magcache_tpu_torch.models.omnigen2 import (OMNIGEN2, OmniGen2Config, OmniGen2Model,
                                                make_omnigen2_core, make_teacache_signal)
from magcache_tpu_torch.models.published import load_omnigen2_checkpoint
from magcache_tpu_torch.models.text import MockTextEncoder
from magcache_tpu_torch.pipelines.base import (BasePipeline, PipelineOutput,
                                               calibration_dict, synced_clock, timed_encode)
from magcache_tpu_torch.pipelines.flux import image_to_grid_latent
from magcache_tpu_torch.schedulers.dpm_flow import dpmpp_2m_flow_coeffs
from magcache_tpu_torch.schedulers.flow_match import FlowMatchSchedule
from magcache_tpu_torch.utils.misc import set_seed

__all__ = ["OmniGen2PipelineConfig", "OmniGen2Pipeline", "make_omnigen2_cache_config",
           "OMNIGEN2_DEFAULT_NEGATIVE", "BRANCHES"]

BRANCHES = {"t2i": ("t2i_cond", "t2i_uncond"),
            "edit": ("edit_cond", "edit_uncond", "edit_ref")}
SCHEDULERS = ("euler", "dpmsolver++")

# the reference CLI's --negative_prompt default (inference.py:115-119)
OMNIGEN2_DEFAULT_NEGATIVE = (
    "(((deformed))), blurry, over saturation, bad anatomy, disfigured, "
    "poorly drawn face, mutation, mutated, (extra_limb), (ugly), "
    "(poorly drawn hands), fused fingers, messy drawing, broken legs censor, "
    "censored, censor_bar")


def make_omnigen2_cache_config(mode: str, sample_steps: int, *, thresh: float = 0.05,
                               K: int = 3, retention_ratio: float = 0.2) -> MagCacheConfig:
    """The per-branch calibrated arrays interleaved into one N-lane config:
    forward ``step * lanes + branch`` with branches (cond, uncond[, ref]),
    each array padded by one 1.0 and resampled to ``sample_steps`` on its
    own. Defaults E 0.05, K 3, R 0.2 (``magcache_utils.py:69, 82-83``)."""
    keys = BRANCHES[mode]
    lanes = len(keys)
    per_lane = [prepare_mag_ratios(get_calibrated_ratios(f"omnigen2-{k}"), sample_steps,
                                   lanes=1, pad=1) for k in keys]
    return MagCacheConfig(
        num_steps=sample_steps * lanes, mag_ratios=tuple(np.stack(per_lane, axis=1).reshape(-1)),
        thresh=thresh, max_consecutive_skips=K, retention_ratio=retention_ratio, lanes=lanes)


@dataclasses.dataclass
class OmniGen2PipelineConfig:
    mode: str = "edit"                 # t2i | edit
    height: int = 1024
    width: int = 1024
    num_inference_steps: int = 50
    text_guidance_scale: float = 5.0
    image_guidance_scale: float = 2.0
    cfg_range: tuple = (0.0, 1.0)      # step-fraction window for guidance
    txt_len: int = 128
    use_magcache: bool = False
    magcache_thresh: float = 0.05
    magcache_K: int = 3
    retention_ratio: float = 0.2
    # TaylorSeer: the reference's third, mutually exclusive switch
    enable_taylorseer: bool = False
    taylorseer_interval: int = 4
    taylorseer_order: int = 2
    taylorseer_warmup: int = 3
    # TeaCache: a policy per guidance branch, first and last steps forced;
    # the default polynomial is the raw relative-L1 distance
    enable_teacache: bool = False
    teacache_thresh: float = 0.05
    teacache_coeffs: tuple = (1.0, 0.0)
    scheduler: str = "euler"           # euler | dpmsolver++
    magcache_calibration: bool = False
    dtype: str = "bfloat16"
    tiny: bool = False
    ckpt_dir: Optional[str] = None
    lora_path: Optional[str] = None    # a PEFT / kohya adapter, merged at load
    lora_scale: float = 1.0
    ref_images: int = 1                # edit: the number of reference images

    def validate(self) -> "OmniGen2PipelineConfig":
        """Refuse what the pipeline cannot run: an unknown mode or scheduler,
        the overlaps of the mutually exclusive switches (the reference
        resolves them by if/elif priority, ``inference.py:208-212``), edit
        without a reference, and a LoRA path without a checkpoint.
        Calibration runs full compute whatever the cache switches say."""
        if self.mode not in BRANCHES:
            raise ValueError(f"OmniGen2 mode {self.mode!r}: one of {tuple(BRANCHES)}")
        if self.scheduler not in SCHEDULERS:
            raise ValueError(f"OmniGen2 scheduler {self.scheduler!r}: one of {SCHEDULERS}")
        if self.enable_taylorseer and self.use_magcache:
            raise ValueError("enable_taylorseer and use_magcache are mutually exclusive "
                             "(reference inference.py:208-212)")
        if self.enable_teacache and (self.use_magcache or self.enable_taylorseer):
            raise ValueError("enable_teacache is mutually exclusive with use_magcache / "
                             "enable_taylorseer")
        if self.mode == "edit" and self.ref_images < 1:
            raise ValueError("edit mode needs ref_images >= 1")
        if self.lora_path and not self.ckpt_dir:
            raise ValueError("lora_path merges into a checkpoint: it needs ckpt_dir")
        return self

    def model_config(self) -> OmniGen2Config:
        if self.tiny:
            return OmniGen2Config.tiny(dtype=self.dtype)
        return dataclasses.replace(OMNIGEN2, dtype=self.dtype)


class OmniGen2Pipeline(BasePipeline):
    """OmniGen2 on ``device`` (the card unless told otherwise). Without
    ``model``, the DiT of ``config.model_config()`` gets random weights from
    a generator seeded with ``init_seed``; a given ``model`` brings its own
    config. Edit builds a second, ref-free core over the same model."""

    def __init__(self, config: OmniGen2PipelineConfig, device="cuda", text_encoder=None,
                 model: Optional[OmniGen2Model] = None, init_seed: int = 0):
        self.config = c = config.validate()
        self.device = torch.device(device)
        if model is None:
            model = OmniGen2Model(c.model_config(), self.device)
            if c.ckpt_dir:
                # on the card: an adapter merges there, in f32
                sd, _ = load_omnigen2_checkpoint(
                    c.ckpt_dir, model.cfg, device=self.device, lora_path=c.lora_path,
                    lora_scale=c.lora_scale)
                model.load_state_dict(sd)
            else:
                model.init(set_seed(init_seed, device=self.device))
        self.model_cfg = model.cfg
        self.model = model.requires_grad_(False).eval()
        p = self.model_cfg.patch
        self.grid = (c.height // 8 // p, c.width // 8 // p)
        self.n_refs = c.ref_images if c.mode == "edit" else 0
        self.core = make_omnigen2_core(self.model, c.txt_len, self.grid, self.n_refs)
        self.core_noref = (make_omnigen2_core(self.model, c.txt_len, self.grid)
                           if self.n_refs else None)
        self.text_encoder = text_encoder or MockTextEncoder(
            c.txt_len, self.model_cfg.text_dim, scale=0.5)
        self.schedule = FlowMatchSchedule.create(c.num_inference_steps)

    @property
    def lanes(self) -> int:
        return len(BRANCHES[self.config.mode])

    def _cache_cfg(self) -> Optional[MagCacheConfig]:
        """The config's MagCache lanes, or None without ``use_magcache``."""
        c = self.config
        if not c.use_magcache:
            return None
        return make_omnigen2_cache_config(c.mode, c.num_inference_steps,
                                          thresh=c.magcache_thresh, K=c.magcache_K,
                                          retention_ratio=c.retention_ratio)

    def skip_schedule(self) -> np.ndarray:
        """The MagCache schedule ``bool[steps, lanes]`` in lane order (cond,
        uncond[, ref]); all False without ``use_magcache``."""
        n, cache_cfg = self.config.num_inference_steps, self._cache_cfg()
        if cache_cfg is None:
            return np.zeros((n, self.lanes), bool)
        return compute_skip_schedule(cache_cfg).reshape(n, self.lanes)

    def _combine(self):
        """Step-dependent guidance: the scales drop to 1 outside cfg_range
        (``i / steps`` in ``[lo, hi]``, ``magcache_utils.py:463-464``)."""
        c = self.config
        n = c.num_inference_steps
        lo, hi = c.cfg_range
        frac = np.arange(n) / n
        in_rng = (frac >= lo) & (frac <= hi)
        tg = np.where(in_rng, c.text_guidance_scale, 1.0).astype(np.float32)
        ig = np.where(in_rng, c.image_guidance_scale, 1.0).astype(np.float32)
        if c.mode == "t2i":
            def fn(outs, i):
                cond, uncond = outs
                return uncond + float(tg[i]) * (cond - uncond)
        else:
            def fn(outs, i):
                cond, uncond, ref = outs
                return uncond + float(ig[i]) * (ref - uncond) + float(tg[i]) * (cond - ref)
        return fn

    def _dpm(self):
        """DPM-Solver++(2M) coefficients, or None for Euler; the comparators
        run Euler (a warning, as in JAX)."""
        c = self.config
        if c.scheduler != "dpmsolver++":
            return None
        if c.enable_taylorseer or c.enable_teacache:
            print("WARNING: dpmsolver++ is wired for the full-compute and MagCache paths; "
                  "the TaylorSeer/TeaCache comparators run their reference euler loop.")
            return None
        return dpmpp_2m_flow_coeffs(self.schedule.sigmas)

    def _tea_policy(self, lanes: int, signal) -> TeaCacheLanes:
        c = self.config
        n = c.num_inference_steps
        return TeaCacheLanes(thresh=c.teacache_thresh, coefficients=tuple(c.teacache_coeffs),
                             ret_steps=lanes, cutoff_steps=(n - 1) * lanes, lanes=lanes,
                             signal_fn=signal)

    def _ts_config(self) -> TaylorSeerConfig:
        c = self.config
        return TaylorSeerConfig(num_steps=c.num_inference_steps, interval=c.taylorseer_interval,
                                order=c.taylorseer_order, warmup=c.taylorseer_warmup)

    def _sample_t2i(self, x, cond, dpm):
        """``(latents, skips, stats)`` through the generic samplers."""
        c = self.config
        sch = self.schedule
        common = dict(timesteps=sch.timesteps, dts=np.diff(sch.sigmas), lanes=2,
                      combine_fn=self._combine())
        if c.magcache_calibration:
            x, stats = sample_euler(self.core, x, cond, calibrate=True, dpm_coeffs=dpm,
                                    **common)
            return x, None, stats
        if c.enable_taylorseer:
            x, skips = sample_euler_taylorseer(self.core, x, cond, ts_cfg=self._ts_config(),
                                               return_skips=True, **common)
            return x, skips, None
        if c.enable_teacache:
            tea = self._tea_policy(2, make_teacache_signal(self.model))
            x, skips = sample_euler(self.core, x, cond, dynamic_skip=tea, return_skips=True,
                                    **common)
            return x, skips, None
        x, skips = sample_euler(self.core, x, cond, cache_cfg=self._cache_cfg(),
                                dpm_coeffs=dpm, return_skips=True, **common)
        if skips.shape[1] == 1:              # full compute: one bit for both lanes
            skips = np.repeat(skips, 2, axis=1)
        return x, skips, None

    @torch.inference_mode()
    def _sample_edit(self, x, cond_a, cond_b, dpm):
        """``(latents, skips bool[steps, 3], stats)``: the split-lane loop.
        The with-refs core runs rows [cond, ref] (a two-lane cache, the
        half-batch trunk where they disagree), the ref-free core [uncond];
        bits and stats come out in lane order (cond, uncond, ref)."""
        c = self.config
        n = c.num_inference_steps
        core_a, core_b = self.core, self.core_noref
        ts = np.asarray(self.schedule.timesteps, np.float32)
        dts = np.diff(self.schedule.sigmas).astype(np.float32)
        combine = self._combine()
        rows_a, rows_b = np.array([0, 1]), np.array([0])
        calibrate, taylor, tea = c.magcache_calibration, c.enable_taylorseer, c.enable_teacache
        mask = self.skip_schedule()
        if taylor:
            ts_cfg = self._ts_config()
            fresh, x_fc, upd, hist = taylorseer_schedule(ts_cfg)
        if tea:
            signal = make_teacache_signal(self.model)
            tea_a, tea_b = self._tea_policy(2, signal), self._tea_policy(1, signal)
            forced_a, forced_b = tea_a.forced_mask(n), tea_b.forced_mask(n)
            sa = sb = None
        ca = cb = da = db = None
        x0_prev = torch.zeros_like(x) if dpm is not None else None
        skips, stats = [], []
        for i in range(n):
            t = float(ts[i])
            ha, ctxa = core_a.prepare(torch.cat([x, x]), torch.full((2,), t, device=x.device),
                                      cond_a)
            hb, ctxb = core_b.prepare(x, torch.full((1,), t, device=x.device), cond_b)
            if ca is None:
                ca, cb = torch.zeros_like(ha), torch.zeros_like(hb)
            bits = np.zeros(3, bool)
            if calibrate:
                ta, tb = core_a.trunk(ha, ctxa), core_b.trunk(hb, ctxb)
                ra, rb = ta - ha, tb - hb
                stats.append(torch.stack([calibration_stats(ra[0:1], ca[0:1]),
                                          calibration_stats(rb, cb),
                                          calibration_stats(ra[1:2], ca[1:2])]))
                ca, cb = ra, rb
            elif taylor:
                if da is None:
                    da = torch.zeros((ts_cfg.order + 1,) + tuple(ha.shape), device=ha.device)
                    db = torch.zeros((ts_cfg.order + 1,) + tuple(hb.shape), device=hb.device)
                if fresh[i]:
                    ta, tb = core_a.trunk(ha, ctxa), core_b.trunk(hb, ctxb)
                    da = taylor_update(da, ta - ha, float(upd[i]), int(hist[i]), ts_cfg.order)
                    db = taylor_update(db, tb - hb, float(upd[i]), int(hist[i]), ts_cfg.order)
                else:
                    ta = (ha.float() + taylor_forecast(da, float(x_fc[i]), ts_cfg.order)
                          ).to(ha.dtype)
                    tb = (hb.float() + taylor_forecast(db, float(x_fc[i]), ts_cfg.order)
                          ).to(hb.dtype)
                    bits[:] = True
            else:
                if tea:
                    bits_a, sa = _decide(tea_a, ha, ctxa, sa, forced_a[i])
                    bits_b, sb = _decide(tea_b, hb, ctxb, sb, forced_b[i])
                else:
                    bits_a, bits_b = mask[i, [0, 2]], mask[i, 1:2]
                ta, ca, _ = _cached_trunk(core_a, ha, ctxa, ca, np.asarray(bits_a, bool),
                                          rows_a, 2)
                tb, cb, _ = _cached_trunk(core_b, hb, ctxb, cb, np.asarray(bits_b, bool),
                                          rows_b, None)
                bits[:] = (bits_a[0], bits_b[0], bits_a[1])
            outa, outb = core_a.head(ta, ctxa), core_b.head(tb, ctxb)
            e = combine((outa[0:1], outb, outa[1:2]), i).to(x.dtype)
            if dpm is not None:
                sg, av, bv, cxd, cdd = (float(dpm[k][i]) for k in
                                        ("sigma_t", "a", "b", "c_x", "c_d"))
                x0 = x - sg * e
                x = cxd * x + cdd * (av * x0 + bv * x0_prev)
                x0_prev = x0
            else:
                x = x + float(dts[i]) * e
            skips.append(bits)
        if calibrate:
            return x, None, torch.stack(stats[1:]).double().cpu().numpy()
        return x, np.stack(skips), None

    def encode_images(self, images) -> torch.Tensor:
        """Reference images (each ``[H, W, 3]`` in [0, 1]) -> their latents
        ``f32[1, R, gh*p, gw*p, C]`` on the pipeline's device (for
        ``generate(ref_latents=...)``): each nearest-resized to the latent
        grid and channel-tiled, the JAX CLI's ``_omnigen2_ref_latents``
        without a VAE."""
        gh, gw = self.grid
        pp, c_in = self.model_cfg.patch, self.model_cfg.in_channels
        lats = [image_to_grid_latent(None, img, gh * pp, gw * pp, c_in) for img in images]
        return torch.from_numpy(np.stack(lats)[None].astype(np.float32)).to(self.device)

    def _initial_noise(self, seed: int) -> torch.Tensor:
        """Seeded latents ``f32[1, gh*p, gw*p, C]`` (a CPU generator, the same
        draw on every device)."""
        gh, gw = self.grid
        pp, c_in = self.model_cfg.patch, self.model_cfg.in_channels
        return torch.randn((1, gh * pp, gw * pp, c_in), generator=set_seed(seed),
                           dtype=torch.float32).to(self.device)

    def generate(self, prompt: str, negative_prompt: str = OMNIGEN2_DEFAULT_NEGATIVE,
                 seed: int = 0, ref_latents: Optional[torch.Tensor] = None) -> PipelineOutput:
        """One image's latents ``f32[1, gh*p, gw*p, C]``.

        One prompt a branch: cond the prompt, uncond the negative prompt,
        ref (edit) ``"<ref-image-only>"``. ``ref_latents`` (edit: ``[1, R,
        gh*p, gw*p, C]``, zeros when not given) ride the cond and ref rows;
        the uncond row carries no reference tokens. ``skips`` holds the
        realized bits ``[steps, lanes]`` (True where a lane's trunk did not
        run: skipped, or forecast by TaylorSeer); none in calibration mode,
        which fills ``calibration``."""
        t0 = time.time()
        c = self.config
        prompts = [prompt, negative_prompt] + (["<ref-image-only>"] if self.n_refs else [])
        txt, txt_s = timed_encode(self.text_encoder, prompts, self.device)
        x0 = self._initial_noise(seed)
        dpm = self._dpm()
        if self.n_refs:
            gh, gw = self.grid
            pp, c_in = self.model_cfg.patch, self.model_cfg.in_channels
            shape = (1, self.n_refs, gh * pp, gw * pp, c_in)
            ref = (torch.zeros(shape) if ref_latents is None
                   else torch.as_tensor(ref_latents)).float().to(self.device)
            if tuple(ref.shape) != shape:
                raise ValueError(f"ref_latents {tuple(ref.shape)}: expected {shape}")
            cond_a = {"txt": txt[[0, 2]], "ref": torch.cat([ref, ref], dim=0)}
            latents, skips, stats = self._sample_edit(x0, cond_a, {"txt": txt[1:2]}, dpm)
        else:
            latents, skips, stats = self._sample_t2i(x0, {"txt": txt}, dpm)
        calibration = calibration_dict(stats) if stats is not None else None
        return PipelineOutput(latents=latents, calibration=calibration,
                              timings={"text_s": txt_s, "total_s": synced_clock(latents) - t0},
                              skips=skips)
