"""FramePack's sectioned long-video pipeline and HunyuanVideo T2V (one
section), MagCache-enabled.

The counterpart of ``magcache_tpu.pipelines.framepack`` (reference
``MagCache4FramePack/magcache_demo_gradio.py`` and ``_f1.py``; HunyuanVideo
``MagCache4HunyuanVideo/magcache_sample_video.py`` runs through the same
pipeline with one section): video comes in sections of
``latent_window_size`` latent frames, each conditioned on the ones before,
and each section samples with a fresh cache, so MagCache's residual never
crosses a section (``:252-256``). Three history modes:

- "padded" (``pyramid``, model ``framepack``): sections run back to front
  with the padding schedule ``reversed(range(n))`` (``[3, 2, ..., 2, 1, 0]``
  above 4 sections); each conditions on the start latent and the clean
  history's pyramid (1x, 2x, 4x); the last section (pad 0) prepends the
  start latent (``:493-522``);
- F1 (``pyramid``, model ``framepack-f1``): sections run forward on the
  tail of the history buffer (``magcache_demo_gradio_f1.py:493-547``);
- flat (``pyramid=False``): the last ``history_frames`` latents ride ahead
  of the window (HunyuanVideo with ``history_frames=0`` has none).

One core per distinct ``pad`` is built and kept (at most 4). MagCache takes
the preset's FramePack guard (``|1 - ratio| <= 0.06`` and the ``cnt >= 1``
floor); TeaCache (``use_teacache``, exclusive with MagCache) rescales the
first double block's modulated input with ``FRAMEPACK_TEA_COEFFS`` and
always computes the first and last step. Calibration carries each section's
last residual into the next, one continuous run of ratios. Section noise is
drawn from the request's seeded CPU generator (or ``section_noise``).
The DiT has random weights from a seeded generator; the text encoders are
the mocks unless given. The output is latents: HunyuanVideo's VAE and
checkpoint loading are not ported.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from magcache_tpu_torch.core.presets import make_config
from magcache_tpu_torch.core.sampler import sample_euler
from magcache_tpu_torch.core.teacache import (FRAMEPACK_TEA_COEFFS, FRAMEPACK_TEA_THRESH,
                                              TeaCacheLanes)
from magcache_tpu_torch.models.flux import first_block_modulated
from magcache_tpu_torch.models.hunyuan import (HUNYUAN_VIDEO, HunyuanConfig,
                                               HunyuanModel, make_hunyuan_core)
from magcache_tpu_torch.models.published import load_hunyuan_checkpoint
from magcache_tpu_torch.models.text import MockPooledEncoder, MockTextEncoder
from magcache_tpu_torch.pipelines.base import (BasePipeline, PipelineOutput,
                                               calibration_dict, synced_clock, timed_encode)
from magcache_tpu_torch.schedulers.flow_match import FlowMatchSchedule
from magcache_tpu_torch.utils.misc import set_seed

FRAMEPACK_MODELS = ("framepack", "framepack-f1", "hunyuanvideo-720p", "hunyuanvideo-544p")
# pixels -> VAE latents (stride 8) -> 2x2 patch tokens
PIXELS_PER_TOKEN = 16


@dataclasses.dataclass
class FramePackPipelineConfig:
    model: str = "framepack"              # a FRAMEPACK_MODELS preset key
    height: int = 512
    width: int = 512
    latent_window_size: int = 9           # latent frames a section
    history_frames: int = 2               # flat mode's conditioning frames
    pyramid: bool = True                  # the clean-latent pyramid
    total_sections: int = 5
    steps: int = 25
    guidance: float = 10.0                # embedded (distilled) guidance
    flow_shift: float = 7.0
    txt_len: int = 64
    use_magcache: bool = False
    magcache_thresh: Optional[float] = None
    magcache_K: Optional[int] = None
    retention_ratio: Optional[float] = None
    use_teacache: bool = False
    teacache_thresh: Optional[float] = None   # None: FRAMEPACK_TEA_THRESH
    magcache_calibration: bool = False
    # a calibration run's norm_ratio list, in place of the published table
    mag_ratios_override: Optional[tuple] = None
    dtype: str = "bfloat16"
    tiny: bool = False
    ckpt_dir: Optional[str] = None     # a published transformer checkpoint

    def __post_init__(self):
        if self.model not in FRAMEPACK_MODELS:
            raise ValueError(f"FramePack model {self.model!r}: one of {FRAMEPACK_MODELS}")
        if self.pyramid and (self.height % 64 or self.width % 64):
            raise ValueError(
                f"pyramid mode needs height and width divisible by 64 (the 4x "
                f"clean-latent level patchifies (4, 8, 8) over the latent grid); got "
                f"{self.height}x{self.width}")

    def model_config(self) -> HunyuanConfig:
        if self.tiny:
            return HunyuanConfig.tiny(dtype=self.dtype, framepack=self.pyramid)
        return dataclasses.replace(HUNYUAN_VIDEO, dtype=self.dtype, framepack=self.pyramid)


def _paddings(n: int) -> List[int]:
    """The padded mode's per-section paddings, back to front."""
    return list(reversed(range(n))) if n <= 4 else [3] + [2] * (n - 3) + [1, 0]


class FramePackPipeline(BasePipeline):
    """FramePack / HunyuanVideo on ``device`` (the card unless told
    otherwise). Without ``model``, the DiT of ``config.model_config()`` gets
    random weights from a generator seeded with ``init_seed``; a given
    ``model`` brings its own config and, in pyramid mode, needs the
    clean-latent projections."""

    def __init__(self, config: FramePackPipelineConfig, device="cuda", text_encoder=None,
                 pooled_encoder=None, model: Optional[HunyuanModel] = None,
                 init_seed: int = 0):
        self.config = c = config
        self.device = torch.device(device)
        if model is None:
            model = HunyuanModel(c.model_config(), self.device)
            if c.ckpt_dir:
                model.load_state_dict(load_hunyuan_checkpoint(c.ckpt_dir, model.cfg))
            else:
                model.init(set_seed(init_seed, device=self.device))
        if c.pyramid and not model.cfg.framepack:
            raise ValueError("pyramid mode needs a model with the clean-latent "
                             "projections (framepack=True)")
        self.model = model.requires_grad_(False).eval()
        self.model_cfg = model.cfg
        p = PIXELS_PER_TOKEN
        self.grid = (c.latent_window_size, c.height // p, c.width // p)
        self.lat_shape = (c.latent_window_size, 2 * (c.height // p), 2 * (c.width // p),
                          self.model_cfg.in_channels)
        self._cores = {}                  # section padding (None: flat) -> core
        self.text_encoder = text_encoder or MockTextEncoder(
            c.txt_len, self.model_cfg.text_dim, scale=0.5)
        self.pooled_encoder = pooled_encoder or MockPooledEncoder(self.model_cfg.vec_dim)
        self.schedule = FlowMatchSchedule.create(c.steps, shift=c.flow_shift)

    def core(self, pad: Optional[int] = None):
        """The section core for ``pad`` (None: the flat mode's), built once."""
        if pad not in self._cores:
            c = self.config
            if pad is None:
                kw = dict(history_frames=c.history_frames)
            else:
                kw = dict(framepack_pad=pad,
                          framepack_order="f1" if c.model.endswith("f1") else "padded")
            self._cores[pad] = make_hunyuan_core(self.model, c.txt_len, self.grid, **kw)
        return self._cores[pad]

    def cache_cfg(self):
        """The preset's single-lane MagCacheConfig with the config's E/K/R
        and ``mag_ratios_override``."""
        c = self.config
        return make_config(c.model, c.steps, thresh=c.magcache_thresh, K=c.magcache_K,
                           retention_ratio=c.retention_ratio, ratios=c.mag_ratios_override)

    def _teacache(self) -> TeaCacheLanes:
        c = self.config
        return TeaCacheLanes(
            thresh=FRAMEPACK_TEA_THRESH if c.teacache_thresh is None else c.teacache_thresh,
            coefficients=FRAMEPACK_TEA_COEFFS, ret_steps=1, cutoff_steps=c.steps - 1,
            lanes=1, signal_fn=functools.partial(first_block_modulated, self.model.mmdit))

    def generate(self, prompt: str, seed: int = 31337,
                 on_section: Optional[Callable] = None,
                 start_latent: Optional[torch.Tensor] = None,
                 section_noise: Optional[Callable] = None) -> PipelineOutput:
        """The section loop: latents ``f32[1, frames, H/8, W/8, C]`` in time
        order. ``on_section(i, latents)`` gets each finished section (in
        padded mode the last one with the start latent prepended);
        ``start_latent`` (``[1, H/8, W/8, C]``) is the image's latent (i2v);
        ``section_noise(i, shape)`` replaces the seeded draw of section i's
        noise. ``skips`` holds the realized bits ``[sections, steps, 1]``
        (none in calibration mode, which fills ``calibration``)."""
        t0 = time.time()
        c = self.config
        if c.use_magcache and c.use_teacache:
            raise ValueError("use_magcache and use_teacache are mutually exclusive "
                             "(magcache_demo_gradio.py:30-52)")
        dev = self.device
        txt, txt_s = timed_encode(self.text_encoder, [prompt], dev)
        vec, vec_s = timed_encode(self.pooled_encoder, [prompt], dev)
        base_cond = {"txt": txt, "vec": vec,
                     "guidance": torch.full((1,), c.guidance, dtype=torch.float32, device=dev)}
        sch = self.schedule
        common = dict(timesteps=sch.timesteps, dts=np.diff(sch.sigmas))
        if c.magcache_calibration:
            mode = dict(calibrate=True)
        elif c.use_teacache:
            mode = dict(dynamic_skip=self._teacache(), return_skips=True)
        else:
            mode = dict(cache_cfg=self.cache_cfg() if c.use_magcache else None,
                        return_skips=True)
        gen = set_seed(seed)
        shape = (1,) + self.lat_shape
        sec_skips, sec_stats, carry = [], [], [None]

        def run(s: int, pad: Optional[int], cond: dict) -> torch.Tensor:
            x0 = (section_noise(s, shape) if section_noise is not None
                  else torch.randn(shape, generator=gen, dtype=torch.float32))
            x0 = torch.as_tensor(x0, dtype=torch.float32).to(dev)
            if c.magcache_calibration:
                lat, stats, carry[0] = sample_euler(
                    self.core(pad), x0, cond, prev_residual=carry[0],
                    return_residual=True, **mode, **common)
                sec_stats.append(stats)
            else:
                lat, skips = sample_euler(self.core(pad), x0, cond, **mode, **common)
                sec_skips.append(skips)
            return lat

        hw = self.lat_shape[1:]
        start = (torch.zeros((1, 1) + hw, device=dev) if start_latent is None
                 else torch.as_tensor(start_latent).float().to(dev)[:, None])
        sections: List[torch.Tensor] = []
        if c.pyramid and c.model.endswith("f1"):
            # history = [zeros(16 + 2 + 1); start; generated...], each section
            # conditioned on the tail [4x (16); 2x (2); 1x (1)]
            hbuf = torch.cat([torch.zeros((1, 19) + hw, device=dev), start], dim=1)
            for s in range(c.total_sections):
                tail = hbuf[:, -19:]
                cond = dict(base_cond, clean=torch.cat([start, tail[:, 18:19]], dim=1),
                            clean_2x=tail[:, 16:18], clean_4x=tail[:, :16])
                lat = run(s, 0, cond)
                hbuf = torch.cat([hbuf, lat], dim=1)
                sections.append(lat)
                if on_section is not None:
                    on_section(s, lat)
        elif c.pyramid:
            # history = [post (1); 2x (2); 4x (16); generated...], back to front
            hbuf = torch.zeros((1, 19) + hw, device=dev)
            for s, pad in enumerate(_paddings(c.total_sections)):
                cond = dict(base_cond, clean=torch.cat([start, hbuf[:, :1]], dim=1),
                            clean_2x=hbuf[:, 1:3], clean_4x=hbuf[:, 3:19])
                lat = run(s, pad, cond)
                if pad == 0:        # the last section: the start latent leads
                    lat = torch.cat([start, lat], dim=1)
                hbuf = torch.cat([lat, hbuf], dim=1)
                sections.insert(0, lat)
                if on_section is not None:
                    on_section(s, lat)
        else:
            hf = c.history_frames
            hbuf = start.expand((1, hf) + hw)     # zeros without a start latent
            for s in range(c.total_sections):
                cond = dict(base_cond, history=hbuf) if hf else base_cond
                lat = run(s, None, cond)
                if hf:
                    hbuf = lat[:, -hf:]
                sections.append(lat)
                if on_section is not None:
                    on_section(s, lat)
        latents = torch.cat(sections, dim=1)
        calibration = (calibration_dict(np.concatenate(sec_stats, axis=0))
                       if c.magcache_calibration else None)
        timings = {"text_s": txt_s + vec_s, "sections": c.total_sections,
                   "total_s": synced_clock(latents) - t0}
        return PipelineOutput(latents=latents, calibration=calibration, timings=timings,
                              skips=None if c.magcache_calibration else np.stack(sec_skips))
