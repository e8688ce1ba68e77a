"""FLUX.1 text-to-image and Kontext pipeline, MagCache-enabled.

The checkpoint-free path of ``magcache_tpu.pipelines.flux`` (reference
``MagCache4FLUX/magcache_flux.py:446-484``): prompt -> mock T5 states and
mock CLIP pooled vector -> seeded packed latents -> cached Euler denoise (28
steps, FLUX's resolution-dependent ``mu`` shift on ``linspace(1, 1/n, n)``).
Guidance is embedded (a guidance-distilled model), so there is no CFG batch
and MagCache keeps one cache lane. Kontext (``generate(cond_latents=...)``)
appends the conditioning image's packed latents after the noise tokens,
with index-1 rope ids; the head drops them.

The DiT loads ``ckpt_dir`` (a black-forest-labs checkpoint; with
``lora_path`` an adapter merged in first, scaled by ``lora_scale``) or takes
random weights from a seeded ``torch.Generator``. With ``vae=``
(an ``SDVAE`` of 16 latent channels and stride 8, e.g. ``FLUX_VAE``) the
packed latents are unpacked, ``from_latent`` undoes the VAE's shift and
scale, and the decode fills ``image``; without one the packed latents are the
output. ``encode_image`` turns a conditioning image into Kontext's packed
latents (the JAX CLI's ``_image_to_grid_latent``): through the VAE when the
pipeline has one, else by the JAX package's checkpoint-free nearest resize
and channel tile. Not ported yet (raise): multi-device plans
(``dp``/``sp``/``tp`` > 1).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from magcache_tpu_torch.core.magcache import MagCacheConfig
from magcache_tpu_torch.core.presets import make_config
from magcache_tpu_torch.core.sampler import lane_skip_masks, sample_euler
from magcache_tpu_torch.models.flux import (FLUX_DEV, FluxConfig, FluxModel,
                                            make_flux_core, pack_latents, unpack_latents)
from magcache_tpu_torch.models.published import load_flux_checkpoint
from magcache_tpu_torch.models.text import MockPooledEncoder, MockTextEncoder
from magcache_tpu_torch.models.vae_wan import WanVAE
from magcache_tpu_torch.pipelines.base import (BasePipeline, PipelineOutput,
                                               calibration_dict, check_image_vae,
                                               decode_pixels, synced_clock, timed_encode)
from magcache_tpu_torch.schedulers.flow_match import FlowMatchSchedule
from magcache_tpu_torch.utils.misc import set_seed

FLUX_MODELS = ("flux-dev", "flux-kontext-dev")
# pixels -> VAE latents (the SD VAE's spatial stride) -> 2x2 packed tokens
VAE_SPATIAL_STRIDE = 8


def load_image(path: str) -> np.ndarray:
    """An input image as ``f32 [H, W, 3]`` in [0, 1]: a ``.npy`` array as it
    is (uint8 scaled by 1/255), any other file through PIL (imported here:
    only image files need it)."""
    if path.endswith(".npy"):
        img = np.load(path)
    else:
        from PIL import Image

        with Image.open(path) as im:
            img = np.asarray(im.convert("RGB"))
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    return np.asarray(img, np.float32)


def _nearest_resize(a: np.ndarray, h: int, w: int) -> np.ndarray:
    ys = (np.arange(h) * a.shape[0] // h).clip(0, a.shape[0] - 1)
    xs = (np.arange(w) * a.shape[1] // w).clip(0, a.shape[1] - 1)
    return a[ys][:, xs]


def image_to_grid_latent(vae, img: np.ndarray, h_lat: int, w_lat: int, c_lat: int
                         ) -> np.ndarray:
    """A pixel image ``[H, W, 3]`` in [0, 1] -> a conditioning latent ``f32
    [h_lat, w_lat, c_lat]`` (the JAX CLI's ``_image_to_grid_latent``).

    With ``vae``: pixels to [-1, 1], the encode's mean (an ``SDVAE``'s
    through ``to_latent``; a ``WanVAE`` encodes the image as a one-frame
    video, its mean already normalized), and a nearest resize where the grid
    differs; a VAE of other latent channels raises ``ValueError``. Without
    one: a nearest resize and the channels tiled to ``c_lat`` (shape-correct
    conditioning for checkpoint-free runs only)."""
    if vae is not None:
        px = torch.from_numpy(np.asarray(img, np.float32) * 2.0 - 1.0)[None]
        if isinstance(vae, WanVAE):
            mean, _ = vae.encode(px[:, None])
            lat = mean[0, 0].cpu().numpy()
        else:
            mean, _ = vae.encode(px)
            lat = vae.to_latent(mean)[0].cpu().numpy()
        if lat.shape[:2] != (h_lat, w_lat):
            lat = _nearest_resize(lat, h_lat, w_lat)
        if lat.shape[-1] != c_lat:
            raise ValueError(f"the VAE gives {lat.shape[-1]} latent channels but the "
                             f"model conditions on {c_lat}: wrong VAE for this model")
        return lat
    px = _nearest_resize(np.asarray(img, np.float32), h_lat, w_lat)
    reps = -(-c_lat // px.shape[-1])
    return np.tile(px, (1, 1, reps))[:, :, :c_lat]


@dataclasses.dataclass
class FluxPipelineConfig:
    model: str = "flux-dev"              # preset key: flux-dev | flux-kontext-dev
    height: int = 1024
    width: int = 1024
    num_inference_steps: int = 28
    guidance: float = 3.5
    txt_len: int = 512
    use_magcache: bool = False
    magcache_thresh: Optional[float] = None
    magcache_K: Optional[int] = None
    retention_ratio: Optional[float] = None
    magcache_calibration: bool = False
    # recorded norm_ratio list from a calibration run; replaces the
    # published table through the same pad and resample path
    mag_ratios_override: Optional[tuple] = None
    dtype: str = "bfloat16"
    dp: int = 1
    sp: int = 1
    tp: int = 1
    ckpt_dir: Optional[str] = None
    lora_path: Optional[str] = None      # a PEFT / kohya adapter, merged at load
    lora_scale: float = 1.0
    tiny: bool = False

    def __post_init__(self):
        if self.model not in FLUX_MODELS:
            raise ValueError(f"FLUX model {self.model!r}: one of {FLUX_MODELS}")
        if self.lora_path and not self.ckpt_dir:
            raise ValueError("lora_path merges into a checkpoint: it needs ckpt_dir")
        if self.dp * self.sp * self.tp > 1:
            raise NotImplementedError("multi-device FLUX (dp/sp/tp > 1) is "
                                      "not ported yet")

    def model_config(self) -> FluxConfig:
        if self.tiny:
            return FluxConfig.tiny(dtype=self.dtype)
        return dataclasses.replace(FLUX_DEV, dtype=self.dtype)

    def packed_grid(self) -> Tuple[int, int]:
        # pixels -> VAE/8 latents -> 2x2 packed tokens
        return (self.height // 16, self.width // 16)


class FluxPipeline(BasePipeline):
    """FLUX.1-dev / Kontext on ``device`` (the card unless told otherwise).
    Without ``model``, the DiT of ``config.model_config()`` gets random
    weights from a generator seeded with ``init_seed``; a given ``model``
    brings its own config. ``vae`` (an ``SDVAE``) must have the packed
    latents' channels (``in_channels / 4``) and stride 8."""

    def __init__(self, config: FluxPipelineConfig, device="cuda", text_encoder=None,
                 pooled_encoder=None, model: Optional[FluxModel] = None,
                 init_seed: int = 0, vae=None):
        self.config = config
        c = config
        self.device = torch.device(device)
        self.grid = c.packed_grid()
        model_cfg = model.cfg if model is not None else c.model_config()
        # the model's tokens pack 2x2 latent positions
        check_image_vae(vae, model_cfg.in_channels // 4, VAE_SPATIAL_STRIDE)
        self.vae = vae
        if model is None:
            model = FluxModel(model_cfg, self.device)
            if c.ckpt_dir:
                # on the card: an adapter merges there, in f32
                model.load_state_dict(load_flux_checkpoint(
                    c.ckpt_dir, model_cfg, self.device, c.lora_path, c.lora_scale))
            else:
                model.init(set_seed(init_seed, device=self.device))
        self.model_cfg = model.cfg
        self.model = model.requires_grad_(False).eval()
        self.core = make_flux_core(self.model, c.txt_len, *self.grid)
        self._core_kontext = None    # built on the first conditioned call
        self.text_encoder = text_encoder or MockTextEncoder(
            c.txt_len, self.model_cfg.text_dim, scale=0.5)
        self.pooled_encoder = pooled_encoder or MockPooledEncoder(
            self.model_cfg.vec_dim)
        gh, gw = self.grid
        self.schedule = FlowMatchSchedule.create(
            c.num_inference_steps, mu=FlowMatchSchedule.flux_mu(gh * gw),
            linspace_endpoint=True)

    def _cache_cfg(self, thresh=None, K=None, retention=None) -> MagCacheConfig:
        """The preset's single-lane MagCacheConfig with the config's (or the
        given) E/K/R and ``mag_ratios_override``."""
        c = self.config
        return make_config(
            c.model, c.num_inference_steps,
            thresh=c.magcache_thresh if thresh is None else thresh,
            K=c.magcache_K if K is None else K,
            retention_ratio=c.retention_ratio if retention is None else retention,
            ratios=c.mag_ratios_override)

    def skip_mask_for(self, thresh=None, K=None, retention_ratio=None,
                      use_magcache: bool = True) -> np.ndarray:
        """Host-precomputed ``bool[steps, 1]`` skip mask for an E/K/R triple
        (one lane: embedded guidance, no CFG batch), for
        ``generate(skip_override=...)``; all-False is full compute."""
        steps = self.config.num_inference_steps
        if not use_magcache:
            return np.zeros((steps, 1), bool)
        return lane_skip_masks(self._cache_cfg(thresh, K, retention_ratio), steps)[0]

    def encode_image(self, img: np.ndarray) -> torch.Tensor:
        """A conditioning image ``[H, W, 3]`` in [0, 1] -> Kontext's packed
        latents ``f32[1, gh*gw, in_channels]`` on the pipeline's device (for
        ``generate(cond_latents=...)``), through ``image_to_grid_latent``
        with the pipeline's VAE (or without one)."""
        gh, gw = self.grid
        lat = image_to_grid_latent(self.vae, img, 2 * gh, 2 * gw,
                                   self.model_cfg.in_channels // 4)
        return pack_latents(torch.from_numpy(np.ascontiguousarray(lat))[None]).to(self.device)

    def _core(self, kontext: bool):
        if not kontext:
            return self.core
        if self._core_kontext is None:
            self._core_kontext = make_flux_core(
                self.model, self.config.txt_len, *self.grid, kontext=True)
        return self._core_kontext

    def _initial_noise(self, seed: int) -> torch.Tensor:
        """Seeded packed noise ``f32[1, gh*gw, in_channels]`` (a CPU
        generator, so the draw is the same on every device)."""
        gh, gw = self.grid
        return torch.randn((1, gh * gw, self.model_cfg.in_channels),
                           generator=set_seed(seed),
                           dtype=torch.float32).to(self.device)

    def generate(self, prompt: str, seed: int = 42,
                 cond_latents: Optional[torch.Tensor] = None,
                 skip_override: Optional[np.ndarray] = None) -> PipelineOutput:
        """One image's packed latents ``f32[1, gh*gw, in_channels]`` (and
        with a VAE its pixels ``image f32[1, 16 gh, 16 gw, 3]``).

        ``cond_latents`` (``[1, gh*gw, in_channels]``, packed) runs Kontext
        conditioning; ``skip_override`` (``bool[steps, 1]`` from
        ``skip_mask_for``) replaces the config's schedule. ``skips`` holds the
        realized skip bits (none in calibration mode, which fills
        ``calibration``)."""
        t0 = time.time()
        c = self.config
        calibrate = c.magcache_calibration
        if calibrate and skip_override is not None:
            raise ValueError("skip_override is a generation-path surface")
        txt, txt_s = timed_encode(self.text_encoder, [prompt], self.device)
        vec, vec_s = timed_encode(self.pooled_encoder, [prompt], self.device)
        cond = {"txt": txt, "vec": vec,
                "guidance": torch.full((1,), c.guidance, dtype=torch.float32,
                                       device=self.device)}
        if cond_latents is not None:
            cond["kontext"] = torch.as_tensor(cond_latents).float().to(self.device)
        core = self._core(cond_latents is not None)
        x0 = self._initial_noise(seed)
        sch = self.schedule
        common = dict(timesteps=sch.timesteps, dts=np.diff(sch.sigmas))
        if calibrate:
            latents, stats = sample_euler(core, x0, cond, calibrate=True, **common)
            calibration, skips = calibration_dict(stats), None
        else:
            cache_cfg = (self._cache_cfg()
                         if c.use_magcache or skip_override is not None else None)
            latents, skips = sample_euler(core, x0, cond, cache_cfg=cache_cfg,
                                          skip_mask_override=skip_override,
                                          return_skips=True, **common)
            calibration = None
        image, timings = decode_pixels(self.vae, unpack_latents(latents, *self.grid))
        timings["text_s"] = txt_s + vec_s
        timings["total_s"] = synced_clock(latents) - t0
        return PipelineOutput(latents=latents, calibration=calibration, timings=timings,
                              skips=skips, image=image)
