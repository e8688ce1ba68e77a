"""Pipeline base: the ``Config -> Pipeline.generate()`` convention."""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class PipelineOutput:
    latents: torch.Tensor                # f32 [B, F, H, W, C] (FLUX: packed
                                         # [B, S, C])
    calibration: Optional[dict] = None   # calibration-mode artifacts
    timings: Optional[dict] = None
    skips: Optional[np.ndarray] = None   # realized skip bits [steps, lanes]
    video: Optional[torch.Tensor] = None  # f32 pixels [B, F, H, W, 3] when a
                                          # VAE decoded the latents
    image: Optional[torch.Tensor] = None  # f32 pixels [B, H, W, 3] (FLUX)


class BasePipeline:
    """``generate(...)`` is the single entry point; ``__call__`` aliases it."""

    def generate(self, prompt, **kwargs) -> PipelineOutput:
        raise NotImplementedError

    def __call__(self, *args, **kwargs) -> PipelineOutput:
        return self.generate(*args, **kwargs)

    @staticmethod
    def _skip_mask_from_cfg(cache_cfg, use_magcache: bool = True) -> np.ndarray:
        """The host-precomputed ``bool[steps, lanes]`` skip mask of a cache
        config (all False without ``use_magcache``), for
        ``generate(skip_override=...)``: any E/K/R triple through one
        sampler call."""
        from magcache_tpu_torch.core.sampler import lane_skip_masks

        steps = cache_cfg.num_steps // cache_cfg.lanes
        if not use_magcache:
            return np.zeros((steps, cache_cfg.lanes), bool)
        return lane_skip_masks(cache_cfg, steps)[0]


def cfg_combine(guidance_scale: float, channels: Optional[int] = None):
    """The ``combine_fn`` of a [cond, uncond] lane pair: ``uncond + g *
    (cond - uncond)`` over the first ``channels`` of the head's output (all
    when None; an eps + variance head's sampler takes the eps half)."""
    def combine(chunks):
        cond_o, uncond_o = (c[..., :channels] for c in chunks)
        return uncond_o + guidance_scale * (cond_o - uncond_o)

    return combine


def calibration_dict(stats: np.ndarray) -> dict:
    """Flatten calibration stats ``[steps-1, lanes, 3]`` into the reference's
    printed lists (flat forward order, rounded to 5 decimals)."""
    flat = np.asarray(stats).reshape(-1, 3)
    return {
        "norm_ratio": [round(float(v), 5) for v in flat[:, 0]],
        "norm_std": [round(float(v), 5) for v in flat[:, 1]],
        "cos_dis": [round(float(v), 5) for v in flat[:, 2]],
    }


def synced_clock(t: torch.Tensor) -> float:
    """The host clock once the work queued on ``t``'s card is done."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return time.time()


def timed_encode(encoder, prompts, device):
    """``(states, seconds)``: ``encoder(prompts, device=device)`` (a text
    encoder slot's call) and its host seconds, ending once the card is done
    with it (``timings["text_s"]`` sums them)."""
    t0 = time.time()
    out = encoder(prompts, device=device)
    return out, synced_clock(out) - t0


def check_image_vae(vae, channels: int, stride: int) -> None:
    """Raise ``ValueError`` unless ``vae`` (an ``SDVAE``, or None) has a
    model's latent ``channels`` and spatial ``stride``."""
    if vae is not None and (vae.cfg.z_channels, vae.cfg.spatial_down) != (channels, stride):
        raise ValueError(f"the VAE's latents ({vae.cfg.z_channels} channels, stride "
                         f"{vae.cfg.spatial_down}) do not fit the model's ({channels} "
                         f"channels, stride {stride})")


def decode_pixels(vae, latents: torch.Tensor):
    """``(pixels, timings)``: an ``SDVAE``'s decode of the sampler's latents
    (``[B, h, w, C]``, or ``[B, T, h, w, C]`` frame by frame) after
    ``from_latent``, and its ``decode_s``; ``(None, {})`` without a VAE."""
    if vae is None:
        return None, {}
    t0 = synced_clock(latents)
    video = vae.decode(vae.from_latent(latents))
    return video, {"decode_s": synced_clock(video) - t0}
