"""Reference-similarity metrics: PSNR, SSIM, LPIPS (counterpart of
``magcache_tpu.eval.metrics``).

The reference compares cached-run videos against full-compute "golden" ones
frame by frame (``eval/magcache/common_metrics/calculate_{psnr,ssim,lpips}.py``):

- PSNR per frame on [0, 1] floats, ``20 log10(1 / sqrt(mse))`` (100 for
  identical frames), averaged;
- SSIM per frame and channel with an 11x11 Gaussian window (sigma 1.5),
  C1 = (0.01 * 255)^2, C2 = (0.03 * 255)^2 on the [0, 255] scale, valid
  region only (``calculate_ssim.py``'s filter2D and [5:-5] crop), averaged;
- LPIPS (``lpips.LPIPS(net='alex')``): AlexNet's five ReLU feature maps,
  unit-normalised over channels, squared differences weighted by five
  non-negative linear heads, averaged over space and summed. No weights
  ship with the repository: ``load_lpips_weights`` reads a file the user
  supplies; without one the backbone is random (seeded) and
  ``lpips_distance`` warns that the number is relative only.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["psnr", "ssim", "lpips_distance", "LPIPSModel", "load_lpips_weights"]


def psnr(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    """Per-frame PSNR averaged (frames [T, H, W, C] or a single frame)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 3:
        a, b = a[None], b[None]
    vals = []
    for fa, fb in zip(a, b):
        mse = np.mean((fa - fb) ** 2)
        vals.append(100.0 if mse < 1e-10 else 20 * np.log10(max_val / np.sqrt(mse)))
    return float(np.mean(vals))


def _gaussian_window(size=11, sigma=1.5):
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g)


def _ssim_frame(img1, img2):
    """Single-channel SSIM on the [0, 255] scale over the valid region."""
    from scipy.signal import convolve2d

    win = _gaussian_window()
    C1, C2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    mu1 = convolve2d(img1, win, mode="valid")
    mu2 = convolve2d(img2, win, mode="valid")
    mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = convolve2d(img1 * img1, win, mode="valid") - mu1_sq
    s2 = convolve2d(img2 * img2, win, mode="valid") - mu2_sq
    s12 = convolve2d(img1 * img2, win, mode="valid") - mu12
    m = ((2 * mu12 + C1) * (2 * s12 + C2)) / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return m.mean()


def ssim(a: np.ndarray, b: np.ndarray) -> float:
    """Frames [T, H, W, C] in [0, 1]; per-frame per-channel SSIM averaged."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.ndim == 3:
        a, b = a[None], b[None]
    vals = []
    for fa, fb in zip(a * 255.0, b * 255.0):
        ch = [_ssim_frame(fa[..., c], fb[..., c]) for c in range(fa.shape[-1])]
        vals.append(np.mean(ch))
    return float(np.mean(vals))


# --------------------------------------------------------------------------
# LPIPS (AlexNet backbone)
# --------------------------------------------------------------------------

_ALEX_CHANNELS = (64, 192, 384, 256, 256)
_ALEX_SPECS = [  # (kernel, stride, pad, out_ch) per conv; max pools after 1, 2
    (11, 4, 2, 64), (5, 1, 2, 192), (3, 1, 1, 384), (3, 1, 1, 256), (3, 1, 1, 256)
]
# LPIPS' scaling layer (ImageNet statistics in [-1, 1] units)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPSModel(nn.Module):
    """AlexNet features and LPIPS' linear heads. ``LPIPSModel()`` draws
    random weights from a generator seeded ``seed`` (He-style normal convs,
    zero biases, |normal| / C heads, as the JAX ``LPIPSModel.init``) on
    the CPU (``.to()`` moves it); ``pretrained`` says whether real weights
    were loaded."""

    def __init__(self, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.convs = nn.ModuleList()
        cin = 3
        for k, s, p, cout in _ALEX_SPECS:
            conv = nn.Conv2d(cin, cout, k, stride=s, padding=p)
            with torch.no_grad():
                conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                                  / np.sqrt(k * k * cin))
                conv.bias.zero_()
            self.convs.append(conv)
            cin = cout
        self.lins = nn.ParameterList(
            nn.Parameter(torch.randn(c, generator=gen).abs() / c) for c in _ALEX_CHANNELS)
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1))
        self.pretrained = False
        self.requires_grad_(False)

    @staticmethod
    def from_torch_state_dict(sd) -> "LPIPSModel":
        """An ``lpips.LPIPS(net='alex')`` state dict (tensors or arrays):
        ``net.slice{1..5}.<idx>.{weight,bias}`` (the AlexNet convs, OIHW) and
        ``lin{0..4}.model.1.weight`` (``[1, C, 1, 1]`` heads)."""
        model = LPIPSModel()
        conv_keys = sorted((k for k in sd if k.endswith(".weight") and "net." in k),
                           key=lambda k: (int(k.split("slice")[1].split(".")[0]),
                                          int(k.split(".")[2])))
        if len(conv_keys) != len(_ALEX_SPECS):
            raise ValueError(f"expected {len(_ALEX_SPECS)} AlexNet convs, got "
                             f"{len(conv_keys)}: {conv_keys}")
        with torch.no_grad():
            for conv, k in zip(model.convs, conv_keys):
                conv.weight.copy_(torch.as_tensor(np.asarray(sd[k], np.float32)))
                conv.bias.copy_(torch.as_tensor(
                    np.asarray(sd[k[:-len("weight")] + "bias"], np.float32)))
            for i, lin in enumerate(model.lins):
                lin.copy_(torch.as_tensor(
                    np.asarray(sd[f"lin{i}.model.1.weight"], np.float32).reshape(-1)))
        model.pretrained = True
        return model

    def features(self, x: torch.Tensor) -> list:
        """x: ``[B, H, W, 3]`` in [-1, 1] -> the five ReLU maps, NCHW."""
        h = (x.permute(0, 3, 1, 2) - self.shift) / self.scale
        feats = []
        for i, conv in enumerate(self.convs):
            h = F.relu(conv(h))
            feats.append(h)
            if i in (0, 1):
                h = F.max_pool2d(h, 3, 2)
        return feats

    def distance(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Per-image LPIPS distance ``[B]``; a, b ``[B, H, W, 3]`` in [-1, 1]."""
        total = 0.0
        for f1, f2, lin in zip(self.features(a), self.features(b), self.lins):
            n1 = f1 / f1.norm(dim=1, keepdim=True).clamp_min(1e-10)
            n2 = f2 / f2.norm(dim=1, keepdim=True).clamp_min(1e-10)
            d = ((n1 - n2) ** 2 * lin.view(1, -1, 1, 1)).sum(1)
            total = total + d.mean((1, 2))
        return total


_DEFAULT_LPIPS: Optional[LPIPSModel] = None


def load_lpips_weights(path: str, device=None) -> LPIPSModel:
    """Install the LPIPS weights in ``path`` (an ``lpips.LPIPS(net='alex')``
    checkpoint: ``.pt`` / ``.pth`` via ``torch.load``, or ``.safetensors``)
    as the process default, on ``device`` if given, and return the model."""
    global _DEFAULT_LPIPS
    if path.endswith(".safetensors"):
        from magcache_tpu_torch.models.checkpoint import read_safetensors

        sd = read_safetensors(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    _DEFAULT_LPIPS = LPIPSModel.from_torch_state_dict(sd)
    if device is not None:
        _DEFAULT_LPIPS.to(device)
    return _DEFAULT_LPIPS


def lpips_distance(a: np.ndarray, b: np.ndarray,
                   model: Optional[LPIPSModel] = None,
                   allow_random_backbone: bool = False, device=None) -> float:
    """Frames ``[T, H, W, 3]`` in [0, 1]; mean LPIPS over frames, on
    ``device`` (the model moves there) or where the model lies. Without
    loaded weights the backbone is random: the value is a relative signal
    only, and a ``UserWarning`` says so unless ``allow_random_backbone``."""
    global _DEFAULT_LPIPS
    if model is None:
        if _DEFAULT_LPIPS is None:
            _DEFAULT_LPIPS = LPIPSModel()
        model = _DEFAULT_LPIPS
    if not model.pretrained and not allow_random_backbone:
        warnings.warn(
            "lpips_distance: RANDOM AlexNet backbone (no pretrained weights "
            "loaded); the value is relative only and must not be reported as "
            "LPIPS. Call eval.metrics.load_lpips_weights(path) first, or pass "
            "allow_random_backbone=True to acknowledge.", UserWarning, stacklevel=2)
    if device is not None:
        model.to(device)
    dev = model.shift.device
    ta = torch.as_tensor(np.asarray(a, np.float32) * 2.0 - 1.0, device=dev)
    tb = torch.as_tensor(np.asarray(b, np.float32) * 2.0 - 1.0, device=dev)
    if ta.ndim == 3:
        ta, tb = ta[None], tb[None]
    with torch.inference_mode():
        return float(model.distance(ta, tb).mean())
