"""LoRA adapters merged into published checkpoints (the counterpart of
``magcache_tpu.models.lora``).

The reference takes LoRA on two surfaces: OmniGen2's
``--transformer_lora_path`` (``MagCache4OmniGen2/inference.py:36,204-206``)
and the FLUX forward's PEFT ``lora_scale`` (``magcache_flux.py:62-75``). The
port folds ``scale * (alpha / r) * B @ A`` into the base weights once, in
f32, before conversion, so every forward is one dense matmul a layer.

Key conventions:
  - PEFT: ``{base}.lora_A.weight [r, in]``, ``{base}.lora_B.weight
    [out, r]``, an optional ``{base}.alpha`` (the delta scaled by alpha / r);
  - kohya: ``{base}.lora_down.weight`` / ``{base}.lora_up.weight``.
A leading ``transformer.``, ``diffusion_model.`` or ``model.`` is stripped,
so adapters exported against a pipeline match the transformer's own keys.
Keys name the published (pre-conversion) weights.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch

from magcache_tpu_torch.models.checkpoint import read_safetensors

_PREFIXES = ("transformer.", "diffusion_model.", "model.")
_DOWN_TAGS = (".lora_A.weight", ".lora_down.weight")
_UP_TAGS = (".lora_B.weight", ".lora_up.weight")


def load_lora_file(path: str) -> Dict[str, torch.Tensor]:
    """An adapter file (``.safetensors``, torch ``.pt`` / ``.bin``, or a
    directory holding one) as a flat dict of tensors."""
    if os.path.isdir(path):
        cands = [f for f in sorted(os.listdir(path))
                 if f.endswith((".safetensors", ".pt", ".bin"))]
        if not cands:
            raise FileNotFoundError(f"no adapter weights found under {path}")
        path = os.path.join(path, cands[0])
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    return {k: v if torch.is_tensor(v) else torch.as_tensor(v) for k, v in sd.items()}


def _strip(key: str) -> str:
    for p in _PREFIXES:
        if key.startswith(p):
            return key[len(p):]
    return key


def merge_lora_state_dict(sd: Dict[str, torch.Tensor], lora_sd: Dict[str, torch.Tensor],
                          scale: float = 1.0, strict: bool = True, device=None
                          ) -> Tuple[Dict[str, torch.Tensor], int]:
    """``(merged copy of sd, layers merged)``: each targeted ``{base}.weight``
    becomes ``w + scale * (alpha / r) * (B @ A)`` computed in f32 on
    ``device`` (default: the weight's) and rounded to the weight's dtype.
    A target absent from ``sd`` raises ``KeyError`` under ``strict``, else
    is skipped; an up-projection missing or a shape that does not match
    raises."""
    lora = {_strip(k): v for k, v in lora_sd.items()}
    downs = {k[: -len(tag)]: k for k in lora for tag in _DOWN_TAGS if k.endswith(tag)}
    if not downs:
        raise ValueError("no lora_A / lora_down keys found in the adapter")
    merged = dict(sd)
    missing, n = [], 0
    for base, dk in sorted(downs.items()):
        uk = next((base + tag for tag in _UP_TAGS if base + tag in lora), None)
        if uk is None:
            raise KeyError(f"lora up-projection missing for {base}")
        wk = base + ".weight"
        if wk not in merged:
            missing.append(wk)
            continue
        w = merged[wk]
        dev = w.device if device is None else torch.device(device)
        down = lora[dk].to(dev, torch.float32)               # [r, in]
        up = lora[uk].to(dev, torch.float32)                 # [out, r]
        if tuple(w.shape) != (up.shape[0], down.shape[1]):
            raise ValueError(f"lora shapes {tuple(up.shape)} x {tuple(down.shape)} do not "
                             f"match base {wk} {tuple(w.shape)}")
        alpha = lora.get(base + ".alpha")
        eff = scale * (float(alpha) / down.shape[0] if alpha is not None else 1.0)
        merged[wk] = (w.to(dev, torch.float32) + eff * (up @ down)).to(w.dtype)
        n += 1
    if missing and strict:
        raise KeyError(f"LoRA adapter targets {len(missing)} keys absent from the "
                       f"checkpoint (first: {missing[:3]}); pass strict=False to skip")
    return merged, n
