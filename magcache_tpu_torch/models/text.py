"""Text encoders, prompts to states: the T5-family encoder (T5, mT5, UMT5),
the CLIP text tower, the SD3 triple stack, the Llama encoder of
HunyuanVideo and FramePack (and of Qwen-Image with the Qwen template), the
Qwen2.5-VL stack of Qwen-Image-Edit, the mock encoders, and the hash
tokenizer that brings prompts to them without a tokenizer file.

The counterparts of ``magcache_tpu.models.text``'s ``JaxT5Encoder`` /
``make_t5_encoder``, ``ClipTextEncoder``, ``Sd3TextStack``,
``LlamaTextEncoder`` and ``QwenVLTextEncoder``, the mocks and
``FallbackHashTokenizer``. Each encoder runs on the card unless ``device``
says otherwise, with random weights from a seeded generator, a given model,
or a checkpoint path in place of its config (an HF directory with
``config.json``; T5-family files as ``models.t5.load_t5_encoder`` routes
them), read as the JAX encoders read them but always tokenized by the hash
tokenizer (no tokenizer files are read); its ``__call__(prompts, device=)``
fills a pipeline's ``text_encoder`` or ``pooled_encoder`` slot.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from magcache_tpu_torch.models.clip import (CLIPTextConfig, CLIPTextModel, clip_text_forward,
                                            load_clip_text)
from magcache_tpu_torch.models.llama import (QWEN25_VL_MROPE_SECTION, LlamaConfig, LlamaModel,
                                             llama_config_from_json, llama_hidden_states,
                                             load_llama)
from magcache_tpu_torch.models.qwen_vl import (QwenVLVisionConfig, QwenVLVisionTower,
                                               mrope_position_ids, preprocess_qwen_vl_image)
from magcache_tpu_torch.models.t5 import T5Config, T5Model, load_t5_encoder, t5_encode

# hyvideo's llava-llama prompt template for video description
# (hyvideo/constants.py PROMPT_TEMPLATE_ENCODE_VIDEO); the first
# HYVIDEO_CROP_START tokens, the template's prefix, are cropped from the
# states before they reach the DiT
HYVIDEO_PROMPT_TEMPLATE = (
    "<|start_header_id|>system<|end_header_id|>\n\nDescribe the video by "
    "detailing the following aspects: 1. The main content and theme of the "
    "video.2. The color, shape, size, texture, quantity, text, and spatial "
    "relationships of the objects.3. Actions, events, behaviors temporal "
    "relationships, physical movement changes of the objects.4. background "
    "environment, light, style and atmosphere.5. camera angles, movements, "
    "and transitions used in the video.<|eot_id|>"
    "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>")
HYVIDEO_CROP_START = 95

# Qwen-Image's template (diffusers QwenImagePipeline): the encoder drops the
# first QWEN_IMAGE_CROP_START template tokens and takes the final-normed last
# hidden state. The Edit template carries the reference image through the
# vision tower (``QwenVLTextEncoder``) and drops 64.
QWEN_IMAGE_PROMPT_TEMPLATE = (
    "<|im_start|>system\nDescribe the image by detailing the color, shape, "
    "size, texture, quantity, text, spatial relationships of the objects "
    "and background:<|im_end|>\n<|im_start|>user\n{}<|im_end|>\n"
    "<|im_start|>assistant\n")
QWEN_IMAGE_CROP_START = 34
QWEN_IMAGE_EDIT_PROMPT_TEMPLATE = (
    "<|im_start|>system\nDescribe the key features of the input image "
    "(color, shape, size, texture, objects, background), then explain how "
    "the user's text instruction should alter or modify the image. Generate "
    "a new image that meets the user's requirements while maintaining "
    "consistency with the original input where appropriate.<|im_end|>\n"
    "<|im_start|>user\n<|vision_start|><|image_pad|><|vision_end|>"
    "{}<|im_end|>\n<|im_start|>assistant\n")
QWEN_IMAGE_EDIT_CROP_START = 64
IMAGE_PAD = "<|image_pad|>"


@dataclasses.dataclass(frozen=True)
class MockTextEncoder:
    """Deterministic stand-in: ``seq_len x dim`` gaussian embeddings seeded by
    the prompt's sha256, drawn with numpy so they equal the JAX package's
    ``MockTextEncoder`` bit for bit."""

    seq_len: int
    dim: int
    scale: float = 1.0

    def __call__(self, prompts: Sequence[str],
                 device: Optional[torch.device] = None) -> torch.Tensor:
        outs = []
        for p in prompts:
            seed = int.from_bytes(hashlib.sha256(p.encode()).digest()[:4], "little")
            rng = np.random.default_rng(seed)
            outs.append(rng.normal(0, self.scale, (self.seq_len, self.dim)))
        return torch.from_numpy(np.stack(outs).astype(np.float32)).to(device)


@dataclasses.dataclass(frozen=True)
class MockPooledEncoder:
    """CLIP-pooled stand-in: one ``dim`` gaussian vector per prompt, seeded
    by bytes 4..8 of the prompt's sha256 (``MockTextEncoder`` takes bytes
    0..4), equal to the JAX package's ``MockPooledEncoder`` bit for bit."""

    dim: int

    def __call__(self, prompts: Sequence[str],
                 device: Optional[torch.device] = None) -> torch.Tensor:
        outs = []
        for p in prompts:
            seed = int.from_bytes(hashlib.sha256(p.encode()).digest()[4:8], "little")
            outs.append(np.random.default_rng(seed).normal(0, 1.0, (self.dim,)))
        return torch.from_numpy(np.stack(outs).astype(np.float32)).to(device)


class FallbackHashTokenizer:
    """Stand-in for missing tokenizer files (``magcache_tpu.models.text.
    FallbackHashTokenizer``, the same ids bit for bit): each whitespace word
    hashes into ``[2, vocab_size)`` stepping over eos/pad, then eos, then pad
    up to ``max_length``. Deterministic, not a real tokenization; only for
    structural runs. Construction prints a warning for that reason."""

    def __init__(self, vocab_size: int, eos_token_id: int = 1, pad_token_id: int = 0):
        self.vocab_size, self.eos, self.pad = vocab_size, eos_token_id, pad_token_id
        print("WARNING: no tokenizer files found — falling back to a "
              "hash tokenizer (structural runs only; outputs are NOT "
              "prompt-faithful).")

    def __call__(self, texts, padding=None, truncation=None, max_length=77,
                 return_tensors=None) -> dict:
        """``{"input_ids": int64 [B, max_length], "attention_mask": int64
        [B, max_length]}`` as numpy arrays (``padding``, ``truncation`` and
        ``return_tensors`` are accepted for a tokenizer's call signature)."""
        # ids stay in the table even when eos is the last vocab id
        span = self.vocab_size - 2
        if span < 3:
            raise ValueError(f"vocab_size {self.vocab_size} too small")

        def wid(w):
            v = 2 + (int.from_bytes(hashlib.sha256(w.encode()).digest()[:4], "little")
                     % span)
            while v in (self.eos, self.pad):
                v = 2 + ((v - 1) % span)
            return v

        ids = np.full((len(texts), max_length), self.pad, np.int64)
        for i, t in enumerate(texts):
            toks = [wid(w) for w in t.split()][: max_length - 1]
            ids[i, :len(toks)] = toks
            ids[i, len(toks)] = self.eos
        return {"input_ids": ids, "attention_mask": (ids != self.pad).astype(np.int64)}


def _as_tensor(a) -> torch.Tensor:
    return a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))


def _tokens(tokenizer, prompts: Sequence[str], seq_len: int, name: str):
    """``(input_ids, attention_mask)`` of ``prompts`` padded to ``seq_len``."""
    if tokenizer is None:
        raise ValueError(f"{name}: raw prompts need a tokenizer; pass ids to encode_ids")
    tok = tokenizer(list(prompts), padding="max_length", truncation=True,
                    max_length=seq_len, return_tensors="np")
    return tok["input_ids"], tok["attention_mask"]


def _checkpoint(path: str):
    """``(state dict, config.json)`` of an HF checkpoint directory."""
    from magcache_tpu_torch.models.checkpoint import load_safetensors_dir

    with open(os.path.join(path, "config.json")) as f:
        return load_safetensors_dir(path), json.load(f)


def _load_qwen_vl(path: str, device, mrope_section, image_token_id):
    """A Qwen2.5-VL checkpoint as the JAX ``QwenVLTextEncoder`` reads it:
    ``(LM config, LM, vision tower, mrope_section, image_token_id)``."""
    from magcache_tpu_torch.models.convert import qwen_vl_vision_params_from_numpy
    from magcache_tpu_torch.models.qwen_vl import convert_qwen_vl_vision_state_dict

    sd, hf = _checkpoint(path)
    txt, vis = hf.get("text_config", hf), hf.get("vision_config", {})
    rs = txt.get("rope_scaling") or {}
    lm, visual = {}, {}
    for k, v in sd.items():
        k = k[len("model."):] if k.startswith("model.") else k
        if k.startswith("visual."):
            visual[k[len("visual."):]] = v
        else:
            lm[k[len("language_model."):] if k.startswith("language_model.") else k] = v
    cfg = llama_config_from_json(txt, qkv_bias=True, rope_theta=1e6, eps=1e-6)
    vcfg = QwenVLVisionConfig(
        depth=vis.get("depth", 32), hidden=vis.get("hidden_size", 1280),
        heads=vis.get("num_heads", 16), intermediate=vis.get("intermediate_size", 3420),
        out_hidden=vis.get("out_hidden_size", txt["hidden_size"]),
        patch_size=vis.get("patch_size", 14),
        temporal_patch_size=vis.get("temporal_patch_size", 2),
        merge_size=vis.get("spatial_merge_size", 2), window_size=vis.get("window_size", 112),
        fullatt_indexes=tuple(vis.get("fullatt_block_indexes", (7, 15, 23, 31))))
    tower = QwenVLVisionTower(vcfg, torch.device(device))
    tower.load_state_dict(qwen_vl_vision_params_from_numpy(
        convert_qwen_vl_vision_state_dict(visual, vcfg), vcfg, device))
    return (cfg, load_llama(lm, cfg, device), tower,
            tuple(rs.get("mrope_section", mrope_section)),
            hf.get("image_token_id", image_token_id))


def _seeded(device, generator: Optional[torch.Generator]) -> torch.Generator:
    return generator or torch.Generator(device=torch.device(device)).manual_seed(0)


class T5Encoder:
    """Prompts -> ``[B, seq_len, d_model]`` through a T5-family encoder
    (``models.t5``: T5, mT5 or UMT5, as ``cfg`` says): the encoder on
    ``device`` with random weights from ``generator`` (default: seed 0 on
    ``device``), or the given ``model``. ``tokenizer`` (e.g.
    ``FallbackHashTokenizer``) turns prompts into ids for ``__call__``;
    ``encode_ids`` takes ids. Padded rows of the output are zero. A
    checkpoint path in place of ``cfg`` loads it (``models.t5.
    load_t5_encoder``, f32), with the hash tokenizer unless one is given."""

    def __init__(self, cfg: T5Config, seq_len: int = 512, tokenizer=None,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 model: Optional[T5Model] = None):
        if isinstance(cfg, str):
            cfg, model = load_t5_encoder(cfg, device=device)
            if tokenizer is None:
                tokenizer = FallbackHashTokenizer(cfg.vocab_size, eos_token_id=1,
                                                  pad_token_id=0)
        self.cfg = cfg
        self.seq_len = seq_len
        self.tokenizer = tokenizer
        if model is None:
            model = T5Model(cfg, torch.device(device)).init(_seeded(device, generator))
        self.model = model.requires_grad_(False).eval()

    def encode_ids(self, input_ids, attention_mask=None) -> torch.Tensor:
        """Ids ``[B, L]`` (numpy or tensor) -> ``[B, L, d_model]``."""
        mask = None if attention_mask is None else _as_tensor(attention_mask)
        return t5_encode(self.model, _as_tensor(input_ids), mask)

    def __call__(self, prompts: Sequence[str], device=None) -> torch.Tensor:
        """Tokenize ``prompts`` to ``seq_len`` and encode them; the result on
        ``device`` (default: the encoder's)."""
        out = self.encode_ids(*_tokens(self.tokenizer, prompts, self.seq_len,
                                       type(self).__name__))
        return out if device is None else out.to(device)


def make_t5_encoder(cfg: T5Config, seq_len: int = 512, tokenizer=None, device="cuda",
                    generator: Optional[torch.Generator] = None,
                    model: Optional[T5Model] = None) -> T5Encoder:
    """The T5-family encoder of a config or a checkpoint path
    (``magcache_tpu.models.text.make_t5_encoder``): a UMT5 config
    (``per_layer_bias``) gives every layer its own relative bias, a T5 or
    mT5 config block 0's shared one; a path is routed and loaded by
    ``models.t5.load_t5_encoder``."""
    return T5Encoder(cfg, seq_len=seq_len, tokenizer=tokenizer, device=device,
                     generator=generator, model=model)


class ClipTextEncoder:
    """Prompts -> the CLIP text tower's pooled vector ``f32[B, d or
    projection_dim]`` (or with ``states`` its token states ``f32[B, seq_len,
    d]``): FLUX's pooled encoder and the SD3 stack's towers. The tower is on
    ``device`` with random weights from ``generator`` (default: seed 0 on
    ``device``), or the given ``model``; ``hidden_skip`` and ``project`` are
    ``clip_text_forward``'s.

    Without ``tokenizer`` it builds the hash tokenizer with the vocabulary's
    EOS. A legacy config (``eos_token_id`` 2) gets ``vocab_size - 1`` (49,407
    for CLIP), the largest id, as the real tokenizer writes it: its pooling
    takes ``argmax(ids)``. The JAX wrapper writes id 2 there and pools at the
    largest hashed word instead."""

    def __init__(self, cfg: CLIPTextConfig, seq_len: Optional[int] = None, tokenizer=None,
                 states: bool = False, hidden_skip: int = 0, project: bool = False,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 model: Optional[CLIPTextModel] = None):
        if isinstance(cfg, str):
            cfg, model = load_clip_text(cfg, device)
        self.cfg = cfg
        self.seq_len = seq_len or cfg.max_len
        if tokenizer is None:
            eos = cfg.vocab_size - 1 if cfg.legacy_eos else cfg.eos_token_id
            tokenizer = FallbackHashTokenizer(cfg.vocab_size, eos_token_id=eos)
        self.tokenizer = tokenizer
        self.states, self.hidden_skip, self.project = states, hidden_skip, project
        if model is None:
            model = CLIPTextModel(cfg, torch.device(device)).init(_seeded(device, generator))
        if project and model.text_proj is None:
            raise ValueError("project=True (the SD3 text_embeds recipe) needs a model with "
                             "text_proj; this one has none")
        self.model = model.requires_grad_(False).eval()

    def encode_ids(self, input_ids, attention_mask=None):
        """Ids ``[B, S]`` -> ``(hidden, pooled)`` of ``clip_text_forward``."""
        mask = None if attention_mask is None else _as_tensor(attention_mask)
        return clip_text_forward(self.model, _as_tensor(input_ids), mask,
                                 hidden_skip=self.hidden_skip, project=self.project)

    def __call__(self, prompts: Sequence[str], device=None) -> torch.Tensor:
        h, pooled = self.encode_ids(*_tokens(self.tokenizer, prompts, self.seq_len,
                                             type(self).__name__))
        out = h if self.states else pooled
        return out if device is None else out.to(device)


class Sd3TextStack:
    """The SD3 triple encoder Vchitect conditions on (CLIP-L + CLIP-bigG with
    projection, T5-XXL; ``magcache_tpu.models.text.Sd3TextStack``)::

        context = concat_seq(pad_dim(concat_dim(clip_l.h, clip_g.h), t5_dim), t5)
        pooled  = concat_dim(clip_l.pooled, clip_g.pooled)

    with each CLIP's ``hidden_skip`` states (the SD3 recipe: 1, the
    penultimate block's). ``.context`` and ``.pooled`` fill a pipeline's
    ``(text_encoder, pooled_encoder)`` slots; a one-entry memo encodes each
    prompt batch once. Both are f32."""

    def __init__(self, clip_l: ClipTextEncoder, clip_g: ClipTextEncoder, t5,
                 t5_dim: Optional[int] = None):
        self.clip_l, self.clip_g, self.t5 = clip_l, clip_g, t5
        self.t5_dim = t5_dim
        self._memo: tuple = (None, None)

    def _encode(self, prompts: Sequence[str]):
        key = tuple(prompts)
        if self._memo[0] == key:
            return self._memo[1]
        t5_h = self.t5(list(prompts))
        t5_dim = self.t5_dim or t5_h.shape[-1]
        if self.clip_l.seq_len != self.clip_g.seq_len:
            raise ValueError(
                f"SD3 stack concatenates the two CLIP towers' states on the channel "
                f"axis, so their sequence lengths must match: clip_l="
                f"{self.clip_l.seq_len} clip_g={self.clip_g.seq_len}")
        parts, pooled = [], []
        for enc in (self.clip_l, self.clip_g):
            h, p = enc.encode_ids(*_tokens(enc.tokenizer, prompts, enc.seq_len,
                                           "Sd3TextStack"))
            parts.append(h.to(t5_h.device))
            pooled.append(p.to(t5_h.device))
        clip_h = torch.cat(parts, dim=-1)
        if clip_h.shape[-1] > t5_dim:
            raise ValueError(f"the CLIP states' {clip_h.shape[-1]} channels do not fit "
                             f"t5_dim {t5_dim}")
        clip_h = F.pad(clip_h, (0, t5_dim - clip_h.shape[-1]))
        out = (torch.cat([clip_h, t5_h.float()], dim=1), torch.cat(pooled, dim=-1))
        self._memo = (key, out)
        return out

    def context(self, prompts: Sequence[str], device=None) -> torch.Tensor:
        out = self._encode(prompts)[0]
        return out if device is None else out.to(device)

    def pooled(self, prompts: Sequence[str], device=None) -> torch.Tensor:
        out = self._encode(prompts)[1]
        return out if device is None else out.to(device)


class LlamaTextEncoder:
    """Prompts -> ``f32[B, out_len, hidden]`` through a Llama-architecture LM
    (hyvideo's llava-llama stack, the JAX ``LlamaTextEncoder`` built from a
    config): each prompt rides ``template``, is tokenized to ``out_len +
    crop_start`` tokens, the hidden state after ``layers - skip_layers``
    blocks is taken (final-normed when ``final_norm``, by default when
    ``skip_layers == 0``), padded positions are zeroed and the first
    ``crop_start`` (template-prefix) tokens dropped. The LM is on ``device``
    with random weights from ``generator`` (default: seed 0 on ``device``),
    or the given ``model``; without ``tokenizer`` it builds the hash
    tokenizer over the vocabulary."""

    def __init__(self, cfg: LlamaConfig, out_len: int = 256, skip_layers: int = 2,
                 template: Optional[str] = HYVIDEO_PROMPT_TEMPLATE,
                 crop_start: int = HYVIDEO_CROP_START, final_norm: Optional[bool] = None,
                 tokenizer=None, device="cuda", generator: Optional[torch.Generator] = None,
                 model: Optional[LlamaModel] = None):
        if isinstance(cfg, str):
            sd, hf = _checkpoint(cfg)
            cfg = llama_config_from_json(hf.get("text_config", hf))
            model = load_llama(sd, cfg, device)
        self.cfg = cfg
        self.out_len, self.skip_layers = out_len, skip_layers
        self.template = template
        self.crop_start = crop_start if template else 0
        self.final_norm = skip_layers == 0 if final_norm is None else final_norm
        self.tokenizer = tokenizer or FallbackHashTokenizer(cfg.vocab_size)
        if model is None:
            model = LlamaModel(cfg, torch.device(device)).init(_seeded(device, generator))
        self.model = model.requires_grad_(False).eval()

    def encode_ids(self, input_ids, attention_mask=None) -> torch.Tensor:
        """Ids ``[B, S]`` -> the taken hidden states ``f32[B, S, hidden]``
        (no template, crop or zeroing)."""
        mask = None if attention_mask is None else _as_tensor(attention_mask)
        return llama_hidden_states(self.model, _as_tensor(input_ids), mask,
                                   skip_layers=self.skip_layers, final_norm=self.final_norm)

    def __call__(self, prompts: Sequence[str], device=None) -> torch.Tensor:
        texts = ([self.template.format(p) for p in prompts] if self.template
                 else list(prompts))
        ids, mask = _tokens(self.tokenizer, texts, self.out_len + self.crop_start,
                            type(self).__name__)
        h = _crop_states(self.encode_ids(ids, mask), mask, self.crop_start, self.out_len)
        return h if device is None else h.to(device)


def _crop_states(h: torch.Tensor, mask, crop: int, out_len: int) -> torch.Tensor:
    """Padded positions zeroed, the first ``crop`` tokens dropped, the rest
    cut or zero-padded to ``out_len``."""
    h = (h * _as_tensor(mask).to(h)[..., None])[:, crop:crop + out_len]
    return F.pad(h, (0, 0, 0, out_len - h.shape[1]))


class QwenVLTextEncoder:
    """Qwen-Image-Edit's conditioning stack (the JAX ``QwenVLTextEncoder``
    built from a config; diffusers ``QwenImageEditPipeline``): with an image
    set (``set_image``) it is preprocessed on the host and run through the
    vision tower; the Edit template's ``<|image_pad|>`` is expanded to one
    pad per merged vision token before the prompt is substituted; the
    tokens are spliced over the pads' embeddings and the LM runs with 3-axis
    M-RoPE ids, final-normed; padding is zeroed, the first 64 tokens
    cropped and the rest padded to ``out_len``. Without an image it is the
    text-only Qwen-Image recipe (template ``QWEN_IMAGE_PROMPT_TEMPLATE``,
    crop 34, 1-D RoPE). Outputs ``f32[B, out_len, hidden]``.

    The LM and the tower are on ``device`` with random weights from
    ``generator`` (default: seed 0 on ``device``), or the given ``model``
    and ``vision_model``; ``vision_cfg`` defaults to the JAX default, the
    tiny tower projecting to the LM's width. Without ``tokenizer`` it builds
    the hash tokenizer, whose whitespace words never are ``image_token_id``:
    an image then raises ``ValueError``, where the JAX encoder drops the
    vision tokens without a word. So does a tokenizer that writes more pads
    than vision tokens, or fewer than fit in ``out_len``."""

    def __init__(self, cfg: LlamaConfig, out_len: int = 256, tokenizer=None,
                 vision_cfg: Optional[QwenVLVisionConfig] = None,
                 mrope_section=QWEN25_VL_MROPE_SECTION, image_token_id: int = 151655,
                 min_pixels: int = 56 * 56, max_pixels: int = 14 * 14 * 4 * 1280,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 model: Optional[LlamaModel] = None,
                 vision_model: Optional[QwenVLVisionTower] = None):
        if isinstance(cfg, str):
            cfg, model, vision_model, mrope_section, image_token_id = _load_qwen_vl(
                cfg, device, mrope_section, image_token_id)
        self.cfg = cfg
        self.out_len = out_len
        self.tokenizer = tokenizer or FallbackHashTokenizer(cfg.vocab_size)
        self.mrope_section = tuple(mrope_section)
        self.image_token_id = image_token_id
        self.min_pixels, self.max_pixels = min_pixels, max_pixels
        if model is None or vision_model is None:
            gen = _seeded(device, generator)
        if model is None:
            model = LlamaModel(cfg, torch.device(device)).init(gen)
        if vision_model is None:
            vcfg = vision_cfg or QwenVLVisionConfig.tiny(out_hidden=cfg.hidden)
            vision_model = QwenVLVisionTower(vcfg, torch.device(device)).init(gen)
        self.model = model.requires_grad_(False).eval()
        self.vision_model = vision_model.requires_grad_(False).eval()
        self.vision_cfg = self.vision_model.cfg
        self._image = None

    def set_image(self, image) -> "QwenVLTextEncoder":
        """Attach the Edit reference image (HWC uint8 or float RGB, numpy)
        for the following calls; ``None`` reverts to text-only encoding."""
        self._image = image
        return self

    def __call__(self, prompts: Sequence[str], device=None) -> torch.Tensor:
        if self._image is None:
            texts = [QWEN_IMAGE_PROMPT_TEMPLATE.format(p) for p in prompts]
            crop = QWEN_IMAGE_CROP_START
            ids, mask = _tokens(self.tokenizer, texts, self.out_len + crop,
                                type(self).__name__)
            h = llama_hidden_states(self.model, _as_tensor(ids), _as_tensor(mask),
                                    final_norm=True)
        else:
            crop = QWEN_IMAGE_EDIT_CROP_START
            h, mask = self._encode_with_image(prompts, crop)
        h = _crop_states(h, mask, crop, self.out_len)
        return h if device is None else h.to(device)

    def _encode_with_image(self, prompts: Sequence[str], crop: int):
        vcfg = self.vision_cfg
        patches, grid = preprocess_qwen_vl_image(np.asarray(self._image), vcfg,
                                                 min_pixels=self.min_pixels,
                                                 max_pixels=self.max_pixels)
        embeds = self.vision_model(patches, (grid,))
        n_merged = embeds.shape[0]
        # the placeholder is expanded in the template before the prompt goes
        # in: a literal pad token inside a prompt is no splice position
        template = QWEN_IMAGE_EDIT_PROMPT_TEMPLATE.replace(IMAGE_PAD, IMAGE_PAD * n_merged)
        ids, mask = _tokens(self.tokenizer, [template.format(p) for p in prompts],
                            self.out_len + crop, type(self).__name__)
        ids, mask = np.asarray(ids), np.asarray(mask)
        ov_mask = ids == self.image_token_id
        n_pads = int(ov_mask[0].sum())
        if n_pads == 0:
            raise ValueError(
                f"the tokenizer wrote no image token (id {self.image_token_id}) for the "
                f"{n_merged} vision embeddings: it does not know {IMAGE_PAD} (the hash "
                f"tokenizer does not), and the image would be dropped")
        if n_pads > n_merged:
            raise ValueError(f"prompt contains the reserved {IMAGE_PAD} token ({n_pads} "
                             f"image positions for {n_merged} vision embeddings)")
        if n_pads < n_merged:
            raise ValueError(f"image occupies {n_merged} tokens but only {n_pads} fit in "
                             f"txt_len={self.out_len}; raise txt_len or lower max_pixels")
        dev = self.model.embed.device
        ov = torch.zeros(ids.shape + (self.cfg.hidden,), dtype=torch.float32, device=dev)
        for b in range(ids.shape[0]):
            rows = torch.from_numpy(np.flatnonzero(ov_mask[b])).to(dev)
            ov[b, rows] = embeds[:len(rows)].to(dev)
        pos = mrope_position_ids(ids, (grid,) * ids.shape[0], vcfg.merge_size,
                                 self.image_token_id, mask)
        h = llama_hidden_states(self.model, torch.from_numpy(ids), torch.from_numpy(mask),
                                final_norm=True, embeds_override=ov,
                                override_mask=torch.from_numpy(ov_mask), position_ids=pos,
                                mrope_section=self.mrope_section)
        return h, mask
