"""Open-Sora conditioning helpers (host-side), the subset of
``magcache_tpu.pipelines.open_sora_cond`` that the port runs: resolution
buckets and frame counts, prompt score appending, the T5 caption cleaning,
the prompt JSON/loop plumbing, and the mask strategy (parsing, reference
pasting, looped-extension bookkeeping), all numpy and bit-identical to it.

Behavioral sources are those of the JAX module
(``videosys/pipelines/open_sora/pipeline_open_sora.py:298-424, 532-605,
705-797`` and ``data_process.py:474-530``). The trained bucket tables are
shared data, read by path from ``magcache_tpu/data/opensora_buckets.json``.
``read_from_path`` reads image and video references as normalized frames
for the Open-Sora VAE to encode; PIL and imageio are imported inside it, so
the rest of the module needs neither.
"""

from __future__ import annotations

import html
import json
import os
import re
import urllib.parse as ul
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np

from magcache_tpu_torch.data import DATA_DIR

__all__ = ["IMG_FPS", "get_image_size", "get_num_frames", "get_latent_t",
           "clean_caption", "text_preprocessing", "append_score_to_prompts",
           "extract_json_from_prompts", "split_prompt", "merge_prompt",
           "extract_prompts_loop", "MASK_DEFAULT", "parse_mask_strategy",
           "find_nearest_point", "apply_mask_strategy", "append_generated",
           "VID_EXTENSIONS", "resize_crop_to_fill", "read_from_path"]

IMG_FPS = 120          # data_process.py:25: single-frame clips condition on this


@lru_cache(maxsize=1)
def _buckets() -> dict:
    with open(os.path.join(DATA_DIR, "opensora_buckets.json")) as f:
        return json.load(f)


def get_image_size(resolution: str, aspect_ratio: str) -> Tuple[int, int]:
    """(height, width) from the training bucket tables
    (``data_process.py:474-479``)."""
    b = _buckets()
    ar_key = b["aspect_ratio_map"][aspect_ratio]
    table = b["buckets"][resolution]
    if ar_key not in table:
        raise ValueError(f"Aspect ratio {aspect_ratio} not found for "
                         f"resolution {resolution}")
    h, w = table[ar_key]
    return int(h), int(w)


def get_num_frames(num_frames) -> int:
    """Named frame counts ('2s', '4x', ...) or a plain int
    (``data_process.py:495-530``)."""
    m = _buckets()["num_frames_map"]
    if isinstance(num_frames, str) and num_frames in m:
        return int(m[num_frames])
    return int(num_frames)


def get_latent_t(num_frames: int, micro: int = 17, down: int = 4) -> int:
    """Latent frame count of the Open-Sora composite VAE
    (``autoencoder_kl_open_sora.py:706-717`` OpenSoraVAE_V1_2.get_latent_size):
    pixels compress per ``micro_frame_size`` chunk with ceil(chunk/4) time
    downsampling — 51 frames -> 3x5 = 15 latents, NOT 51//4."""
    full, rem = divmod(int(num_frames), micro)
    n = full * -(-micro // down)
    if rem:
        n += -(-rem // down)
    return max(1, n)



# reference image and video reading (data_process.py:742-779)

VID_EXTENSIONS = (".mp4", ".avi", ".mov", ".mkv", ".gif", ".webm")


def resize_crop_to_fill(pil_image, image_size: Tuple[int, int]) -> np.ndarray:
    """Scale a PIL image to cover the ``(th, tw)`` target, bicubic, and crop
    the long axis at its centre (``data_process.py:742-758``, the pipeline's
    ``resize_crop`` transform); returns ``uint8 [th, tw, 3]``."""
    from PIL import Image

    w, h = pil_image.size  # PIL size is (W, H)
    th, tw = image_size
    rh, rw = th / h, tw / w
    if rh > rw:
        sh, sw = th, round(w * rh)
        image = pil_image.resize((sw, sh), Image.BICUBIC)
        i, j = 0, int(round((sw - tw) / 2.0))
    else:
        sh, sw = round(h * rw), tw
        image = pil_image.resize((sw, sh), Image.BICUBIC)
        i, j = int(round((sh - th) / 2.0)), 0
    arr = np.array(image)
    if i + th > arr.shape[0] or j + tw > arr.shape[1]:
        raise ValueError(f"crop {(th, tw)} at {(i, j)} exceeds the resized {arr.shape[:2]}")
    return arr[i:i + th, j:j + tw]


def read_from_path(path: str, image_size: Tuple[int, int]) -> np.ndarray:
    """An image or video reference as frames ``f32 [T, H, W, 3]`` in [-1, 1]
    after ``resize_crop_to_fill`` (``data_process.py:770-788``; ToTensorVideo
    and Normalize(0.5, 0.5) are pixels / 127.5 - 1). Videos (by extension)
    decode through imageio (mp4 needs an ffmpeg backend), images through
    PIL."""
    from PIL import Image

    ext = os.path.splitext(path.lower())[1]
    if ext in VID_EXTENSIONS:
        import imageio

        try:
            raw = imageio.mimread(path, memtest=False)
        except (OSError, ValueError, RuntimeError) as e:
            raise RuntimeError(f"could not decode video reference {path!r}: {e}. "
                               "mp4/avi need an imageio ffmpeg backend; GIF/WebP "
                               "decode natively.") from e
        arr = np.stack([resize_crop_to_fill(Image.fromarray(np.asarray(fr)).convert("RGB"),
                                            image_size) for fr in raw])
    else:
        with Image.open(path) as img:
            arr = resize_crop_to_fill(img.convert("RGB"), image_size)[None]
    return np.asarray(arr, np.float32) / 127.5 - 1.0


# prompt preprocessing

# pipeline_open_sora.py BAD_PUNCT_REGEX (the PixArt T5 cleaning set)
BAD_PUNCT_REGEX = re.compile(
    r"[" + "#®•©™&@·º½¾¿¡§~" + r"\)" + r"\(" + r"\]" + r"\[" + r"\}" + r"\{"
    + r"\|" + "\\" + r"\/" + r"\*" + r"]{1,}")


def _basic_clean(text: str) -> str:
    """ftfy.fix_text + double html unescape (``pipeline_open_sora.py:298-302``).
    ftfy is optional in this image; when absent the mojibake fixing is skipped
    (unescaping still runs)."""
    try:
        import ftfy
        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    return text.strip()


def _strip_html(caption: str) -> str:
    """BeautifulSoup(features='html.parser').text with an html.parser-stdlib
    fallback (both drop tags and keep text content)."""
    try:
        from bs4 import BeautifulSoup
        return BeautifulSoup(caption, features="html.parser").text
    except ImportError:
        from html.parser import HTMLParser

        class _Text(HTMLParser):
            def __init__(self):
                super().__init__()
                self.parts: List[str] = []

            def handle_data(self, d):
                self.parts.append(d)

        p = _Text()
        p.feed(caption)
        return "".join(p.parts)


def clean_caption(caption: str) -> str:
    """The exact T5 training-stage caption cleaning
    (``pipeline_open_sora.py:304-424``): lowercase, strip urls/html/@handles/
    CJK blocks, normalize dashes+quotes, drop ids/filenames/shipping spam,
    collapse punctuation and whitespace."""
    caption = str(caption)
    caption = ul.unquote_plus(caption)
    caption = caption.strip().lower()
    caption = re.sub("<person>", "person", caption)
    caption = re.sub(
        r"\b((?:https?:(?:\/{1,3}|[a-zA-Z0-9%])|[a-zA-Z0-9.\-]+[.](?:com|co|ru|net|org|edu|gov|it)[\w/-]*\b\/?(?!@)))",
        "", caption)
    caption = re.sub(
        r"\b((?:www:(?:\/{1,3}|[a-zA-Z0-9%])|[a-zA-Z0-9.\-]+[.](?:com|co|ru|net|org|edu|gov|it)[\w/-]*\b\/?(?!@)))",
        "", caption)
    caption = _strip_html(caption)
    caption = re.sub(r"@[\w\d]+\b", "", caption)
    for rng in (r"[\u31c0-\u31ef]+", r"[\u31f0-\u31ff]+", r"[\u3200-\u32ff]+",
                r"[\u3300-\u33ff]+", r"[\u3400-\u4dbf]+", r"[\u4dc0-\u4dff]+",
                r"[\u4e00-\u9fff]+"):
        caption = re.sub(rng, "", caption)
    caption = re.sub(
        r"[\u002D\u058A\u05BE\u1400\u1806\u2010-\u2015\u2E17\u2E1A\u2E3A\u2E3B\u2E40\u301C\u3030\u30A0\uFE31\uFE32\uFE58\uFE63\uFF0D]+",
        "-", caption)
    caption = re.sub(r"[`´«»“”¨]", '"', caption)
    caption = re.sub(r"[‘’]", "'", caption)
    caption = re.sub(r"&quot;?", "", caption)
    caption = re.sub(r"&amp", "", caption)
    caption = re.sub(r"\d{1,3}\.\d{1,3}\.\d{1,3}\.\d{1,3}", " ", caption)
    caption = re.sub(r"\d:\d\d\s+$", "", caption)
    caption = re.sub(r"\\n", " ", caption)
    caption = re.sub(r"#\d{1,3}\b", "", caption)
    caption = re.sub(r"#\d{5,}\b", "", caption)
    caption = re.sub(r"\b\d{6,}\b", "", caption)
    caption = re.sub(r"[\S]+\.(?:png|jpg|jpeg|bmp|webp|eps|pdf|apk|mp4)", "",
                     caption)
    caption = re.sub(r"[\"\']{2,}", r'"', caption)
    caption = re.sub(r"[\.]{2,}", r" ", caption)
    caption = re.sub(BAD_PUNCT_REGEX, r" ", caption)
    caption = re.sub(r"\s+\.\s+", r" ", caption)
    regex2 = re.compile(r"(?:\-|\_)")
    if len(re.findall(regex2, caption)) > 3:
        caption = re.sub(regex2, " ", caption)
    caption = _basic_clean(caption)
    caption = re.sub(r"\b[a-zA-Z]{1,3}\d{3,15}\b", "", caption)
    caption = re.sub(r"\b[a-zA-Z]+\d+[a-zA-Z]+\b", "", caption)
    caption = re.sub(r"\b\d+[a-zA-Z]+\d+\b", "", caption)
    caption = re.sub(r"(worldwide\s+)?(free\s+)?shipping", "", caption)
    caption = re.sub(r"(free\s)?download(\sfree)?", "", caption)
    caption = re.sub(r"\bclick\b\s(?:for|on)\s\w+", "", caption)
    caption = re.sub(
        r"\b(?:png|jpg|jpeg|bmp|webp|eps|pdf|apk|mp4)(\simage[s]?)?", "",
        caption)
    caption = re.sub(r"\bpage\s+\d+\b", "", caption)
    caption = re.sub(r"\b\d*[a-zA-Z]+\d+[a-zA-Z]+\d+[a-zA-Z\d]*\b", r" ",
                     caption)
    caption = re.sub(r"\b\d+\.?\d*[xх×]\d+\.?\d*\b", "", caption)
    caption = re.sub(r"\b\s+\:\s+", r": ", caption)
    caption = re.sub(r"(\D[,\./])\b", r"\1 ", caption)
    caption = re.sub(r"\s+", " ", caption)
    caption.strip()
    caption = re.sub(r"^[\"\']([\w\W]+)[\"\']$", r"\1", caption)
    caption = re.sub(r"^[\'\_,\-\:;]", r"", caption)
    caption = re.sub(r"[\'\_,\-\:\-\+]$", r"", caption)
    caption = re.sub(r"^\.\S+$", "", caption)
    return caption.strip()


def text_preprocessing(text: str, use_text_preprocessing: bool = True) -> str:
    """Applied twice, exactly like training (``pipeline_open_sora.py:418-424``)."""
    if use_text_preprocessing:
        return clean_caption(clean_caption(text))
    return text.lower().strip()


def append_score_to_prompts(prompts: Sequence[str], aes: Optional[float] = None,
                            flow: Optional[float] = None,
                            camera_motion: Optional[str] = None) -> List[str]:
    """Aesthetic/motion/camera score suffixes (``pipeline_open_sora.py:705-717``)."""
    out = []
    for prompt in prompts:
        p = prompt
        if aes is not None and "aesthetic score:" not in prompt:
            p = f"{p} aesthetic score: {aes:.1f}."
        if flow is not None and "motion score:" not in prompt:
            p = f"{p} motion score: {flow:.1f}."
        if camera_motion is not None and "camera motion:" not in prompt:
            p = f"{p} camera motion: {camera_motion}."
        out.append(p)
    return out



# loop-prompt plumbing

def extract_json_from_prompts(prompts, reference, mask_strategy):
    """Trailing ``{...}`` JSON carries reference_path / mask_strategy
    (``pipeline_open_sora.py:719-733``)."""
    ret = []
    for i, prompt in enumerate(prompts):
        parts = re.split(r"(?=[{])", prompt)
        if len(parts) > 2:
            raise ValueError(f"Invalid prompt: {prompt}")
        ret.append(parts[0])
        if len(parts) > 1:
            info = json.loads(parts[1])
            for key in info:
                if key not in ("reference_path", "mask_strategy"):
                    raise ValueError(f"Invalid key: {key}")
                if key == "reference_path":
                    reference[i] = info[key]
                else:
                    mask_strategy[i] = info[key]
    return ret, reference, mask_strategy


def split_prompt(prompt_text: str):
    """``|0| text |1| text`` per-loop prompts (``pipeline_open_sora.py:769-785``)."""
    if prompt_text.startswith("|0|"):
        parts = prompt_text.split("|")[1:]
        text_list, loop_idx = [], []
        for i in range(0, len(parts), 2):
            loop_idx.append(int(parts[i]))
            text_list.append(parts[i + 1].strip())
        return text_list, loop_idx
    return [prompt_text], None


def merge_prompt(text_list, loop_idx_list=None) -> str:
    if loop_idx_list is None:
        return text_list[0]
    return "".join(f"|{idx}|{text}"
                   for idx, text in zip(loop_idx_list, text_list))


def extract_prompts_loop(prompts, num_loop: int) -> List[str]:
    """Resolve each merged prompt to its loop-``num_loop`` segment
    (``pipeline_open_sora.py:753-766``)."""
    ret = []
    for prompt in prompts:
        if prompt.startswith("|0|"):
            parts = prompt.split("|")[1:]
            text_list = []
            for i in range(0, len(parts), 2):
                start = int(parts[i])
                text = parts[i + 1]
                end = int(parts[i + 2]) if i + 2 < len(parts) else num_loop + 1
                text_list.extend([text] * (end - start))
            prompt = text_list[num_loop]
        ret.append(prompt)
    return ret


# mask strategy (latents are channel-last: [B, T, H, W, C]; refs [T, H, W, C])

MASK_DEFAULT = ["0", "0", "0", "0", "1", "0"]


def parse_mask_strategy(mask_strategy: Optional[str]):
    """``loop_id,ref_id,ref_start,target_start,length,edit_ratio`` groups
    separated by ';', missing trailing fields from ``MASK_DEFAULT``
    (``pipeline_open_sora.py:798-815``)."""
    out = []
    if not mask_strategy:
        return out
    for mask in mask_strategy.split(";"):
        group = mask.split(",")
        if not 1 <= len(group) <= 6:
            raise ValueError(f"Invalid mask strategy: {mask}")
        group = group + MASK_DEFAULT[len(group):]
        out.append([int(group[i]) for i in range(5)] + [float(group[5])])
    return out


def find_nearest_point(value: int, point: int, max_value: int) -> int:
    t = value // point
    if value % point > point / 2 and t < max_value // point - 1:
        t += 1
    return t * point


def apply_mask_strategy(z: np.ndarray, refs_x, mask_strategys, loop_i: int,
                        align: Optional[int] = None):
    """Paste reference latents into ``z`` ``[B, T, H, W, C]`` (in place) and
    build the per-frame masks ``f32[B, T]`` (``pipeline_open_sora.py:825-854``);
    None when ``mask_strategys`` is empty. ``refs_x`` holds per-batch lists of
    ``[T, H, W, C]`` latents."""
    masks = []
    for i, mask_strategy in enumerate(mask_strategys):
        mask = np.ones(z.shape[1], np.float32)
        for mst in parse_mask_strategy(mask_strategy):
            loop_id, m_id, m_ref_start, m_target_start, m_length, edit_ratio = mst
            if loop_id != loop_i:
                continue
            ref = refs_x[i][m_id]
            if m_ref_start < 0:
                m_ref_start = ref.shape[0] + m_ref_start
            if m_target_start < 0:
                m_target_start = z.shape[1] + m_target_start
            if align is not None:
                m_ref_start = find_nearest_point(m_ref_start, align, ref.shape[0])
                m_target_start = find_nearest_point(m_target_start, align, z.shape[1])
            m_length = min(m_length, z.shape[1] - m_target_start,
                           ref.shape[0] - m_ref_start)
            z[i, m_target_start:m_target_start + m_length] = (
                ref[m_ref_start:m_ref_start + m_length])
            mask[m_target_start:m_target_start + m_length] = edit_ratio
        masks.append(mask)
    if not masks:
        return None
    return np.stack(masks)


def append_generated(encode_fn, generated_latents, refs_x, mask_strategy,
                     loop_i: int, condition_frame_length: int,
                     condition_frame_edit: float):
    """Loop extension: append the previous clip (through ``encode_fn``, or
    its latents as they are when None) as a new reference of each batch
    entry and extend its strategy with ``loop_i,ref,-L,0,L,edit``
    (``pipeline_open_sora.py:857-875``)."""
    ref_x = (encode_fn(generated_latents) if encode_fn is not None
             else generated_latents)
    for j in range(len(refs_x)):
        if refs_x[j] is None or len(refs_x[j]) == 0:
            refs_x[j] = [np.asarray(ref_x[j])]
        else:
            refs_x[j].append(np.asarray(ref_x[j]))
        mask_strategy[j] = (mask_strategy[j] + ";") if mask_strategy[j] else ""
        mask_strategy[j] += (
            f"{loop_i},{len(refs_x[j]) - 1},-{condition_frame_length},0,"
            f"{condition_frame_length},{condition_frame_edit}")
    return refs_x, mask_strategy
