"""Generation CLI, the ported subset of ``magcache_tpu.cli.generate``:
Wan2.1 t2v (``--task t2v-1.3B``, ``t2v-14B``, and ``t2i-14B``: one frame),
i2v (``--task i2v-14B --image``) and first-last-frame (``--task flf2v-14B
--first_frame --last_frame``), Wan2.1 VACE video editing (``--task
vace-1.3B``, ``vace-14B``, with ``--src_video --src_mask
--src_ref_images``), Wan2.2 TI2V-5B (``--task ti2v-5B``, with or without
``--image``) and the Wan2.2 A14B two-expert MoE (``--task t2v-A14B``,
``i2v-A14B --image``), Open-Sora 1.2 t2v (``--task open-sora``),
FLUX.1 text-to-image (``--task flux-dev`` and ``flux-kontext-dev``), Latte-1
t2v (``--task latte``), Open-Sora-Plan t2v (``--task open-sora-plan``: v1.2,
or v1.1 with ``--osp_version v110``), CogVideoX-5B t2v (``--task
cogvideox``), Vchitect-XL-2B t2v (``--task vchitect``), HunyuanVideo T2V
(``--task hunyuan``, ``hunyuan-720p``, ``hunyuan-544p``: one section of the
FramePack pipeline), FramePack (``--task framepack``, ``framepack-f1``) and
Qwen-Image (``--task qwen-image``; ``qwen-image-edit``, or ``qwen-image
--image``: the Edit model) and OmniGen2 (``--task omnigen2``: text-to-image,
or edit on the reference images of ``--image`` / ``--input_image_path``).

Flag names follow the reference adapters (``--task --size --frame_num
--sample_steps --sample_shift --sample_solver --sample_guide_scale
--base_seed --use_magcache --magcache_thresh --magcache_K --retention_ratio
--magcache_calibration --cache_policy``; Wan adds ``--enable_teacache
--teacache_thresh --use_ret_steps``, Open-Sora ``--resolution
--aspect_ratio --enable_pab`` and its conditioning flags ``--loop
--ms/--mask_strategy --refs/--reference_path --condition_frame_length
--condition_frame_edit --align --route``, FLUX ``--txt_len``, Latte
``--txt_len --clean_caption --route --enable_pab``, Open-Sora-Plan
``--txt_len --no_text_preprocessing --route --enable_pab --osp_version``,
CogVideoX ``--txt_len --use_dynamic_cfg --enable_pab``, Vchitect
``--txt_len --enable_pab``; HunyuanVideo and FramePack ``--txt_len --image
--enable_teacache --teacache_thresh`` and the hyvideo scripts' aliases
``--video_size H W --video_length --infer_steps --embedded_cfg_scale
--flow_shift --neg_prompt --cfg_scale --save_path``, also in their dash
spelling, e.g. ``--video-size``; Qwen-Image ``--txt_len --image``;
OmniGen2 ``--txt_len --image --enable_teacache --teacache_thresh`` and the
reference ``inference.py``'s names ``--instruction --input_image_path
--output_image_path --height --width --num_inference_step
--text_guidance_scale --image_guidance_scale --cfg_range_start
--cfg_range_end --scheduler --enable_taylorseer --teacache_rel_l1_thresh
--negative_prompt``),
and the output file name encodes the E/K/R triple. Unset flags take each
family's reference defaults, as in the JAX CLI (Wan: 50 steps, i2v 40;
shift 5.0, i2v at 480p and below 3.0, flf2v and VACE 16.0; guidance 5.0;
81 frames; the i2v and flf2v preset by the height, ``wan2.1-i2v-480p`` up
to 480 rows, else ``-720p``; Wan2.2: t2v-A14B 40 steps, shift 12.0,
guidance (low, high) (3.0, 4.0); i2v-A14B 40 steps, shift 5.0, (3.5, 3.5);
``--sample_guide_scale`` gives both experts one scale; ti2v-5B 50 steps,
shift 5.0, 121 frames, the preset ``wan2.2-ti2v-5B-i2v`` with ``--image``,
else ``-t2v``; every Wan task at 832*480 unless ``--size``; HunyuanVideo 50
steps, embedded guidance 6.0, the preset ``hunyuanvideo-720p`` from 700 rows
up, else ``-544p``; FramePack 25 steps, guidance 10.0, 5 sections of
``(frames - 1) // 4 + 1`` latent frames, a canvas divisible by 64; both
flow shift 7.0, 832*480, 81 frames, ``txt_len`` 256; Qwen-Image 50 steps,
true CFG 4.0, 1664*928, ``txt_len`` 256, text-to-image prompts with the
reference's ", Ultra HD, 4K, cinematic composition." appended; OmniGen2 50
steps, 1024*1024, ``txt_len`` 128, text guidance 5.0, image guidance 2.0,
Euler, the reference's negative prompt; of ``--enable_taylorseer``,
``--enable_teacache`` and ``--use_magcache`` the first given wins, with a
warning, as in the JAX CLI). Runs on a CUDA card by
default; ``--device cpu`` runs the plain PyTorch ops instead of the kernels
(tests use it at ``--tiny`` size; the tiny models' head dims are not ones
the kernels take, so ``--tiny`` on a card exits with a message).

Sequence parallelism (Wan only): ``--sp N``, or the reference's aliases
``--ulysses_size N`` and ``--ring_size N`` (ring attention), run N ranks,
one process each, every rank on ``1/N`` of the tokens. Start them with
``torchrun`` (it sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the
rendezvous address), or set ``RANK`` and ``WORLD_SIZE`` yourself and pass
``--dist_init_method``. Rank r runs on ``cuda:LOCAL_RANK`` over NCCL, or with
``--device cpu`` over gloo. Rank 0 saves the output.

Examples:
  python -m magcache_tpu_torch.cli.generate --task t2v-1.3B --size 832*480 \
      --sample_steps 50 --use_magcache --magcache_thresh 0.12 --magcache_K 2
  python -m magcache_tpu_torch.cli.generate --task t2v-1.3B --magcache_calibration
  python -m magcache_tpu_torch.cli.generate --task t2v-1.3B --sample_solver dpm++ \
      --use_magcache --cache_policy rolling --magcache_thresh 0.12 --magcache_K 2
  python -m magcache_tpu_torch.cli.generate --task t2v-1.3B --enable_teacache \
      --teacache_thresh 0.2 --use_ret_steps
  python -m magcache_tpu_torch.cli.generate --task i2v-14B --image x.png \
      --use_magcache                  # 832x480x81, 40 UniPC steps, E012K4R02
  python -m magcache_tpu_torch.cli.generate --task flf2v-14B --first_frame a.png \
      --last_frame b.npy              # 50 steps, shift 16
  python -m magcache_tpu_torch.cli.generate --task open-sora --resolution 480p \
      --aspect_ratio 9:16 --frame_num 51 --enable_pab      # or --task latte
  python -m magcache_tpu_torch.cli.generate --task open-sora --resolution 720p \
      --aspect_ratio 9:16 --frame_num 51 --use_magcache
  python -m magcache_tpu_torch.cli.generate --task open-sora --tiny --device cpu \
      --ms "0,0,0,0,1,0" --refs ref.npy --loop 2     # ref.npy: latents [T, H, W, C]
  python -m magcache_tpu_torch.cli.generate --task open-sora --tiny --device cpu \
      --route grouped                   # or vpu: STDiT3's unpacked composition
  python -m magcache_tpu_torch.cli.generate --task flux-dev --size 1024*1024 \
      --sample_steps 28 --use_magcache
  python -m magcache_tpu_torch.cli.generate --task latte --magcache_calibration \
      --save_file latte                 # 16x512x512, 50 DDIM steps: records ratios
  python -m magcache_tpu_torch.cli.generate --task latte --use_magcache \
      --mag_ratios_json latte_mag_ratio.json [--route grouped]
  python -m magcache_tpu_torch.cli.generate --task open-sora-plan --use_magcache \
      [--route unpacked | --osp_version v110] [--enable_pab]   # 29x480x640
  python -m magcache_tpu_torch.cli.generate --task cogvideox --use_dynamic_cfg \
      --use_magcache [--enable_pab]                             # 49x480x720
  python -m magcache_tpu_torch.cli.generate --task vchitect --magcache_calibration \
      --save_file vch                  # 40x480x768, 100 FlowMatch-Euler steps
  python -m magcache_tpu_torch.cli.generate --task vchitect --use_magcache \
      --mag_ratios_json vch_mag_ratio.json [--enable_pab]
  python -m magcache_tpu_torch.cli.generate --task hunyuan --video-size 720 1280 \
      --video-length 129 --use_magcache         # 118,800 tokens, 31 of 50 elided
  python -m magcache_tpu_torch.cli.generate --task framepack-f1 --size 768*512 \
      --image x.png --use_magcache              # 13 of 25 elided a section
  python -m magcache_tpu_torch.cli.generate --task qwen-image --use_magcache
  python -m magcache_tpu_torch.cli.generate --task qwen-image-edit --image x.png \
      --use_magcache                            # 1664x928, 2 lanes, 50 steps
  python -m magcache_tpu_torch.cli.generate --task omnigen2 --use_magcache
  python -m magcache_tpu_torch.cli.generate --task omnigen2 --input_image_path a.png \
      --instruction "make it snow" --use_magcache   # edit: 3 lanes on two programs
  torchrun --nproc_per_node 4 -m magcache_tpu_torch.cli.generate --task t2v-1.3B \
      --use_magcache --ulysses_size 4           # or --ring_size 4
Without checkpoint flags the DiT has random weights and the text encoders
are the hash-seeded mocks, and the output is latents. ``--ckpt_dir`` (or
OmniGen2's ``--model_path``) loads a published DiT checkpoint, with
``--transformer_lora_path`` an adapter merged in (FLUX, OmniGen2); a Wan
directory's ``*umt5*.pth``, ``--t5_ckpt``, ``--llm_ckpt`` and
``--clip_text_ckpt{,2}`` load encoders (always with the hash tokenizer: no
tokenizer file is read); ``--vae_ckpt`` loads the family's VAE, and the
decoded pixels are saved beside the latents (``<save_file>_pixels.npy``). Input images are ``.npy`` arrays ``[H, W, 3]`` in [0, 1] or
image files read with PIL. ``flux-kontext-dev --image`` conditions on the
image as the JAX CLI does without ``--vae_ckpt``: nearest-resized and
channel-tiled to the latent grid, not encoded. ``i2v-14B --image`` and
``flf2v-14B --first_frame --last_frame`` (``--image`` also gives flf2v's
first frame) encode their images through a random-weight CLIP vision tower
and, as the JAX CLI without a VAE, a random-weight causal VAE with the Wan
strides; so do VACE's ``--src_video`` (``.npy`` ``[F, H, W, 3]`` in [0, 1],
or a video or image file, resized and cropped to the canvas),
``--src_mask`` (``.npy`` ``[F, H, W]`` in [0, 1], or a pixel file whose
channels are averaged) and ``--src_ref_images`` (comma-separated images,
R2V). ``ti2v-5B --image`` takes the checkpoint-free encode: the image
nearest-resized to the latent grid times a fixed random projection.
HunyuanVideo's and FramePack's ``--image`` becomes the start latent as the
JAX CLI makes it without a VAE: nearest-resized and channel-tiled.
HunyuanVideo runs without history frames unless ``--image`` gives one (the
JAX CLI prepends two zero latent frames; ROADMAP §3). Qwen-Image-Edit's
``--image`` becomes the packed reference latents the same way (no VAE) and
its prompt goes to the mock encoder (no Qwen2.5-VL weights); without
``--image`` the Edit model sees zero reference latents. OmniGen2's
references are resized and tiled the same way, one block of tokens each,
and its three prompts (the prompt, the negative prompt and the reference
branch's) go to the mock encoder.
Open-Sora references are ``.npy`` latents; image
and video references need the pipeline's VAE, which the CLI does not build,
and raise.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np
import torch

# task families of the JAX CLI, and the ported tasks with their presets
_KNOWN = ("flux", "qwen", "hunyuan", "framepack", "open-sora", "cogvideox",
          "latte", "vchitect", "omnigen2", "t2v", "t2i", "i2v", "flf2v",
          "ti2v", "vace")
_PORTED = {"t2v-1.3B": "wan2.1-t2v-1.3B", "t2v-14B": "wan2.1-t2v-14B",
           "t2i-14B": "wan2.1-t2v-14B", "i2v-14B": "wan2.1-i2v-480p",
           "flf2v-14B": "wan2.1-i2v-480p", "vace-1.3B": "wan2.1-vace-1.3B",
           "vace-14B": "wan2.1-vace-14B", "ti2v-5B": "wan2.2-ti2v-5B-t2v",
           "t2v-A14B": "wan2.2-t2v-A14B", "i2v-A14B": "wan2.2-i2v-A14B",
           "open-sora": "opensora-v1.2",
           "flux-dev": "flux-dev", "flux-kontext-dev": "flux-kontext-dev",
           # no published ratios: calibrate, then --mag_ratios_json
           "latte": None, "open-sora-plan": None, "cogvideox": None, "vchitect": None}
# HunyuanVideo takes its preset by the canvas (hunyuanvideo-720p from 700
# rows up), FramePack the task's own
_HUNYUAN = ("hunyuan", "hunyuan-720p", "hunyuan-544p", "framepack", "framepack-f1")
_QWEN = ("qwen-image", "qwen-image-edit")
_OMNIGEN2 = "omnigen2"
_WAN = ("t2v-1.3B", "t2v-14B", "t2i-14B", "i2v-14B", "flf2v-14B", "vace-1.3B", "vace-14B",
        "ti2v-5B", "t2v-A14B", "i2v-A14B")
# the JAX CLI's Wan2.2 defaults: steps, shift, guidance, frames
_WAN22 = {"t2v-A14B": (40, 12.0, (3.0, 4.0), 81), "i2v-A14B": (40, 5.0, (3.5, 3.5), 81),
          "ti2v-5B": (50, 5.0, 5.0, 121)}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("magcache_tpu_torch generate")
    p.add_argument("--task", default="t2v-1.3B",
                   help="t2v-1.3B | t2v-14B | t2i-14B | i2v-14B | flf2v-14B | vace-1.3B | "
                        "vace-14B | ti2v-5B | t2v-A14B | i2v-A14B | open-sora | flux-dev | "
                        "flux-kontext-dev | latte | open-sora-plan | cogvideox | vchitect | "
                        "hunyuan | hunyuan-720p | hunyuan-544p | framepack | framepack-f1 | "
                        "qwen-image | qwen-image-edit | omnigen2")
    p.add_argument("--size", default=None,
                   help="W*H pixels (unset: 832*480 for Wan, Open-Sora, HunyuanVideo and "
                        "FramePack, 1024*1024 for FLUX and OmniGen2, 1664*928 for Qwen-Image)")
    p.add_argument("--frame_num", type=int, default=None,
                   help="frames (unset: 81; ti2v-5B 121)")
    p.add_argument("--sample_steps", type=int, default=None,
                   help="unset: 50 for Wan (i2v and the A14B tasks 40), Latte and CogVideoX, "
                        "30 for Open-Sora, 28 for FLUX, 150 for Open-Sora-Plan, 100 for "
                        "Vchitect, 50 for Qwen-Image and OmniGen2")
    p.add_argument("--sample_shift", type=float, default=None,
                   help="Wan flow shift (unset: 5.0; i2v at 480p and below 3.0, "
                        "flf2v and VACE 16.0, t2v-A14B 12.0)")
    p.add_argument("--sample_solver", default="unipc",
                   choices=["unipc", "dpm++", "euler"],
                   help="Wan's solver (the reference's unipc and dpm++, and Euler)")
    p.add_argument("--sample_guide_scale", type=float, default=None,
                   help="unset: 5.0 for Wan (the A14B tasks' expert pairs: t2v (3.0, "
                        "4.0), i2v (3.5, 3.5)), 7.0 for Open-Sora, 7.5 for Latte, "
                        "Open-Sora-Plan and Vchitect, 6.0 for CogVideoX, Qwen-Image's true "
                        "CFG 4.0; FLUX's embedded guidance 3.5 (2.5 for Kontext)")
    p.add_argument("--resolution", default=None,
                   help="open-sora bucket resolution (480p, 720p, ...); "
                        "overrides --size via the training bucket tables")
    p.add_argument("--aspect_ratio", default=None,
                   help="open-sora bucket aspect ratio (9:16, 16:9, ...)")
    # Open-Sora conditioning (the JAX CLI's names and defaults)
    p.add_argument("--loop", type=int, default=1,
                   help="open-sora looped generation count")
    p.add_argument("--ms", "--mask_strategy", dest="ms", default="",
                   help="open-sora mask strategy "
                        "'loop,ref,ref_start,target_start,len,edit_ratio;...'")
    p.add_argument("--refs", "--reference_path", dest="refs", default="",
                   help="open-sora reference paths (';'-separated .npy latents "
                        "[T, H, W, C]; image and video files need a VAE, which "
                        "the CLI does not build)")
    p.add_argument("--condition_frame_length", type=int, default=5,
                   help="latent frames handed to the next loop")
    p.add_argument("--condition_frame_edit", type=float, default=0.0,
                   help="edit ratio of the hand-off frames")
    p.add_argument("--align", type=int, default=5,
                   help="mask-strategy index alignment")
    p.add_argument("--txt_len", type=int, default=None,
                   help="FLUX text tokens (unset: 512); Latte caption tokens "
                        "(unset: 120); Open-Sora-Plan (512), CogVideoX (226), "
                        "Vchitect (77), Qwen-Image (256), OmniGen2 (128)")
    p.add_argument("--clean_caption", action="store_true",
                   help="latte: the T5 caption cleaning, applied twice")
    p.add_argument("--no_text_preprocessing", action="store_true",
                   help="open-sora-plan: skip the caption cleaning (on by default)")
    p.add_argument("--use_dynamic_cfg", action="store_true",
                   help="cogvideox: per-step cosine-ramped guidance scale")
    p.add_argument("--osp_version", default="v120", choices=["v120", "v110"],
                   help="open-sora-plan: v120 (3-D attention, Euler-Ancestral) or "
                        "v110 (the Latte trunk, PNDM)")
    p.add_argument("--route", default="packed",
                   choices=["packed", "grouped", "vpu", "unpacked"],
                   help="open-sora and latte block composition: packed (K5-K8), "
                        "or unpacked with temporal attention through K4 (grouped) "
                        "or K9 (vpu); open-sora-plan v120: packed or unpacked")
    p.add_argument("--image", default=None,
                   help="input image (.npy [H, W, 3] in [0, 1], or an image file): "
                        "i2v-14B's and i2v-A14B's (flf2v-14B's first frame), ti2v-5B's "
                        "(latent frame 0), or flux-kontext-dev's conditioning image and "
                        "qwen-image's Edit reference (the Edit model) and omnigen2's "
                        "reference (edit mode), resized and channel-tiled to the latent "
                        "grid (no VAE weights)")
    p.add_argument("--first_frame", default=None,
                   help="flf2v-14B: the first frame (.npy or an image file)")
    p.add_argument("--last_frame", default=None,
                   help="flf2v-14B: the last frame (.npy or an image file)")
    p.add_argument("--src_video", default=None,
                   help="vace: the source video (.npy [F, H, W, 3] in [0, 1], or a video or "
                        "image file)")
    p.add_argument("--src_mask", default=None,
                   help="vace: the edit mask (.npy [F, H, W] in [0, 1], or a pixel file)")
    p.add_argument("--src_ref_images", default=None,
                   help="vace R2V: comma-separated reference images (prepended latent "
                        "frames, trimmed after sampling)")
    p.add_argument("--base_seed", type=int, default=0)
    p.add_argument("--prompt", default="Two anthropomorphic cats in comfy "
                   "boxing gear and bright gloves fight intensely on a "
                   "spotlighted stage.")
    p.add_argument("--save_file", default=None)
    p.add_argument("--use_magcache", action="store_true")
    p.add_argument("--magcache_thresh", type=float, default=None)
    p.add_argument("--magcache_K", type=int, default=None)
    p.add_argument("--retention_ratio", type=float, default=None)
    p.add_argument("--cache_policy", choices=("adapter", "rolling"), default="adapter",
                   help="MagCache decision rule for t2v-1.3B and open-sora: the "
                        "release adapter rule, or the eval scripts' rolling rule "
                        "(wan_magcache.py:683-817)")
    p.add_argument("--magcache_calibration", action="store_true")
    p.add_argument("--enable_teacache", action="store_true",
                   help="the TeaCache comparator: Wan (per lane), HunyuanVideo / "
                        "FramePack, omnigen2 (a policy per guidance branch)")
    p.add_argument("--teacache_thresh", type=float, default=None,
                   help="TeaCache threshold (unset: 0.2; omnigen2 0.05)")
    p.add_argument("--use_ret_steps", action="store_true",
                   help="TeaCache's retention-steps variant: the e0 signal and a "
                        "longer forced warm-up")
    p.add_argument("--enable_pab", action="store_true",
                   help="open-sora, latte, open-sora-plan, cogvideox and vchitect: "
                        "Pyramid Attention Broadcast")
    p.add_argument("--mag_ratios_json", default=None,
                   help="path to a calibration-mode *_mag_ratio.json; its "
                        "ratios replace the preset's published array")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--tiny", action="store_true",
                   help="toy-size model for smoke runs")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) needs a card")
    # sequence parallelism (the reference's xfuser flags map onto sp)
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel ranks (t2v-1.3B; one process each)")
    p.add_argument("--ulysses_size", type=int, default=None,
                   help="alias: --sp with Ulysses attention")
    p.add_argument("--ring_size", type=int, default=None,
                   help="alias: --sp with ring attention")
    # the hyvideo scripts' names (magcache_sample_video.py), HunyuanVideo and
    # FramePack only, with the JAX CLI's precedence where both are given
    p.add_argument("--video_size", type=int, nargs=2, default=None, metavar=("H", "W"),
                   help="hunyuan alias: height width (--size W*H)")
    p.add_argument("--video_length", type=int, default=None,
                   help="hunyuan alias for --frame_num")
    p.add_argument("--infer_steps", type=int, default=None,
                   help="hunyuan alias for --sample_steps")
    p.add_argument("--embedded_cfg_scale", type=float, default=None,
                   help="hunyuan embedded (distilled) guidance (unset: 6.0, FramePack 10.0)")
    p.add_argument("--flow_shift", type=float, default=None,
                   help="hunyuan flow shift (alias of --sample_shift; unset: 7.0)")
    p.add_argument("--negative_prompt", "--neg_prompt", dest="negative_prompt",
                   default=None, help="omnigen2: the uncond branch's prompt (unset: the "
                                      "reference's default); hunyuan: ignored with a "
                                      "warning (the distilled model runs one forward a "
                                      "step, no CFG)")
    p.add_argument("--cfg_scale", type=float, default=None,
                   help="hunyuan: ignored with a warning unless 1.0 (no CFG)")
    p.add_argument("--save_path", default=None, help="alias for --save_file")
    # the OmniGen2 reference's inference.py names (omnigen2 only)
    p.add_argument("--instruction", default=None, help="omnigen2 alias for --prompt")
    p.add_argument("--input_image_path", default=None, nargs="+",
                   help="omnigen2 edit: the reference images, one block of tokens each")
    p.add_argument("--output_image_path", default=None,
                   help="omnigen2 alias for --save_file")
    p.add_argument("--height", type=int, default=None,
                   help="omnigen2: output height (with --width; --size wins)")
    p.add_argument("--width", type=int, default=None,
                   help="omnigen2: output width (with --height)")
    p.add_argument("--num_inference_step", type=int, default=None,
                   help="omnigen2 alias for --sample_steps")
    p.add_argument("--text_guidance_scale", type=float, default=None,
                   help="omnigen2 text guidance (unset: 5.0)")
    p.add_argument("--image_guidance_scale", type=float, default=None,
                   help="omnigen2 image guidance, edit mode (unset: 2.0)")
    p.add_argument("--cfg_range_start", type=float, default=None,
                   help="omnigen2: guidance window start, a fraction of the steps (unset: 0)")
    p.add_argument("--cfg_range_end", type=float, default=None,
                   help="omnigen2: guidance window end (unset: 1)")
    p.add_argument("--scheduler", default=None, choices=["euler", "dpmsolver++"],
                   help="omnigen2 solver: euler (unset) or flow-match DPM-Solver++(2M)")
    p.add_argument("--enable_taylorseer", action="store_true",
                   help="omnigen2: the TaylorSeer forecasting comparator")
    p.add_argument("--teacache_rel_l1_thresh", type=float, default=None,
                   help="omnigen2 alias of --teacache_thresh (which wins when both are given)")
    # published checkpoints (models/published.py, models/checkpoint.py)
    p.add_argument("--ckpt_dir", default=None,
                   help="a published DiT checkpoint: a directory of *.safetensors "
                        "(sharded or not) or torch files, or one file; a Wan "
                        "directory's *umt5*.pth is its text encoder")
    p.add_argument("--model_path", "--transformer_path", dest="model_path", default=None,
                   help="omnigen2 aliases of --ckpt_dir (the transformer directory)")
    p.add_argument("--transformer_lora_path", default=None,
                   help="a LoRA adapter (PEFT or kohya keys) merged into the "
                        "checkpoint's weights at load (omnigen2, flux)")
    p.add_argument("--lora_scale", type=float, default=1.0,
                   help="the scale of --transformer_lora_path (PEFT's lora_scale)")
    p.add_argument("--vae_ckpt", default=None,
                   help="a VAE checkpoint: the Wan VAE .pth for the Wan and Qwen "
                        "tasks (shape-sniffed), else the family's VAE")
    p.add_argument("--vae_dtype", default=None, choices=["float32", "bfloat16"],
                   help="the Wan VAE's conv dtype (default float32)")
    p.add_argument("--clip_ckpt", default=None,
                   help="the CLIP vision tower's weights for Wan i2v / flf2v")
    p.add_argument("--t5_ckpt", default=None,
                   help="a T5-family encoder checkpoint (UMT5 routed by config.json, "
                        "file name or key names; T5 / mT5 by HF names)")
    p.add_argument("--llm_ckpt", default=None,
                   help="the Llama (HunyuanVideo, FramePack) or Qwen2.5-VL "
                        "(Qwen-Image, OmniGen2) text tower's weights")
    p.add_argument("--clip_text_ckpt", default=None,
                   help="a CLIP-L text tower's weights: FLUX's, HunyuanVideo's "
                        "and FramePack's pooled vector; with --clip_text_ckpt2 and "
                        "--t5_ckpt Vchitect's SD3 stack")
    p.add_argument("--clip_text_ckpt2", default=None,
                   help="the CLIP-bigG text tower's weights (Vchitect's SD3 stack)")
    p.add_argument("--dist_init_method", default=None,
                   help="process-group rendezvous (tcp://host:port or "
                        "file:///path) when not started by torchrun; RANK and "
                        "WORLD_SIZE are read from the environment")
    return p


def _sp_plan(args, device):
    """``(plan, device)`` of this process's rank for ``--sp`` > 1: joins the
    process group (NCCL on ``cuda:LOCAL_RANK``, gloo for ``--device cpu``)."""
    from magcache_tpu_torch.parallel.mesh import MeshPlan, TorchDistGroup, init_distributed

    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        raise SystemExit(
            f"--sp {args.sp} runs one process per rank: start them with torchrun "
            f"(torchrun --nproc_per_node {args.sp} -m magcache_tpu_torch.cli.generate "
            f"...), which sets RANK and WORLD_SIZE")
    world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    if world != args.sp:
        raise SystemExit(f"--sp {args.sp} but WORLD_SIZE is {world}")
    if device.type == "cuda":
        device = torch.device("cuda", int(env.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
    kw = {}
    if args.dist_init_method:
        kw = dict(init_method=args.dist_init_method, world_size=world, rank=rank)
    init_distributed(backend="nccl" if device.type == "cuda" else "gloo", **kw)
    return MeshPlan(TorchDistGroup()), device


def _wan_pipeline(args, device, ratios):
    from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

    plan = None
    if args.sp > 1:
        plan, device = _sp_plan(args, device)

    w, h = _parse_size(args.size)
    model = _PORTED[args.task]
    if h > 480 and model == "wan2.1-i2v-480p":
        model = "wan2.1-i2v-720p"
    if args.task == "ti2v-5B" and args.image:
        model = "wan2.2-ti2v-5B-i2v"
    task = args.task.split("-")[0].replace("t2i", "t2v")
    steps, shift, guide, frames = _WAN22.get(args.task, (
        40 if task == "i2v" else 50,
        3.0 if task == "i2v" and min(w, h) <= 480 else 16.0 if task in ("flf2v", "vace")
        else 5.0, 5.0, 81))
    frame_num = args.frame_num or frames
    if args.tiny:
        w, h, frame_num = 64, 32, 9
    if args.task.startswith("t2i"):
        frame_num = 1
    refs = args.src_ref_images.split(",") if args.src_ref_images else []
    cfg = WanPipelineConfig(
        model=model, task=task, size=(w, h), frame_num=frame_num,
        sample_steps=args.sample_steps or steps,
        sample_shift=shift if args.sample_shift is None else args.sample_shift,
        sample_solver=args.sample_solver,
        guide_scale=guide if args.sample_guide_scale is None else args.sample_guide_scale,
        vace_ref_images=len(refs),
        use_magcache=args.use_magcache, magcache_thresh=args.magcache_thresh,
        magcache_K=args.magcache_K, retention_ratio=args.retention_ratio,
        cache_policy=args.cache_policy, magcache_calibration=args.magcache_calibration,
        enable_teacache=args.enable_teacache,
        teacache_thresh=0.2 if args.teacache_thresh is None else args.teacache_thresh,
        use_ret_steps=args.use_ret_steps,
        mag_ratios_override=ratios, dtype=args.dtype, tiny=args.tiny,
        sp=args.sp, sp_impl="ring" if args.ring_size else "auto",
        ckpt_dir=args.ckpt_dir, clip_ckpt=args.clip_ckpt)
    # the reference's one --ckpt_dir holds the encoder too
    # (models_t5_umt5-xxl-enc-*.pth, magcache_generate.py:884-893)
    t5_src = args.t5_ckpt
    if not t5_src and args.ckpt_dir and glob.glob(os.path.join(args.ckpt_dir, "*umt5*.pth")):
        t5_src = args.ckpt_dir
    text = _t5(t5_src, cfg.model_config().text_len, device)
    return WanPipeline(cfg, device, plan=plan, text_encoder=text), cfg.sample_steps, 2


def _open_sora_pipeline(args, device, ratios):
    from magcache_tpu_torch.pipelines.open_sora import (OpenSoraPipeline,
                                                        OpenSoraPipelineConfig)

    w, h = _parse_size(args.size)
    frame_num = args.frame_num or 81
    if args.tiny:
        w = h = 32
        frame_num = 8
    cfg = OpenSoraPipelineConfig(
        num_frames=frame_num, height=h, width=w, resolution=args.resolution,
        aspect_ratio=args.aspect_ratio,
        num_sampling_steps=args.sample_steps or 30,
        cfg_scale=(7.0 if args.sample_guide_scale is None
                   else args.sample_guide_scale),
        caption_len=6 if args.tiny else 300,
        use_magcache=args.use_magcache, magcache_thresh=args.magcache_thresh,
        magcache_K=args.magcache_K, retention_ratio=args.retention_ratio,
        magcache_calibration=args.magcache_calibration, magcache_ratios=ratios,
        cache_policy=args.cache_policy, enable_pab=args.enable_pab,
        dtype=args.dtype, tiny=args.tiny, route=args.route, ckpt_dir=args.ckpt_dir)
    pipe = OpenSoraPipeline(cfg, device, text_encoder=_t5(args.t5_ckpt, cfg.caption_len, device))
    return pipe, cfg.num_sampling_steps, 1


def _flux_pipeline(args, device, ratios):
    from magcache_tpu_torch.pipelines.flux import FluxPipeline, FluxPipelineConfig

    if args.image and "kontext" not in args.task:
        raise SystemExit("--image: of the FLUX tasks only flux-kontext-dev conditions "
                         "on an input image (FLUX.1-dev is t2i)")
    w, h = _parse_size(args.size, "1024*1024")
    if args.tiny:
        w = h = 64
    cfg = FluxPipelineConfig(
        model=args.task, height=h, width=w,
        # embedded guidance: flux-dev 3.5, Kontext 2.5
        guidance=(args.sample_guide_scale if args.sample_guide_scale
                  is not None else (2.5 if "kontext" in args.task else 3.5)),
        num_inference_steps=args.sample_steps or 28,
        txt_len=8 if args.tiny else (args.txt_len or 512),
        use_magcache=args.use_magcache, magcache_thresh=args.magcache_thresh,
        magcache_K=args.magcache_K, retention_ratio=args.retention_ratio,
        magcache_calibration=args.magcache_calibration,
        mag_ratios_override=ratios, dtype=args.dtype, tiny=args.tiny,
        ckpt_dir=args.ckpt_dir, lora_path=args.transformer_lora_path,
        lora_scale=args.lora_scale)
    pipe = FluxPipeline(cfg, device, text_encoder=_t5(args.t5_ckpt, cfg.txt_len, device),
                        pooled_encoder=_clip_text(args.clip_text_ckpt, device))
    return pipe, cfg.num_inference_steps, 1


def _latte_pipeline(args, device, ratios):
    from magcache_tpu_torch.pipelines.latte import LattePipeline, LattePipelineConfig

    kw = dict(num_sampling_steps=args.sample_steps or 50,
              guidance_scale=(7.5 if args.sample_guide_scale is None
                              else args.sample_guide_scale),
              use_magcache=args.use_magcache,
              magcache_calibration=args.magcache_calibration, magcache_ratios=ratios,
              clean_caption=args.clean_caption, dtype=args.dtype, tiny=args.tiny,
              route=args.route, enable_pab=args.enable_pab)
    for name in ("magcache_thresh", "magcache_K", "retention_ratio"):
        if getattr(args, name) is not None:
            kw[name] = getattr(args, name)
    if args.tiny:
        kw.update(num_frames=4, height=64, width=64, caption_len=6)
    elif args.txt_len:
        kw["caption_len"] = args.txt_len
    cfg = LattePipelineConfig(**kw, ckpt_dir=args.ckpt_dir)
    pipe = LattePipeline(cfg, device, text_encoder=_t5(args.t5_ckpt, cfg.caption_len, device))
    return pipe, cfg.num_sampling_steps, 1


def _common_kw(args, ratios) -> dict:
    """The MagCache and PAB settings every later family's config takes."""
    kw = dict(use_magcache=args.use_magcache, magcache_calibration=args.magcache_calibration,
              magcache_ratios=ratios, dtype=args.dtype, tiny=args.tiny,
              enable_pab=args.enable_pab, ckpt_dir=args.ckpt_dir)
    for name in ("magcache_thresh", "magcache_K", "retention_ratio"):
        if getattr(args, name) is not None:
            kw[name] = getattr(args, name)
    return kw


def _open_sora_plan_pipeline(args, device, ratios):
    from magcache_tpu_torch.pipelines.open_sora_plan import (OpenSoraPlanPipeline,
                                                             OpenSoraPlanPipelineConfig)

    if args.route not in ("packed", "unpacked"):
        raise SystemExit(f"--route {args.route}: open-sora-plan takes packed or unpacked")
    if args.osp_version == "v110" and (args.route != "packed" or args.magcache_calibration):
        raise SystemExit("open-sora-plan v110 runs the Latte trunk's packed route and "
                         "records no calibration (its PNDM is not wired for it)")
    kw = dict(_common_kw(args, ratios), version=args.osp_version,
              num_inference_steps=args.sample_steps or 150,
              guidance_scale=(7.5 if args.sample_guide_scale is None
                              else args.sample_guide_scale),
              clean_caption=not args.no_text_preprocessing, route=args.route)
    if args.tiny:
        kw.update(num_frames=5, height=32, width=32, caption_len=6)
    elif args.txt_len:
        kw["caption_len"] = args.txt_len
    cfg = OpenSoraPlanPipelineConfig(**kw)
    pipe = OpenSoraPlanPipeline(cfg, device,
                                text_encoder=_t5(args.t5_ckpt, cfg.caption_len, device))
    return pipe, cfg.num_inference_steps, 2


def _cogvideox_pipeline(args, device, ratios):
    from magcache_tpu_torch.pipelines.cogvideox import (CogVideoXPipeline,
                                                        CogVideoXPipelineConfig)

    kw = dict(_common_kw(args, ratios), num_inference_steps=args.sample_steps or 50,
              guidance_scale=(6.0 if args.sample_guide_scale is None
                              else args.sample_guide_scale),
              use_dynamic_cfg=args.use_dynamic_cfg)
    if args.tiny:
        kw.update(num_frames=5, height=32, width=32)
    elif args.txt_len:
        kw["txt_len"] = args.txt_len
    cfg = CogVideoXPipelineConfig(**kw)
    pipe = CogVideoXPipeline(cfg, device, text_encoder=_t5(args.t5_ckpt, cfg.txt_len, device))
    return pipe, cfg.num_inference_steps, 1


def _vchitect_pipeline(args, device, ratios):
    from magcache_tpu_torch.pipelines.vchitect import (VchitectPipeline,
                                                       VchitectPipelineConfig)

    kw = dict(_common_kw(args, ratios), num_inference_steps=args.sample_steps or 100,
              guidance_scale=(7.5 if args.sample_guide_scale is None
                              else args.sample_guide_scale))
    if args.tiny:
        kw.update(num_frames=4, height=32, width=32, txt_len=6)
    elif args.txt_len:
        kw["txt_len"] = args.txt_len
    text = pooled = None
    if args.clip_text_ckpt and args.clip_text_ckpt2 and args.t5_ckpt:
        # the SD3 triple stack (pipeline_vchitect.py: CLIP-L + CLIP-bigG
        # penultimate states and projected pooled vectors, T5 at 256)
        from magcache_tpu_torch.models.text import Sd3TextStack

        clip_l, clip_g = (_clip_text(c, device, hidden_skip=1, project=True)
                          for c in (args.clip_text_ckpt, args.clip_text_ckpt2))
        stack = Sd3TextStack(clip_l, clip_g, _t5(args.t5_ckpt, 256, device))
        kw["txt_len"] = clip_l.seq_len + 256
        text, pooled = stack.context, stack.pooled
    elif args.clip_text_ckpt or args.clip_text_ckpt2 or args.t5_ckpt:
        raise SystemExit("--task vchitect: its SD3 text stack takes --clip_text_ckpt, "
                         "--clip_text_ckpt2 and --t5_ckpt together")
    cfg = VchitectPipelineConfig(**kw)
    pipe = VchitectPipeline(cfg, device, text_encoder=text, pooled_encoder=pooled)
    return pipe, cfg.num_inference_steps, 2


def _hunyuan_pipeline(args, device, ratios):
    """HunyuanVideo (one section of the FramePack pipeline, no clean-latent
    pyramid) or FramePack, with the JAX CLI's ``_hunyuan_pipeline``
    defaults."""
    from magcache_tpu_torch.pipelines.framepack import (FramePackPipeline,
                                                        FramePackPipelineConfig)

    if args.video_size:
        h, w = args.video_size          # hyvideo orders height, width
    else:
        w, h = _parse_size(args.size)
    frame_num = args.video_length or args.frame_num or 81
    fp = args.task.startswith("framepack")
    if args.tiny:
        w = h = 64 if fp else 32
    if fp and (h % 64 or w % 64):
        raise SystemExit(f"--task {args.task}: the clean-latent pyramid needs a canvas "
                         f"whose height and width are divisible by 64, got {w}*{h}; pass "
                         f"--size W*H (e.g. --size 768*512)")
    guidance = next((g for g in (args.embedded_cfg_scale, args.sample_guide_scale)
                     if g is not None), 10.0 if fp else 6.0)
    shift = next((s for s in (args.sample_shift, args.flow_shift) if s is not None), 7.0)
    cfg = FramePackPipelineConfig(
        model=(args.task if fp else
               "hunyuanvideo-720p" if h >= 700 else "hunyuanvideo-544p"),
        height=h, width=w, pyramid=fp,
        # plain HunyuanVideo conditions on no history, unless an image is given
        history_frames=2 if args.image else 0,
        latent_window_size=2 if args.tiny else (frame_num - 1) // 4 + 1,
        total_sections=5 if fp else 1,
        steps=args.sample_steps or args.infer_steps or (25 if fp else 50),
        guidance=guidance, flow_shift=shift,
        txt_len=8 if args.tiny else (args.txt_len or 256),
        use_magcache=args.use_magcache, magcache_thresh=args.magcache_thresh,
        magcache_K=args.magcache_K, retention_ratio=args.retention_ratio,
        use_teacache=args.enable_teacache, teacache_thresh=args.teacache_thresh,
        magcache_calibration=args.magcache_calibration, mag_ratios_override=ratios,
        dtype=args.dtype, tiny=args.tiny, ckpt_dir=args.ckpt_dir)
    text = None
    if args.llm_ckpt:
        from magcache_tpu_torch.models.text import LlamaTextEncoder

        text = LlamaTextEncoder(args.llm_ckpt, out_len=cfg.txt_len, device=device)
    pipe = FramePackPipeline(cfg, device, text_encoder=text,
                             pooled_encoder=_clip_text(args.clip_text_ckpt, device))
    return pipe, cfg.steps, 1


def _qwen_pipeline(args, device, ratios):
    """Qwen-Image, or with ``--image`` (or ``--task qwen-image-edit``) the
    Edit model, with the JAX CLI's ``_qwen_pipeline`` defaults."""
    from magcache_tpu_torch.pipelines.qwen_image import (QwenImagePipeline,
                                                         QwenImagePipelineConfig)

    # unset --size: the reference's 16:9 canvas
    w, h = _parse_size(args.size, "1664*928")
    if args.tiny:
        w = h = 64
    model = "qwen-image-edit" if args.image else args.task
    cfg = QwenImagePipelineConfig(
        model=model, height=h, width=w, sample_steps=args.sample_steps or 50,
        true_cfg_scale=4.0 if args.sample_guide_scale is None else args.sample_guide_scale,
        txt_len=8 if args.tiny else (args.txt_len or 256),
        use_magcache=args.use_magcache, magcache_thresh=args.magcache_thresh,
        magcache_K=args.magcache_K, retention_ratio=args.retention_ratio,
        magcache_calibration=args.magcache_calibration, mag_ratios_override=ratios,
        dtype=args.dtype, tiny=args.tiny, ckpt_dir=args.ckpt_dir)
    text = None
    if args.llm_ckpt:
        from magcache_tpu_torch.models import text as T

        if "edit" in model and args.image:
            # Edit's stack: the reference image rides the chat template through
            # the Qwen2.5-VL vision tower; its merged tokens and the prompt fit
            # txt_len (96 tokens kept for the prompt and the specials)
            from magcache_tpu_torch.pipelines.flux import load_image

            text = T.QwenVLTextEncoder(args.llm_ckpt, out_len=cfg.txt_len, device=device,
                                       max_pixels=max(56 * 56, (cfg.txt_len - 96) * 28 * 28))
            text.set_image(load_image(args.image))
        else:
            text = T.LlamaTextEncoder(args.llm_ckpt, out_len=cfg.txt_len, skip_layers=0,
                                      template=T.QWEN_IMAGE_PROMPT_TEMPLATE,
                                      crop_start=T.QWEN_IMAGE_CROP_START, device=device)
    return QwenImagePipeline(cfg, device, text_encoder=text), cfg.sample_steps, 2


def _omnigen2_pipeline(args, device):
    """OmniGen2, text-to-image or, with reference images, edit, with the JAX
    CLI's ``_omnigen2_pipeline`` defaults and priority warnings (the flags
    a comparator overrides are cleared in ``args``)."""
    from magcache_tpu_torch.pipelines.omnigen2 import (OmniGen2Pipeline,
                                                       OmniGen2PipelineConfig)

    refs = _omnigen2_refs(args)
    taylor, tea, use_mag = args.enable_taylorseer, args.enable_teacache, args.use_magcache
    if taylor and tea:
        print("WARNING: enable_teacache and enable_taylorseer are mutually exclusive. "
              "enable_teacache will be ignored.")
        tea = False
    if (taylor or tea) and use_mag:
        print("WARNING: --use_magcache is ignored when a comparator cache is enabled "
              "(reference if/elif priority).")
        use_mag = False
    args.enable_teacache, args.use_magcache = tea, use_mag
    size = args.size or (f"{args.width}*{args.height}" if args.width and args.height else None)
    w, h = _parse_size(size, "1024*1024")
    kw = dict(mode="edit" if refs else "t2i", height=h, width=w,
              num_inference_steps=args.sample_steps or args.num_inference_step or 50,
              use_magcache=use_mag, enable_taylorseer=taylor, enable_teacache=tea,
              magcache_calibration=args.magcache_calibration, dtype=args.dtype,
              tiny=args.tiny, ref_images=max(len(refs), 1))
    thresh = (args.teacache_thresh if args.teacache_thresh is not None
              else args.teacache_rel_l1_thresh)
    for key, val in (("magcache_thresh", args.magcache_thresh), ("magcache_K", args.magcache_K),
                     ("retention_ratio", args.retention_ratio), ("teacache_thresh", thresh),
                     ("text_guidance_scale", args.text_guidance_scale),
                     ("image_guidance_scale", args.image_guidance_scale),
                     ("scheduler", args.scheduler)):
        if val is not None:
            kw[key] = val
    if args.cfg_range_start is not None or args.cfg_range_end is not None:
        kw["cfg_range"] = (0.0 if args.cfg_range_start is None else args.cfg_range_start,
                           1.0 if args.cfg_range_end is None else args.cfg_range_end)
    if args.tiny:
        kw.update(height=32, width=32, txt_len=6)
    elif args.txt_len:
        kw["txt_len"] = args.txt_len
    kw.update(ckpt_dir=args.ckpt_dir or args.model_path, lora_path=args.transformer_lora_path,
              lora_scale=args.lora_scale)
    cfg = OmniGen2PipelineConfig(**kw)
    text = None
    if args.llm_ckpt:
        # the reference's pipeline.mllm, a Qwen2.5-VL LM on the raw prompt
        # (final-normed last hidden state), as the JAX CLI
        from magcache_tpu_torch.models.text import LlamaTextEncoder

        text = LlamaTextEncoder(args.llm_ckpt, out_len=cfg.txt_len, skip_layers=0,
                                template=None, device=device)
    pipe = OmniGen2Pipeline(cfg, device, text_encoder=text)
    return pipe, kw["num_inference_steps"], pipe.lanes


def _t5(path, seq_len: int, device):
    """A T5-family encoder of a checkpoint (``--t5_ckpt``, or Wan's
    ``ckpt_dir``), or None for the pipeline's mock."""
    if not path:
        return None
    from magcache_tpu_torch.models.text import make_t5_encoder

    return make_t5_encoder(path, seq_len=seq_len, device=device)


def _clip_text(path, device, **kw):
    """A CLIP text encoder of a checkpoint, or None for the pipeline's mock."""
    if not path:
        return None
    from magcache_tpu_torch.models.text import ClipTextEncoder

    return ClipTextEncoder(path, device=device, **kw)


def _attach_vae(args, pipe) -> None:
    """``--vae_ckpt`` into the pipeline's VAE slot, routed by task as the JAX
    CLI does: the Wan VAE for the Wan and Qwen tasks, the CogVideoX,
    Open-Sora-Plan (its version's config) and Open-Sora composite VAEs for
    theirs, the SD VAE for FLUX, Latte and Vchitect. A task with no slot
    exits."""
    if not args.vae_ckpt:
        if args.vae_dtype:
            print("WARNING: --vae_dtype applies to the Wan VAE of --vae_ckpt; the "
                  "pipeline has none attached, flag ignored.")
        return
    if not hasattr(pipe, "vae"):
        raise SystemExit(f"--vae_ckpt: task {args.task} has no VAE slot")
    t0 = time.time()
    if args.task in _WAN or args.task in _QWEN:
        from magcache_tpu_torch.models.vae_wan import load_wan_vae_checkpoint

        vae = load_wan_vae_checkpoint(args.vae_ckpt, dtype=args.vae_dtype, device=pipe.device)
    elif args.vae_dtype:
        raise SystemExit(f"--vae_dtype: the {args.task} VAE is f32 only")
    elif args.task == "cogvideox":
        from magcache_tpu_torch.models.vae_cogvideox import load_cogvideox_vae_checkpoint

        vae = load_cogvideox_vae_checkpoint(args.vae_ckpt, device=pipe.device)
    elif args.task == "open-sora-plan":
        from magcache_tpu_torch.models.vae_osp import load_osp_vae_checkpoint

        vae = load_osp_vae_checkpoint(args.vae_ckpt, pipe.config.vae_config(), pipe.device)
    elif args.task == "open-sora":
        from magcache_tpu_torch.models.vae_temporal import load_open_sora_vae

        vae = load_open_sora_vae(args.vae_ckpt, device=pipe.device)
    else:
        from magcache_tpu_torch.models.vae_sd import load_sd_vae_checkpoint

        vae = load_sd_vae_checkpoint(args.vae_ckpt, device=pipe.device)
    pipe.vae = vae
    print(f"loaded the VAE {args.vae_ckpt} in {time.time() - t0:.1f}s")


def _omnigen2_refs(args) -> list:
    """OmniGen2's reference image paths: every ``--input_image_path``, else
    ``--image``."""
    return list(args.input_image_path or ([args.image] if args.image else []))


def _normalize_argv(argv, parser):
    """The hyvideo scripts' dash spelling (``--video-size``, ``--infer-steps``,
    ...) of every flag registered with underscores."""
    known = {o for act in parser._actions for o in act.option_strings}
    out = []
    for tok in argv:
        flag, eq, val = tok.partition("=")
        cand = "--" + flag[2:].replace("-", "_")
        if flag.startswith("--") and flag not in known and cand in known:
            tok = cand + eq + val
        out.append(tok)
    return out


def _load_frames(path: str, pipe) -> np.ndarray:
    """A VACE source video or mask: a ``.npy`` array as it is, any other file
    (a video or an image) resized and cropped to the canvas, ``[F, H, W, 3]``
    in [0, 1]."""
    if path.endswith(".npy"):
        return np.load(path)
    from magcache_tpu_torch.pipelines.open_sora_cond import read_from_path

    w, h = pipe.config.size
    return (read_from_path(path, (h, w)) + 1.0) / 2.0


def _parse_size(size, default: str = "832*480"):
    w, h = (int(v) for v in (size or default).split("*"))
    return w, h


def _pipeline(args):
    """``(pipeline, sample steps, cache lanes)`` for ``--task``."""
    if not args.task.startswith(_KNOWN):
        raise SystemExit(
            f"--task {args.task!r} matches no model family; known prefixes: "
            f"{', '.join(_KNOWN)} (e.g. t2v-1.3B)")
    hunyuan = args.task in _HUNYUAN
    omnigen2 = args.task == _OMNIGEN2
    tasks = (*_PORTED, *_HUNYUAN, *_QWEN, _OMNIGEN2)
    if args.task not in tasks:
        raise SystemExit(f"--task {args.task!r} is no task of its family; tasks: "
                         f"{', '.join(tasks)}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run the plain ops)")
    if args.tiny and device.type == "cuda":
        raise SystemExit("--tiny: the toy models' head dims are not ones the "
                         "kernels take; pass --device cpu to run it on the plain ops")
    if args.ulysses_size:
        args.sp = args.ulysses_size
    if args.ring_size:
        args.sp = args.ring_size
    if args.sp > 1 and args.task != "t2v-1.3B":
        raise SystemExit(f"--sp: sequence parallelism is ported for t2v-1.3B "
                         f"only, not for {args.task!r}")
    wan = args.task in _WAN
    vace = args.task.startswith("vace")
    for flag, on, ok in (("--image", args.image is not None,
                          args.task in ("i2v-14B", "flf2v-14B", "i2v-A14B", "ti2v-5B")
                          or args.task.startswith("flux") or hunyuan
                          or args.task in _QWEN or omnigen2),
                         ("--src_video / --src_mask / --src_ref_images",
                          any(a is not None for a in (args.src_video, args.src_mask,
                                                      args.src_ref_images)), vace),
                         ("--first_frame / --last_frame",
                          args.first_frame is not None or args.last_frame is not None,
                          args.task == "flf2v-14B"),
                         ("--sample_solver", args.sample_solver != "unipc", wan),
                         ("--cache_policy", args.cache_policy != "adapter",
                          wan or args.task == "open-sora"),
                         ("--enable_teacache", args.enable_teacache,
                          wan or hunyuan or omnigen2),
                         ("--video_size / --video_length / --infer_steps / "
                          "--embedded_cfg_scale / --flow_shift / --cfg_scale",
                          any(a is not None for a in (
                              args.video_size, args.video_length, args.infer_steps,
                              args.embedded_cfg_scale, args.flow_shift,
                              args.cfg_scale)), hunyuan),
                         ("--negative_prompt", args.negative_prompt is not None,
                          hunyuan or omnigen2),
                         ("--instruction / --input_image_path / --output_image_path / "
                          "--height / --width / --num_inference_step / "
                          "--text_guidance_scale / --image_guidance_scale / "
                          "--cfg_range_start / --cfg_range_end / --scheduler / "
                          "--enable_taylorseer / --teacache_rel_l1_thresh",
                          args.enable_taylorseer or any(a is not None for a in (
                              args.instruction, args.input_image_path,
                              args.output_image_path, args.height, args.width,
                              args.num_inference_step, args.text_guidance_scale,
                              args.image_guidance_scale, args.cfg_range_start,
                              args.cfg_range_end, args.scheduler,
                              args.teacache_rel_l1_thresh)), omnigen2),
                         ("--mag_ratios_json", args.mag_ratios_json is not None,
                          not omnigen2),
                         ("--enable_pab", args.enable_pab,
                          args.task in ("open-sora", "latte", "open-sora-plan",
                                        "cogvideox", "vchitect")),
                         ("--use_dynamic_cfg", args.use_dynamic_cfg, args.task == "cogvideox"),
                         ("--osp_version", args.osp_version != "v120",
                          args.task == "open-sora-plan"),
                         ("--no_text_preprocessing", args.no_text_preprocessing,
                          args.task == "open-sora-plan"),
                         ("--route unpacked", args.route == "unpacked",
                          args.task == "open-sora-plan"),
                         ("--transformer_lora_path", args.transformer_lora_path is not None,
                          omnigen2 or args.task.startswith("flux")),
                         ("--model_path / --transformer_path", args.model_path is not None,
                          omnigen2),
                         ("--clip_ckpt", args.clip_ckpt is not None,
                          args.task in ("i2v-14B", "flf2v-14B")),
                         ("--t5_ckpt", args.t5_ckpt is not None,
                          wan or args.task.startswith("flux") or args.task in (
                              "open-sora", "latte", "open-sora-plan", "cogvideox",
                              "vchitect")),
                         ("--llm_ckpt", args.llm_ckpt is not None,
                          hunyuan or args.task in _QWEN or omnigen2),
                         ("--clip_text_ckpt", args.clip_text_ckpt is not None,
                          hunyuan or args.task.startswith("flux") or args.task == "vchitect"),
                         ("--clip_text_ckpt2", args.clip_text_ckpt2 is not None,
                          args.task == "vchitect")):
        if on and not ok:
            raise SystemExit(f"{flag} does not apply to --task {args.task!r}")
    ratios = None
    if args.mag_ratios_json:
        with open(args.mag_ratios_json) as f:
            ratios = tuple(json.load(f))
    if args.task == "open-sora":
        return _open_sora_pipeline(args, device, ratios)
    if args.task.startswith("flux"):
        return _flux_pipeline(args, device, ratios)
    if args.task == "latte":
        return _latte_pipeline(args, device, ratios)
    if args.task == "open-sora-plan":
        return _open_sora_plan_pipeline(args, device, ratios)
    if args.task == "cogvideox":
        return _cogvideox_pipeline(args, device, ratios)
    if args.task == "vchitect":
        return _vchitect_pipeline(args, device, ratios)
    if args.task in _QWEN:
        return _qwen_pipeline(args, device, ratios)
    if omnigen2:
        return _omnigen2_pipeline(args, device)
    if hunyuan:
        if args.negative_prompt is not None:
            print("WARNING: negative prompts need classifier-free guidance; the distilled "
                  "HunyuanVideo / FramePack path runs one forward a step "
                  "(magcache_sample_video.py:29-158): --neg_prompt is ignored.")
        if args.cfg_scale not in (None, 1.0):
            print("WARNING: --cfg_scale != 1.0 needs an undistilled HunyuanVideo; the "
                  "MagCache adapter and this port run the distilled single-forward path. "
                  "Use --embedded_cfg_scale to steer.")
        return _hunyuan_pipeline(args, device, ratios)
    return _wan_pipeline(args, device, ratios)


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(_normalize_argv(sys.argv[1:] if argv is None else argv, parser))
    args.save_file = args.save_file or args.save_path or args.output_image_path
    if args.instruction is not None and args.prompt == parser.get_default("prompt"):
        args.prompt = args.instruction
    t0 = time.time()
    pipe, steps, lanes = _pipeline(args)
    _attach_vae(args, pipe)
    kw = {}
    if args.task == "open-sora":
        kw = dict(loop=args.loop, ms=args.ms, refs=args.refs,
                  condition_frame_length=args.condition_frame_length,
                  condition_frame_edit=args.condition_frame_edit, align=args.align)
    elif args.task in _WAN:
        from magcache_tpu_torch.pipelines.flux import load_image

        first = args.first_frame or args.image
        kw = {k: load_image(path) for k, path in (("image", first),
                                                  ("last_image", args.last_frame)) if path}
        if args.src_video:
            kw["src_video"] = _load_frames(args.src_video, pipe)
        if args.src_mask:
            m = _load_frames(args.src_mask, pipe)
            kw["src_mask"] = m.mean(axis=-1) if m.ndim == 4 else m
        if args.src_ref_images:
            kw["src_ref_images"] = [load_image(p) for p in args.src_ref_images.split(",")]
    elif args.task in _HUNYUAN and args.image:
        from magcache_tpu_torch.pipelines.flux import image_to_grid_latent, load_image

        lat = image_to_grid_latent(None, load_image(args.image), *pipe.lat_shape[1:])
        kw = dict(start_latent=torch.from_numpy(np.ascontiguousarray(lat))[None])
    elif args.task in _QWEN:
        from magcache_tpu_torch.pipelines.flux import load_image

        if args.image:
            kw = dict(ref_latents=pipe.encode_image(load_image(args.image)))
        if pipe.ref_images == 0:
            # the text-to-image script's "positive magic" (the Edit one adds none)
            args.prompt += ", Ultra HD, 4K, cinematic composition."
    elif args.task == _OMNIGEN2:
        from magcache_tpu_torch.pipelines.flux import load_image

        refs = _omnigen2_refs(args)
        if refs:
            kw["ref_latents"] = pipe.encode_images([load_image(p) for p in refs])
        if args.negative_prompt is not None:
            kw["negative_prompt"] = args.negative_prompt
    elif args.image:
        from magcache_tpu_torch.pipelines.flux import load_image

        kw = dict(cond_latents=pipe.encode_image(load_image(args.image)))
    try:
        out = pipe.generate(args.prompt, seed=args.base_seed, **kw)
    except (NotImplementedError, ValueError) as e:
        raise SystemExit(str(e)) from e
    dt = time.time() - t0
    plan = getattr(pipe, "plan", None)
    if plan is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
        if plan.rank != 0:
            return             # every rank holds the whole output; rank 0 saves

    E = args.magcache_thresh if args.magcache_thresh is not None else "def"
    K = args.magcache_K if args.magcache_K is not None else "def"
    R = args.retention_ratio if args.retention_ratio is not None else "def"
    if args.enable_taylorseer:
        tag = "taylorseer"
    elif args.enable_teacache:
        T = args.teacache_thresh if args.teacache_thresh is not None else "def"
        tag = f"teacache_T{T}" + ("_ret" if args.use_ret_steps else "")
    elif args.use_magcache:
        tag = f"magcache_E{E}_K{K}_R{R}"
    else:
        tag = "pab" if args.enable_pab else "full"
    save_file = args.save_file or f"{args.task}_{tag}_seed{args.base_seed}"
    if out.calibration is not None:
        for name in ("norm_ratio", "norm_std", "cos_dis"):
            print(name)
            print(out.calibration[name])
        with open(save_file + "_mag_ratio.json", "w") as f:
            json.dump(out.calibration["norm_ratio"], f)
        print(f"saved calibration to {save_file}_mag_ratio.json")
    else:
        lat = out.latents.cpu().numpy()
        np.save(save_file + "_latents.npy", lat)
        print(f"latents {lat.shape} -> {save_file}_latents.npy")
        pixels = out.video if out.video is not None else out.image
        if pixels is not None:
            px = pixels.float().cpu().numpy()
            np.save(save_file + "_pixels.npy", px)
            print(f"pixels {px.shape} in [{px.min():.3f}, {px.max():.3f}], finite "
                  f"{bool(np.isfinite(px).all())} -> {save_file}_pixels.npy")
        if args.task in _HUNYUAN:
            # bits [sections, steps, 1], one forward a step
            print(f"skipped {int(out.skips.sum())} of {out.skips.size} forwards (one per "
                  f"step and section, embedded guidance); skipped steps by section "
                  f"{[np.flatnonzero(s[:, 0]).tolist() for s in out.skips]}")
        else:
            what = ("lane-forwards (cond + uncond per step)" if lanes == 2 else
                    "lane-forwards (cond, uncond, ref per step)" if lanes == 3 else
                    "forwards (one per step, embedded guidance)"
                    if args.task.startswith("flux") else
                    "forwards (cond + uncond as one joint batch per step)")
            print(f"skipped {int(out.skips.sum())} of {lanes * len(out.skips)} {what}; "
                  f"skipped steps {np.flatnonzero(out.skips.any(1)).tolist()}")
        if getattr(pipe, "core_low", None) is not None:
            b = pipe.boundary_step()
            print(f"experts: high-noise steps 0-{b - 1}, low-noise steps {b}-{steps - 1}")
    mode = ("taylorseer" if tag == "taylorseer" else "teacache" if args.enable_teacache
            else "magcache" if args.use_magcache else "full")
    if args.enable_pab:
        mode += "+pab"
    print(f"done: {steps} steps in {dt:.1f}s (sampling "
          f"{out.timings['total_s']:.1f}s) on {pipe.device} "
          f"mode={mode}")


if __name__ == "__main__":
    main()
