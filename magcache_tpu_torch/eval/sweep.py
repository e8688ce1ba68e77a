"""Wan eval sweep: the reference's VBench prompt runner (counterpart of
``magcache_tpu.eval.sweep``).

Mirrors ``eval/magcache/experiments/Wan2.1_EVAL/wan_eval.sh`` and
``wan_magcache.py:1157-1180``: a slice of a prompt list
(``start_index``/``end_index``; the shell script splits 950 prompts over 8
GPUs), each prompt at a fixed seed, wall clock per video, outputs saved for
the golden PSNR / SSIM / LPIPS comparison (``eval.compare.compare_dirs``).
Outputs: ``<idx>[-loop].npy`` latents, ``manifest.jsonl`` and
``summary.json``.

``dp > 1`` runs ``dp`` prompts at a time through ``generate_batch`` on the
pipeline's one device, each element at the seed the manifest records;
``sp > 1`` goes to ``WanPipelineConfig(sp=)`` (one process per rank);
``tp > 1`` is not ported.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional

import numpy as np

from magcache_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

__all__ = ["DEFAULT_PROMPTS", "SweepConfig", "run_sweep", "load_prompts"]

# a small built-in prompt set (VBench-style subjects) for structural runs;
# real sweeps pass the 950-prompt VBench file
DEFAULT_PROMPTS = [
    "A stylish woman walks down a Tokyo street filled with warm glowing neon.",
    "A litter of golden retriever puppies playing in the snow.",
    "An astronaut riding a horse on the moon, cinematic lighting.",
    "Aerial view of a waterfall cascading through a lush rainforest.",
    "A chef flambeing a dessert in a busy restaurant kitchen.",
    "Timelapse of a city skyline transitioning from day to night.",
    "A sea turtle gliding over a coral reef in crystal clear water.",
    "Macro shot of a bee collecting pollen from a sunflower.",
]


def load_prompts(path: Optional[str]) -> List[str]:
    """Plain text (one prompt a line) or the VBench JSON list the reference
    eval reads (``[{"prompt_en": ...}, ...]``, experiments/utils.py:17-21)."""
    if path is None:
        return list(DEFAULT_PROMPTS)
    with open(path) as f:
        text = f.read()
    if text.lstrip().startswith("["):
        # a VBench JSON list, unless a text file's first prompt starts with '['
        try:
            items = json.loads(text)
        except json.JSONDecodeError:
            items = None
        if isinstance(items, list):
            out = []
            for it in items:
                if isinstance(it, dict):
                    if "prompt_en" not in it:
                        raise KeyError(f"VBench prompt entry missing 'prompt_en': "
                                       f"{sorted(it)[:8]}")
                    out.append(it["prompt_en"])
                else:
                    out.append(str(it))
            return out
    return [ln.strip() for ln in text.splitlines() if ln.strip()]


@dataclasses.dataclass
class SweepConfig:
    variant: str = "magcache"            # full | magcache | teacache | rolling
    prompts_file: Optional[str] = None
    start_index: int = 0
    end_index: Optional[int] = None      # exclusive; None = all
    out_dir: str = "sweep_out"
    base_seed: int = 0
    # videos per prompt: the VBench protocol makes 5 with seed = loop index
    # (experiments/utils.py:9-14); 1 keeps the fixed per-prompt seed
    loop: int = 1
    # pipeline knobs (WanPipelineConfig's)
    model: str = "wan2.1-t2v-1.3B"
    size: tuple = (832, 480)
    frame_num: int = 81
    sample_steps: int = 50
    sample_solver: str = "unipc"
    magcache_thresh: Optional[float] = None
    magcache_K: Optional[int] = None
    retention_ratio: Optional[float] = None
    teacache_thresh: float = 0.2         # the teacache variant (wan_teacache.py)
    use_ret_steps: bool = False
    dp: int = 1
    sp: int = 1
    tp: int = 1
    dtype: str = "bfloat16"
    ckpt_dir: Optional[str] = None
    tiny: bool = False
    decode: bool = False                 # save decoded video when a VAE exists


def sweep_pipeline_config(cfg: SweepConfig):
    """The ``WanPipelineConfig`` of a sweep (``run_sweep`` builds its
    pipeline from it when given none)."""
    from magcache_tpu_torch.pipelines.wan import WanPipelineConfig

    if cfg.tp > 1:
        raise NotImplementedError("tp > 1: the tensor-parallel axis is not ported "
                                  "(ROADMAP section 1, item 7)")
    return WanPipelineConfig(
        model=cfg.model, size=tuple(cfg.size), frame_num=cfg.frame_num,
        sample_steps=cfg.sample_steps, sample_solver=cfg.sample_solver,
        use_magcache=cfg.variant in ("magcache", "rolling"),
        cache_policy="rolling" if cfg.variant == "rolling" else "adapter",
        enable_teacache=cfg.variant == "teacache",
        teacache_thresh=cfg.teacache_thresh, use_ret_steps=cfg.use_ret_steps,
        magcache_thresh=cfg.magcache_thresh, magcache_K=cfg.magcache_K,
        retention_ratio=cfg.retention_ratio, dtype=cfg.dtype, sp=cfg.sp,
        ckpt_dir=cfg.ckpt_dir, tiny=cfg.tiny)


def run_sweep(cfg: SweepConfig, pipeline=None, device="cuda") -> dict:
    """Run the prompt slice and write ``<out>/<idx>[-loop].npy`` and
    ``manifest.jsonl``; returns the summary (also ``summary.json``).
    Without ``pipeline`` it builds the ``WanPipeline`` ``cfg`` names on
    ``device`` (under ``sp > 1`` pass each rank's pipeline)."""
    prompts = load_prompts(cfg.prompts_file)
    end = len(prompts) if cfg.end_index is None else min(cfg.end_index, len(prompts))
    sl = list(range(cfg.start_index, end))
    if not sl:
        raise ValueError(f"empty prompt slice [{cfg.start_index}, {end})")
    if pipeline is None:
        from magcache_tpu_torch.pipelines.wan import WanPipeline

        pipeline = WanPipeline(sweep_pipeline_config(cfg), device)

    os.makedirs(cfg.out_dir, exist_ok=True)
    times: List[float] = []
    t_all = time.time()
    batch = max(1, cfg.dp)
    with open(os.path.join(cfg.out_dir, "manifest.jsonl"), "w") as mf:
        for lp in range(max(1, cfg.loop)):
            for b0 in range(0, len(sl), batch):
                ids = sl[b0:b0 + batch]
                # loop mode: seed = loop index (the VBench protocol); explicit
                # per-element seeds, so a batch draws what the manifest says
                seeds = [lp if cfg.loop > 1 else cfg.base_seed + i for i in ids]
                t0 = time.time()
                if batch > 1 and len(ids) == batch:
                    out = pipeline.generate_batch([prompts[i] for i in ids], seeds=seeds)
                    arrs = out.latents.float().cpu().numpy()
                else:
                    arrs = np.concatenate(
                        [pipeline.generate(prompts[i], seed=s).latents.float().cpu().numpy()
                         for i, s in zip(ids, seeds)], 0)
                dt = (time.time() - t0) / len(ids)
                tag = f"-{lp}" if cfg.loop > 1 else ""
                for j, i in enumerate(ids):
                    arr = arrs[j]
                    if cfg.decode and pipeline.vae is not None:
                        import torch

                        lat = torch.from_numpy(arr[None]).to(pipeline.device)
                        arr = pipeline.vae.decode(lat)[0].float().cpu().numpy()
                    np.save(os.path.join(cfg.out_dir, f"{i:05d}{tag}.npy"), arr)
                    times.append(dt)
                    mf.write(json.dumps({
                        "index": i, "prompt": prompts[i], "loop": lp,
                        "seed": seeds[j], "sec_per_video": round(dt, 3),
                        "variant": cfg.variant,
                    }) + "\n")
                logger.info("sweep [%d..%d] loop %d: %.2fs/video", ids[0], ids[-1], lp, dt)

    summary = {
        "variant": cfg.variant,
        "count": len(sl),
        "sec_per_video_mean": float(np.mean(times)),
        "sec_total": round(time.time() - t_all, 2),
        "config": {k: (list(v) if isinstance(v, tuple) else v)
                   for k, v in dataclasses.asdict(cfg).items()},
    }
    with open(os.path.join(cfg.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary
