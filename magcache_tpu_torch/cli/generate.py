"""Generation CLI, the Wan t2v subset of ``magcache_tpu.cli.generate``.

Flag names follow the reference adapters (``--task --size --frame_num
--sample_steps --sample_shift --sample_solver --sample_guide_scale
--base_seed --use_magcache --magcache_thresh --magcache_K --retention_ratio
--magcache_calibration``), and the output file name encodes the E/K/R
triple. Runs on a CUDA card by default; ``--device cpu`` runs the plain
PyTorch ops instead of the kernels (tests use it at ``--tiny`` size).

Examples:
  python -m magcache_tpu_torch.cli.generate --task t2v-1.3B --size 832*480 \
      --sample_steps 50 --use_magcache --magcache_thresh 0.12 --magcache_K 2
  python -m magcache_tpu_torch.cli.generate --task t2v-1.3B --magcache_calibration
Checkpoints are not loaded yet: the DiT has random weights and the text
encoder is the hash-seeded mock, so the output is latents, not a video.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

# task families of the JAX CLI; only t2v-1.3B is ported
_KNOWN = ("flux", "qwen", "hunyuan", "framepack", "open-sora", "cogvideox",
          "latte", "vchitect", "omnigen2", "t2v", "t2i", "i2v", "flf2v",
          "ti2v", "vace")
_PORTED = {"t2v-1.3B": "wan2.1-t2v-1.3B"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("magcache_tpu_torch generate")
    p.add_argument("--task", default="t2v-1.3B",
                   help="t2v-1.3B (the only task ported so far)")
    p.add_argument("--size", default="832*480", help="W*H pixels")
    p.add_argument("--frame_num", type=int, default=81)
    p.add_argument("--sample_steps", type=int, default=50)
    p.add_argument("--sample_shift", type=float, default=5.0)
    p.add_argument("--sample_solver", default="unipc", choices=["unipc"])
    p.add_argument("--sample_guide_scale", type=float, default=5.0)
    p.add_argument("--base_seed", type=int, default=0)
    p.add_argument("--prompt", default="Two anthropomorphic cats in comfy "
                   "boxing gear and bright gloves fight intensely on a "
                   "spotlighted stage.")
    p.add_argument("--save_file", default=None)
    p.add_argument("--use_magcache", action="store_true")
    p.add_argument("--magcache_thresh", type=float, default=None)
    p.add_argument("--magcache_K", type=int, default=None)
    p.add_argument("--retention_ratio", type=float, default=None)
    p.add_argument("--magcache_calibration", action="store_true")
    p.add_argument("--mag_ratios_json", default=None,
                   help="path to a calibration-mode *_mag_ratio.json; its "
                        "ratios replace the preset's published array")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--tiny", action="store_true",
                   help="toy-size model for smoke runs")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) needs a card")
    return p


def _pipeline(args):
    from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

    if not args.task.startswith(_KNOWN):
        raise SystemExit(
            f"--task {args.task!r} matches no model family; known prefixes: "
            f"{', '.join(_KNOWN)} (e.g. t2v-1.3B)")
    if args.task not in _PORTED:
        raise SystemExit(f"--task {args.task!r} is not ported yet; ported: "
                         f"{', '.join(_PORTED)}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run the plain ops)")
    w, h = (int(v) for v in args.size.split("*"))
    frame_num = args.frame_num
    if args.tiny:
        w, h, frame_num = 64, 32, 9
    ratios = None
    if args.mag_ratios_json:
        with open(args.mag_ratios_json) as f:
            ratios = tuple(json.load(f))
    cfg = WanPipelineConfig(
        model=_PORTED[args.task], task="t2v", size=(w, h), frame_num=frame_num,
        sample_steps=args.sample_steps, sample_shift=args.sample_shift,
        sample_solver=args.sample_solver, guide_scale=args.sample_guide_scale,
        use_magcache=args.use_magcache, magcache_thresh=args.magcache_thresh,
        magcache_K=args.magcache_K, retention_ratio=args.retention_ratio,
        magcache_calibration=args.magcache_calibration,
        mag_ratios_override=ratios, dtype=args.dtype, tiny=args.tiny)
    return WanPipeline(cfg, device)


def main(argv=None):
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    t0 = time.time()
    pipe = _pipeline(args)
    out = pipe.generate(args.prompt, seed=args.base_seed)
    dt = time.time() - t0

    E = args.magcache_thresh if args.magcache_thresh is not None else "def"
    K = args.magcache_K if args.magcache_K is not None else "def"
    R = args.retention_ratio if args.retention_ratio is not None else "def"
    tag = f"magcache_E{E}_K{K}_R{R}" if args.use_magcache else "full"
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
        print(f"skipped {int(out.skips.sum())} of {2 * args.sample_steps} "
              "lane-forwards (cond + uncond per step)")
    print(f"done: {args.sample_steps} steps in {dt:.1f}s (sampling "
          f"{out.timings['total_s']:.1f}s) on {pipe.device} "
          f"mode={'magcache' if args.use_magcache else 'full'}")


if __name__ == "__main__":
    main()
