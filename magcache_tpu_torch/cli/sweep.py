"""``python -m magcache_tpu_torch.cli.sweep``: the ``wan_eval.sh`` sweep.

  # full-compute goldens for prompts [0, 100), then MagCache and compare
  python -m magcache_tpu_torch.cli.sweep --variant full --end_index 100 \\
      --out_dir out/full
  python -m magcache_tpu_torch.cli.sweep --variant magcache --end_index 100 \\
      --out_dir out/magcache --compare_to out/full

``--tiny --device cpu`` runs the toy model on the CPU; the default is the
card at full width (random weights).
"""

from __future__ import annotations

import argparse
import os
import json


def build_parser():
    p = argparse.ArgumentParser("magcache_tpu_torch sweep")
    p.add_argument("--variant", default="magcache",
                   choices=["full", "magcache", "teacache", "rolling"])
    p.add_argument("--teacache_thresh", type=float, default=0.2)
    p.add_argument("--use_ret_steps", action="store_true")
    p.add_argument("--prompts", default=None,
                   help="txt file (one prompt a line) or a VBench JSON list with "
                        "prompt_en fields")
    p.add_argument("--loop", type=int, default=1,
                   help="videos per prompt; the VBench protocol uses 5 with seed = "
                        "loop index (experiments/utils.py:9-14)")
    p.add_argument("--start_index", type=int, default=0)
    p.add_argument("--end_index", type=int, default=None)
    p.add_argument("--out_dir", default="sweep_out")
    p.add_argument("--base_seed", type=int, default=0)
    p.add_argument("--model", default="wan2.1-t2v-1.3B")
    p.add_argument("--size", default="832*480")
    p.add_argument("--frame_num", type=int, default=81)
    p.add_argument("--sample_steps", type=int, default=50)
    p.add_argument("--sample_solver", default="unipc")
    p.add_argument("--magcache_thresh", type=float, default=None)
    p.add_argument("--magcache_K", type=int, default=None)
    p.add_argument("--retention_ratio", type=float, default=None)
    p.add_argument("--dp", type=int, default=1,
                   help="prompts batched through generate_batch: on the one device, or "
                        "one a dp rank under torchrun")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel ranks (one process each, under torchrun)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks (one process each, under torchrun)")
    p.add_argument("--dist_init_method", default=None,
                   help="process-group rendezvous (tcp://host:port or file:///path) "
                        "when not started by torchrun; RANK and WORLD_SIZE are read "
                        "from the environment")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) needs a card")
    p.add_argument("--compare_to", default=None,
                   help="golden dir: PSNR / SSIM against it after the sweep")
    p.add_argument("--lpips_weights", default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from magcache_tpu_torch.eval.sweep import SweepConfig, run_sweep

    on_card = torch.device(args.device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run the plain ops)")
    if on_card and args.tiny:
        raise SystemExit("--tiny: the toy model's head dims are not ones the "
                         "kernels take; pass --device cpu to run it on the plain ops")
    w, h = (int(v) for v in args.size.split("*"))
    if args.tiny:
        w, h, args.frame_num = 64, 32, 9
    cfg = SweepConfig(
        variant=args.variant, prompts_file=args.prompts,
        start_index=args.start_index, end_index=args.end_index,
        out_dir=args.out_dir, base_seed=args.base_seed, model=args.model,
        size=(w, h), frame_num=args.frame_num, sample_steps=args.sample_steps,
        sample_solver=args.sample_solver, magcache_thresh=args.magcache_thresh,
        magcache_K=args.magcache_K, retention_ratio=args.retention_ratio,
        teacache_thresh=args.teacache_thresh, use_ret_steps=args.use_ret_steps,
        dp=args.dp, sp=args.sp, tp=args.tp, dtype=args.dtype,
        ckpt_dir=args.ckpt_dir, tiny=args.tiny, loop=args.loop)
    # sp and tp need one process a rank; dp rides the ranks when torchrun
    # started them, else it is the batch on the one device
    plan, device = None, torch.device(args.device)
    if args.sp * args.tp > 1 or (args.dp > 1 and "RANK" in os.environ):
        from magcache_tpu_torch.cli.generate import mesh_plan

        plan, device = mesh_plan(args, device, "magcache_tpu_torch.cli.sweep")
    summary = run_sweep(cfg, device=device, plan=plan)
    if plan is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
        if plan.world_rank != 0:
            return summary

    if args.compare_to:
        from magcache_tpu_torch.eval.compare import compare_dirs, write_report

        metrics = ["psnr", "ssim"]
        if args.lpips_weights:
            from magcache_tpu_torch.eval.metrics import load_lpips_weights

            load_lpips_weights(args.lpips_weights, device=args.device)
            metrics.append("lpips")
        cmp = compare_dirs(args.out_dir, args.compare_to, metrics=metrics,
                           device=args.device)
        summary["vs_golden"] = cmp["mean"]
        write_report(cmp, f"{args.out_dir}/report.txt")
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
