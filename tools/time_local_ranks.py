"""Times Wan2.1 T2V-1.3B MagCache requests at 832x480x17 (20 UniPC steps,
E012K2R02) under ``--sp`` local ranks on one card, with two schedulings of
the ranks, in turns (barrier, turns, turns, barrier) within one process:

- "turns": ``parallel.mesh.run_local_ranks``, the ranks taking turns
  between collectives;
- "barrier": the ranks as threads that run at once and meet at a barrier
  at every collective (the port's scheduling before the ranks took turns,
  kept here as the yardstick).

    python tools/time_local_ranks.py [--sp 4] [--impls ulysses,ring]

Prints the card's name and power limit, then for each attention strategy
the wall seconds of each request (host clock up to
``torch.cuda.synchronize()``; the ranks share one card, so these are no
times of a run on several GPUs) and its latents' rel L2 against the
single-rank request. Random weights from a seeded generator on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import threading
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from magcache_tpu_torch.models.wan import WAN_1_3B, WanModel  # noqa: E402
from magcache_tpu_torch.parallel import mesh  # noqa: E402
from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig  # noqa: E402

PROMPT = "Two anthropomorphic cats fight on a stage."


def barrier_ranks(sp: int, fn, *, device, timeout: float = mesh.LOCAL_TIMEOUT_S) -> list:
    """``fn(plan)`` on ``sp`` threads that run at once, each collective a
    write of the rank's slot between two waits at one barrier."""
    barrier = threading.Barrier(sp)
    slots: list = [None] * sp

    class Group(mesh.Group):
        def __init__(self, rank):
            self.rank, self.size = rank, sp

        def _exchange(self, x):
            slots[self.rank] = x
            barrier.wait(timeout)
            got = list(slots)
            barrier.wait(timeout)
            return got

    results: list = [None] * sp
    errors: list = [None] * sp

    def worker(rank):
        try:
            torch.cuda.set_device(device)
            results[rank] = fn(mesh.MeshPlan(Group(rank)))
        except BaseException as e:          # noqa: BLE001 - raised below
            errors[rank] = e
            barrier.abort()

    threads = [threading.Thread(target=worker, args=(r,), daemon=True) for r in range(sp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None and not isinstance(e, threading.BrokenBarrierError):
            raise e
    if any(e is not None for e in errors):
        raise TimeoutError("a rank waited past the barrier's timeout")
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sp", type=int, default=4)
    p.add_argument("--impls", default="ulysses,ring")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_local_ranks.py needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(WAN_1_3B, dtype="bfloat16")
    model = WanModel(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False)
    base = dict(size=(832, 480), frame_num=17, sample_steps=20, sample_shift=5.0,
                guide_scale=5.0, use_magcache=True)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0

    one = WanPipeline(WanPipelineConfig(**base), dev, model=model)
    one.generate(PROMPT, seed=3)                                  # warm-up
    want, secs = timed(lambda: one.generate(PROMPT, seed=3))
    print(f"one rank: {secs:.3f} s", flush=True)
    runners = {"barrier": lambda sp, fn: barrier_ranks(sp, fn, device=dev),
               "turns": lambda sp, fn: mesh.run_local_ranks(sp, fn, device=dev)}
    for impl in args.impls.split(","):
        pcfg = WanPipelineConfig(sp=args.sp, sp_impl=impl, **base)

        def rank(plan):
            return WanPipeline(pcfg, dev, model=model, plan=plan).generate(PROMPT, seed=3)

        for name in ("barrier", "turns", "turns", "barrier"):
            outs, secs = timed(lambda: runners[name](args.sp, rank))
            lat = outs[0].latents.float()
            rel = float((lat - want.latents.float()).norm() / want.latents.float().norm())
            print(f"sp {args.sp} {impl}, {name}: {secs:.3f} s wall, rel L2 against one "
                  f"rank {rel:.3e}", flush=True)


if __name__ == "__main__":
    main()
