"""Where a Wan2.1-1.3B forward spends its device time, on one NVIDIA card.

    python tools/profile_torch_forward.py [--frames 81] [--top 15]

Builds WAN_1_3B (bf16, random seeded weights) from ``magcache_tpu_torch``,
runs one warm-up forward (prepare -> trunk -> head, 2 CFG lanes at 832x480)
and traces a second with ``torch.profiler``. Prints the wall time, the summed
device time, the device's idle share of the wall time, and the kernels with
the most device time. Needs a card: exits nonzero without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

import torch


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=81)
    p.add_argument("--top", type=int, default=15)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from magcache_tpu_torch.models.text import MockTextEncoder
    from magcache_tpu_torch.models.wan import WAN_1_3B, WanModel, make_wan_core

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(WAN_1_3B, dtype="bfloat16")
    model = WanModel(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    lat_f = (args.frames - 1) // 4 + 1
    grid = (lat_f, 30, 52)
    core = make_wan_core(model, grid)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((2, lat_f, 60, 104, 16), generator=g, device=dev)
    t = torch.full((2,), 900.0, device=dev)
    cond = {"context": MockTextEncoder(512, 4096, 0.5)(["a cat", ""], device=dev)}

    def forward():
        hidden, ctx = core.prepare(x, t, cond)
        return core.head(core.trunk(hidden, ctx), ctx)

    forward()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    print(f"{grid[0] * grid[1] * grid[2]} tokens x 2 lanes: wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:args.top]:
        ms = e.device_time_total / 1e3
        print(f"  {ms:9.2f} ms  {100 * ms / busy_ms:5.1f}%  x{e.count:<5d} {e.key[:90]}")


if __name__ == "__main__":
    main()
