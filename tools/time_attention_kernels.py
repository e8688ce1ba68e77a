"""Times the wgmma/TMA attention body at the shapes its paths run, on one card.

    python tools/time_attention_kernels.py [--reps 5]

Builds the kernel library from this checkout, prints ptxas's report on the
body (``hopper::hopper_attention_kernel``: registers, spills, any "wgmma
... serialized" warning) and the number of HGMMA instructions in each of
its instantiations (``cuobjdump -sass``), then the CUDA-event time of one
call at each shape: K1 at Wan2.1-1.3B's self (fixed and running max) and
cross shapes, K1b at the Ulysses sp = 4 self shape, K1c at the ring step,
K1 at FLUX.1's joint shape and at Latte-1's padded spatial and cross
shapes, and K5r at Latte-1's spatial shape and at groups of 1,590 with
1,400 valid keys. The last line is the times as JSON. Needs a card: exits
nonzero without one. Compare two versions of the body only within one
machine's run, in turns.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_report(lib_dir: str, bodies=("hopper_attention_kernel",)) -> dict:
    """ptxas's lines on the kernels whose names contain one of ``bodies``
    (registers, spills) and any "wgmma ... serialized" line, then the HGMMA
    count of each such kernel, which it also returns."""
    so = sorted(glob.glob(os.path.join(lib_dir, "*.so")), key=os.path.getmtime)[-1]
    lines = open(so + ".log").read().splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line and any(b in line for b in bodies):
            print(line.split("for ")[-1], "|", lines[i + 1].strip(), "|", lines[i + 2].strip())
        if any(code in line for code in ("C7508", "C7512", "C7520")):
            print(line.strip())
    sass = subprocess.run(["cuobjdump", "-sass", so], capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
        elif "HGMMA" in line and name and any(b in name for b in bodies):
            counts[name] = counts.get(name, 0) + 1
    print("HGMMA instructions:", counts)
    return counts


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import torch.nn.functional as F

    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops.build import BUILD_DIR, load_cuda_library

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    load_cuda_library()
    build_report(BUILD_DIR)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    reps, short = args.reps, 4 * args.reps
    times = {}
    q, k, v = (rnd(2, 32760, 12, 128) for _ in range(3))
    ck, cv = rnd(2, 512, 12, 128), rnd(2, 512, 12, 128)
    times["K1 Wan self, fixed max"] = cuda_ms(
        lambda: A.flash_attention_bshd(q, k, v, fixed_max=16.0), reps)
    times["K1 Wan self, running max"] = cuda_ms(lambda: A.flash_attention_bshd(q, k, v), reps)
    times["K1 Wan cross, 512 keys"] = cuda_ms(
        lambda: A.flash_attention_bshd(q, ck, cv, fixed_max=16.0), short)
    qh = q[:, :, :3].transpose(1, 2)               # the Ulysses view at sp = 4
    times["K1b Ulysses self, sp 4"] = cuda_ms(
        lambda: A.flash_attention_bhsd(qh, qh, qh, fixed_max=16.0), reps)
    qr = q[:, :8190].transpose(1, 2)
    times["K1c ring step, sp 4"] = cuda_ms(lambda: A.flash_attention_bhsd_aux(qr, qr, qr),
                                           2 * reps)
    del q, k, v, ck, cv, qh, qr
    f = rnd(1, 4608, 24, 128)
    times["K1 FLUX joint"] = cuda_ms(lambda: A.flash_attention_bshd(f, f, f, fixed_max=16.0),
                                     short)
    sp = F.pad(rnd(32, 1024, 16, 72), (0, 56))
    times["K1 Latte spatial, 72 -> 128"] = cuda_ms(
        lambda: A.flash_attention_bshd(sp, sp, sp, scale=72 ** -0.5), short)
    xq, xk = F.pad(rnd(2, 16384, 16, 72), (0, 56)), F.pad(rnd(2, 120, 16, 72), (0, 56))
    times["K1 Latte cross, 72 -> 128"] = cuda_ms(
        lambda: A.flash_attention_bshd(xq, xk, xk, scale=72 ** -0.5), short)
    qkv = rnd(32, 1024, 3 * 16 * 72)
    times["K5r Latte spatial"] = cuda_ms(lambda: A.grouped_attention_fused_qkv(
        qkv, 16, group=1024, scale=72 ** -0.5), short)
    qkv = rnd(8, 1590, 3 * 16 * 72)
    times["K5r group 1590, 1400 valid"] = cuda_ms(lambda: A.grouped_attention_fused_qkv(
        qkv, 16, group=1590, group_valid=1400, scale=72 ** -0.5), short)
    for name, ms in times.items():
        print(f"{name}: {ms:.4f} ms")
    print(json.dumps({k: round(ms, 4) for k, ms in times.items()}))


if __name__ == "__main__":
    main()
