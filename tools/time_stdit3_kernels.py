"""Times K7 (lnmod_matmul) and K6 (fused_cross_attention) at the shapes their
paths run, on one card, against another checkout's kernels in turns.

    python tools/time_stdit3_kernels.py [--parent DIR] [--reps 10]

Builds the kernel library from this checkout and prints ptxas's report on
the Hopper bodies K7 and K6 run on (``hopper_gemm_kernel``,
``hopper_cross_kernel``, ``ln_modulate_kernel``: registers, spills, any
"wgmma ... serialized" line) and the HGMMA count of each (``cuobjdump
-sass``). Then, at STDiT3-XL/2's 480p and 720p shapes and Latte-1's, the
CUDA-event time of one call of each kernel; K6 also split by stage (q
projection, attention, out-projection), and K7 beside cuBLAS ``F.linear``
on the already-modulated input (GEMM only, not the same function). With
``--parent DIR`` (an unpacked ``git archive`` of another commit, e.g. the
parent), that checkout's library is built too and its ``mc_lnmod_matmul``
and ``mc_fused_cross_attention`` are timed on the same inputs in turns
(parent, this, this, parent), each output held against this checkout's.
The last line is the times as JSON. Needs a card: exits nonzero without
one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.time_attention_kernels import build_report, cuda_ms  # noqa: E402

BODIES = ("hopper_gemm_kernel", "hopper_cross_kernel", "ln_modulate_kernel")


def load_parent(path: str):
    """The other checkout's kernel library, built from its own sources."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", os.path.join(path, "magcache_tpu_torch", "ops", "build.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load_cuda_library()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", default=None)
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    import torch.nn.functional as F

    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import fused_prologue as P
    from magcache_tpu_torch.ops.build import BUILD_DIR, load_cuda_library
    from magcache_tpu_torch.ops.gemm import gemm_launch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    load_cuda_library()
    hgmma = build_report(BUILD_DIR, BODIES)
    parent = load_parent(args.parent) if args.parent else None
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    reps, d, H = args.reps, 1152, 16
    times, errs = {}, {}

    def in_turns(label, new, old, flops):
        """(parent, this, this, parent) when there is a parent."""
        if old is None:
            t = {"ms": cuda_ms(new, reps)}
        else:
            o1, n1, n2, o2 = (cuda_ms(f, reps) for f in (old, new, new, old))
            t = {"ms": min(n1, n2), "ms_runs": [n1, n2], "parent_ms": min(o1, o2),
                 "parent_runs": [o1, o2]}
        t["tflops"] = flops / t["ms"] / 1e9
        times[label] = t
        print(f"{label}: {json.dumps(t)}")

    # K7: qkv (per-frame view, batch_repeat T) and mlp1 + gelu
    for tag, rows, T, S in (("480p", 2, 15, 1590), ("720p", 2, 15, 3600),
                            ("Latte", 2, 16, 1024)):
        h = rnd(rows, T * S, d)
        sc = rnd(rows, d, dtype=torch.float32, scale=0.1)
        sh = rnd(rows, d, dtype=torch.float32, scale=0.1)
        for kind, x, w, b, kw in (
                ("qkv", h.reshape(rows * T, S, d), rnd(3 * d, d, scale=d ** -0.5),
                 rnd(3 * d, scale=0.1), dict(batch_repeat=T)),
                ("mlp1", h, rnd(4 * d, d, scale=d ** -0.5), rnd(4 * d, scale=0.1),
                 dict(act="gelu"))):
            label = f"K7 {tag} {kind} {tuple(x.shape)} -> {w.shape[0]}"
            new = lambda: P.lnmod_matmul(x, sc, sh, w, b, **kw)
            old = None
            if parent is not None:
                rep = kw.get("batch_repeat", 1)
                a32 = (1.0 + sc.float()).contiguous()
                b32 = b.float().contiguous()
                out = torch.empty(x.shape[0], x.shape[1], w.shape[0], dtype=x.dtype, device=dev)

                def old():
                    code = parent.mc_lnmod_matmul(
                        x.data_ptr(), a32.data_ptr(), sh.data_ptr(), w.data_ptr(),
                        b32.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], x.shape[1],
                        d, w.shape[0], rep, 1e-6, int(kw.get("act") == "gelu"), stream())
                    assert code == 0, code
                    return out
                errs[label] = float((new().float() - old().float()).abs().max())
            in_turns(label, new, old, 2 * x.shape[0] * x.shape[1] * d * w.shape[0])
            y = P.lnmod_operand_plain(x, sc, sh, batch_repeat=kw.get("batch_repeat", 1),
                                      dtype=w.dtype)
            times[label]["cublas_gemm_only_ms"] = cuda_ms(lambda: F.linear(y, w, b), reps)
            del y
        del h

    # K6: cross-attention over the caption, residual fused; and its stages
    for tag, rows, N, L in (("480p", 2, 23850, 300), ("720p", 2, 54000, 300),
                            ("Latte", 2, 16384, 120)):
        h = rnd(rows, N, d)
        wq, wo = rnd(d, d, scale=d ** -0.5), rnd(d, d, scale=d ** -0.5)
        bq, bo = rnd(d, scale=0.05), rnd(d, scale=0.05)
        k, v = rnd(rows, L, d), rnd(rows, L, d)
        scale = 72 ** -0.5
        label = f"K6 {tag} {rows}x{N} x {L} keys"
        new = lambda: A.fused_cross_attention(h, wq, bq, k, v, wo, bo, H, scale=scale,
                                              residual=True)
        old = None
        if parent is not None:
            bq32, bo32 = bq.float().contiguous(), bo.float().contiguous()
            out = torch.empty_like(h)

            def old():
                code = parent.mc_fused_cross_attention(
                    h.data_ptr(), wq.data_ptr(), bq32.data_ptr(), k.data_ptr(), v.data_ptr(),
                    wo.data_ptr(), bo32.data_ptr(), out.data_ptr(), rows, N, d, d, d, H, L,
                    L, scale * math.log2(math.e), 1, stream())
                assert code == 0, code
                return out
            errs[label] = float((new().float() - old().float()).abs().max())
        in_turns(label, new, old, 4 * rows * N * d * d + 4 * rows * N * L * d)
        b32 = bq.float().contiguous()
        q = gemm_launch("q", h, wq, b32)
        o = A._cross_attention_launch(q, k, v, H, scale, L)
        times[label]["stages_ms"] = {
            "q projection": cuda_ms(lambda: gemm_launch("q", h, wq, b32), reps),
            "attention": cuda_ms(lambda: A._cross_attention_launch(q, k, v, H, scale, L), reps),
            "out-projection + residual": cuda_ms(
                lambda: gemm_launch("o", o, wo, b32, epilogue="resid", resid=h), reps)}
        print(f"  stages: {json.dumps(times[label]['stages_ms'])}")
        del h, q, o
    if errs:
        print("max |this - parent| per shape:", json.dumps(errs))
    print(json.dumps({"device": torch.cuda.get_device_name(0), "hgmma": hgmma,
                      "times": times, "max_abs_vs_parent": errs}))


if __name__ == "__main__":
    main()
