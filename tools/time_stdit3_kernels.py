"""Times K5 (grouped_attention_fused_qkv, with K5r and K4), K1q
(flash_attention_bshd with qk_gains), K8 (matmul_gated_residual), K7
(lnmod_matmul), K6 (fused_cross_attention) and K9 (tiny_temporal_attention)
at the shapes their paths run, on one card, K5, K1q, K8 and K9 against
another checkout's kernels in turns.

    python tools/time_stdit3_kernels.py [--parent DIR] [--reps 10] [--only k5,k1q,k8,k7,k6,k9]

Builds the kernel library from this checkout and prints ptxas's report on
the Hopper bodies these kernels run on (``hopper_gemm_kernel`` with every
epilogue, ``hopper_attention_kernel`` with every instantiation,
``hopper_cross_kernel``, ``layer_norm_kernel`` (K7's operand pass, in
``prologue.cu``), ``qk_norm_kernel``, ``grouped_stream_kernel``,
``tiny_stream_kernel``, ``tiny_attention_kernel``:
registers, spills, any "wgmma ... serialized" line) and the HGMMA count of
each (``cuobjdump -sass``). Then, at
STDiT3-XL/2's 480p and 720p shapes and Latte-1's, the CUDA-event time of one
call of each kernel: K5 spatial (one group a frame, gains, fixed max) also
split into its pre-pass and its attention, K5 temporal (groups of 15,
gains and RoPE), K5r and K4 at Latte's temporal shape (groups of 16, no
norm, row max), each beside SDPA on the same q/k/v (without the norm where
K5 has one: not the same function) and with its rate in TB/s; K1q also
split into its pre-pass and its attention, beside SDPA without the norm;
K8 beside cuBLAS ``F.linear`` with bias (GEMM only, not the same
function), and the temporal projection also in the 3-D row geometry
(tiles of 128 rows inside each batch row of T rows) in place of the
flattened rows; K7 beside cuBLAS on the already-modulated input; K6 split
by stage. With ``--parent DIR`` (an unpacked ``git archive`` of another
commit, e.g. the parent), that checkout's library is built from its own
sources and its K5, K1q and K8 entries are timed on the same inputs in
turns (parent, this, this, parent), each called with its own C signature
(K5: the mma.sync entry ``mc_grouped_attention``, or, for a checkout
with this one's entries, its library behind this checkout's wrappers; K1q: ``mc_qk_prepass``,
``mc_qk_norm`` or the mma.sync ``mc_flash_attention_qknorm``; K8:
``mc_matmul_gated_residual`` in either form), each output held against
this checkout's. For the groups of up to 16 tokens the parent's
``grouped_small_kernel`` is also built with its grid transposed (heads in
``blockIdx.x``, a copy of its package under ``build/transposed``) and
timed in the same turns (parent, transposed, this, this, transposed,
parent). K9 runs at Latte's temporal shape (2,048 groups of 16 frames, no
norm) and STDiT3 480p's (3,180 groups of 15, gains and RoPE) on the route
``tiny_kernel_route`` picks, in turns against the other checkout's
``mc_tiny_attention`` (the general kernel, the same C signature in both;
for a checkout with this one's entries, its library behind this
checkout's wrappers),
with its rate in TB/s, this checkout's general kernel and SDPA on the same
q/k/v (without the norm where K9 has one: not the same function) beside
it. The last line is the times as JSON. Needs a card: exits nonzero
without one.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.time_attention_kernels import build_report, cuda_ms  # noqa: E402

BODIES = ("hopper_gemm_kernel", "hopper_attention_kernel", "hopper_cross_kernel",
          "layer_norm_kernel", "qk_norm_kernel", "grouped_stream_kernel",
          "tiny_stream_kernel", "tiny_attention_kernel")
# the parent's mma.sync small-group kernel with its grid transposed (heads
# in blockIdx.x): the diagnostic that splits its loss between locality and
# latency
TRANSPOSE = (("const int grp = blockIdx.x * kWarps + warp;\n  const int h = blockIdx.y;",
              "const int grp = blockIdx.y * kWarps + warp;\n  const int h = blockIdx.x;"),
             ("const dim3 grid((n_groups + kWarps - 1) / kWarps, H);",
              "const dim3 grid(H, (n_groups + kWarps - 1) / kWarps);"))
LOG2E = math.log2(math.e)


def load_parent(path: str):
    """The other checkout's kernel library, built from its own sources."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", os.path.join(path, "magcache_tpu_torch", "ops", "build.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod     # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod.load_cuda_library()


def load_transposed(path: str):
    """The other checkout's library with ``grouped_small_kernel``'s grid
    transposed: its package copied under ``build/``, the two lines of
    ``TRANSPOSE`` rewritten, built from that copy. None when the checkout
    has no such kernel."""
    src = os.path.join(path, "magcache_tpu_torch")
    cu = os.path.join(src, "csrc", "grouped_attention.cu")
    text = open(cu).read()
    if not all(a in text for a, _ in TRANSPOSE):
        return None
    dst = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "build", "transposed")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, os.path.join(dst, "magcache_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    for a, b in TRANSPOSE:
        text = text.replace(a, b)
    with open(os.path.join(dst, "magcache_tpu_torch", "csrc", "grouped_attention.cu"),
              "w") as f:
        f.write(text)
    return load_parent(dst)


def with_library(module, lib, fn):
    """``fn()`` with ``module``'s wrappers launching ``lib``'s entries (a
    library built from another checkout with the same C signatures)."""
    saved = module.load_cuda_library
    module.load_cuda_library = lambda: lib
    try:
        return fn()
    finally:
        module.load_cuda_library = saved


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", default=None)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--only", default="k5,k1q,k8,k7,k6,k9")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    import torch.nn.functional as F

    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import fused_prologue as P
    from magcache_tpu_torch.ops.build import BUILD_DIR, load_cuda_library, map_words
    from magcache_tpu_torch.ops.gemm import gate_geometry, gemm_launch, gemm_tma_maps

    only = set(args.only.split(","))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    load_cuda_library()
    hgmma = build_report(BUILD_DIR, BODIES)
    parent = load_parent(args.parent) if args.parent else None
    # the parent's pre-pass entry: PR 9's mc_qk_norm, this checkout's mc_qk_prepass
    parent_new = parent is not None and (hasattr(parent, "mc_qk_norm")
                                         or hasattr(parent, "mc_qk_prepass"))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    reps, d, H, D = args.reps, 1152, 16, 72
    times, errs = {}, {}

    def in_turns(label, new, old, flops, moved=None, alt=None):
        """(parent, this, this, parent) when there is a parent; with ``alt``
        (the parent transposed) (parent, alt, this, this, alt, parent)."""
        if old is None:
            t = {"ms": cuda_ms(new, reps)}
        else:
            errs[label] = float((new().float() - old().float()).abs().max())
            fns = (old, new, new, old) if alt is None else (old, alt, new, new, alt, old)
            runs = [cuda_ms(f, reps) for f in fns]
            n1, n2 = runs[len(runs) // 2 - 1:len(runs) // 2 + 1]
            t = {"ms": min(n1, n2), "ms_runs": [n1, n2],
                 "parent_ms": min(runs[0], runs[-1]), "parent_runs": [runs[0], runs[-1]]}
            if alt is not None:
                t["transposed_equal"] = bool(torch.equal(alt(), old()))
                t["transposed_ms"] = min(runs[1], runs[-2])
                t["transposed_runs"] = [runs[1], runs[-2]]
        t["tflops"] = flops / t["ms"] / 1e9
        if moved is not None:
            t["tb_per_s"] = moved / t["ms"] / 1e9
            for key in ("parent", "transposed"):
                if f"{key}_ms" in t:
                    t[f"{key}_tb_per_s"] = moved / t[f"{key}_ms"] / 1e9
        times[label] = t
        print(f"{label}: {json.dumps(t)}")

    # K5 (spatial with gains, fixed max; temporal with gains and RoPE), K5r
    # and K4 (Latte temporal, no norm, row max)
    if "k5" in only:
        from magcache_tpu_torch.ops.rope import grouped_rope_tables

        trans = load_transposed(args.parent) if parent is not None else None
        gains = tuple(1.0 + 0.1 * torch.randn(H, D, generator=gen, device=dev)
                      for _ in range(2))
        for tag, rows, S, group, norm in (
                ("K5 480p spatial, gains, fixed max", 30, 1590, 1590, True),
                ("K5 480p temporal, gains + RoPE, fixed max", 1, 47700, 15, True),
                ("K5 720p temporal, gains + RoPE, fixed max", 1, 108000, 15, True),
                ("K5r Latte temporal, row max", 1, 32768, 16, False),
                ("K4 Latte temporal, q/k/v views, row max", 1, 32768, 16, False)):
            qkv = rnd(rows, S, 3 * H * D)
            q, k, v = A.split_qkv(qkv, H)
            rope = tuple(torch.from_numpy(a).to(dev) for a in
                         grouped_rope_tables(group, group, D)) if group <= 16 and norm else None
            kw = dict(group=group, scale=D ** -0.5, qk_gains=gains if norm else None,
                      rope_tables=rope, true_d=D, eps=1e-6,
                      fixed_max=A.QKNORM_FIXED_MAX if norm else None)
            if tag.startswith("K4"):
                new = lambda: A.grouped_flash_attention_bshd(q, k, v, **kw).reshape(
                    rows, S, H * D)
            else:
                new = lambda: A.grouped_attention_fused_qkv(qkv, H, **kw)
            n_groups = rows * S // group
            label = f"{tag} {rows}x{S}, group {group}"

            def entry(lib):
                out = torch.empty(rows, S, H * D, dtype=torch.bfloat16, device=dev)
                ptr = lambda t: t.data_ptr() if t is not None else None
                g = [t.contiguous() for t in gains] if norm else [None, None]
                cs = rope if rope is not None else (None, None)

                def call():
                    code = lib.mc_grouped_attention(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), q.stride(1),
                        k.stride(0), k.stride(1), v.stride(0), v.stride(1), out.data_ptr(),
                        ptr(g[0]), ptr(g[1]), ptr(cs[0]), ptr(cs[1]), n_groups,
                        S // group, H, group, group, int(not norm), D ** -0.5 * LOG2E,
                        float(D), 1e-6, A.QKNORM_FIXED_MAX if norm else 0.0, stream())
                    assert code == 0, code
                    return out
                return call

            old = None
            if parent is not None and hasattr(parent, "mc_grouped_attention"):
                old = entry(parent)
            elif parent is not None:
                # a checkout with this one's entries: its library behind
                # this checkout's wrappers
                old = lambda fn=new: with_library(A, parent, fn)
            alt = entry(trans) if trans is not None and group <= 16 and old is not None \
                else None
            in_turns(label, new, old, 4 * n_groups * H * group * group * D,
                     moved=qkv.numel() * 2 * 4 // 3 + (rope[0].numel() * 8 if rope else 0),
                     alt=alt)
            q4, k4, v4 = (t.reshape(n_groups, group, H, D) for t in (q, k, v))
            times[label]["sdpa_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in
                                                         (q4, k4, v4)), scale=D ** -0.5),
                reps)
            print(f"  SDPA{' without the norm' if norm else ''}: "
                  f"{times[label]['sdpa_ms']:.3f} ms")
            if group > 16:
                g = [t.contiguous() for t in gains]
                qn, kn = A._qk_norm_launch(q, k, g, D ** -0.5, 1e-6, group=group)
                times[label]["stages_ms"] = {
                    "qk-norm pre-pass": cuda_ms(lambda: A._qk_norm_launch(
                        q, k, g, D ** -0.5, 1e-6, group=group), reps),
                    "attention": cuda_ms(lambda: A._grouped_tma_launch(
                        "K5", qn, kn, v, group, group, 1.0, A.QKNORM_FIXED_MAX), reps)}
                print(f"  stages: {json.dumps(times[label]['stages_ms'])}")
                del qn, kn
            del qkv, q, k, v, q4, k4, v4

    # K1q: one 720p spatial block, q/k/v views of the [30, 3600, 3456] projection
    if "k1q" in only:
        frames, S = 30, 3600
        qkv = rnd(frames, S, 3 * H * D)
        q, k, v = (part.unflatten(-1, (H, D)) for part in qkv.chunk(3, dim=-1))
        gains = tuple(1.0 + 0.1 * torch.randn(H, D, generator=gen, device=dev)
                      for _ in range(2))
        kw = dict(scale=D ** -0.5, qk_gains=gains, true_d=D, eps=1e-6,
                  fixed_max=A.QKNORM_FIXED_MAX)
        label = f"K1q 720p {frames}x{S}x{H}x{D} views of [{frames}, {S}, {3 * H * D}]"
        new = lambda: A.flash_attention_bshd(q, k, v, **kw)
        old = None
        if parent is not None:
            out = torch.empty((frames, S, H, D), dtype=torch.bfloat16, device=dev)
            if parent_new:
                def old():
                    qn = torch.empty_like(out)
                    kn = torch.empty_like(out)
                    ptrs = (q.data_ptr(), k.data_ptr(), qn.data_ptr(), kn.data_ptr(),
                            gains[0].data_ptr(), gains[1].data_ptr())
                    strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1))
                    if hasattr(parent, "mc_qk_prepass"):
                        code = parent.mc_qk_prepass(*ptrs, None, None, frames, S, S, H,
                                                    *strides, S, S, S, S,
                                                    D ** -0.5 * LOG2E, 1.0 / D, 1e-6,
                                                    stream())
                    else:
                        code = parent.mc_qk_norm(*ptrs, frames, S, S, H, *strides,
                                                 D ** -0.5 * LOG2E, 1.0 / D, 1e-6, stream())
                    assert code == 0, code
                    hm = [t.transpose(1, 2) for t in (qn, kn, v, out)]
                    code = parent.mc_flash_attention_qknorm_tma(
                        qn.data_ptr(), kn.data_ptr(), v.data_ptr(), out.data_ptr(),
                        map_words(A.flash_tma_maps("parent", *hm[:3], S)),
                        (ctypes.c_longlong * 3)(*hm[3].stride()[:3]), frames, H, S, S,
                        A.QKNORM_FIXED_MAX, stream())
                    assert code == 0, code
                    return out
            else:
                def old():
                    code = parent.mc_flash_attention_qknorm(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        gains[0].data_ptr(), gains[1].data_ptr(), frames, S, H, S,
                        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
                        v.stride(1), D ** -0.5 * LOG2E, float(D), 1e-6,
                        A.QKNORM_FIXED_MAX, stream())
                    assert code == 0, code
                    return out
        in_turns(label, new, old, 4 * frames * H * S * S * D)
        g = [t.contiguous() for t in gains]
        qn, kn = A._qk_norm_launch(q, k, g, D ** -0.5, 1e-6)
        times[label]["stages_ms"] = {
            "qk-norm pre-pass": cuda_ms(lambda: A._qk_norm_launch(q, k, g, D ** -0.5, 1e-6),
                                        reps),
            "attention": cuda_ms(lambda: A._qknorm_attention_launch(
                qn, kn, v, S, A.QKNORM_FIXED_MAX), reps)}
        times[label]["sdpa_no_norm_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in (q, k, v)),
                                                   scale=D ** -0.5), reps)
        print(f"  stages: {json.dumps(times[label]['stages_ms'])}, SDPA without the norm "
              f"{times[label]['sdpa_no_norm_ms']:.3f} ms")
        del qkv, q, k, v, qn, kn

    # K8: spatial proj + residual, temporal proj (rows_out = T, batch_repeat
    # S), mlp2 + residual
    if "k8" in only:
        for tag, rows, T, S in (("480p", 2, 15, 1590), ("720p", 2, 15, 3600),
                                ("Latte", 2, 16, 1024)):
            h = rnd(rows, T * S, d)
            g = rnd(rows, d, dtype=torch.float32, scale=0.5)
            for kind, x, w, r, rep in (
                    ("spatial proj + resid", rnd(rows * T, S, d), rnd(d, d, scale=d ** -0.5),
                     h.reshape(rows * T, S, d), T),
                    ("temporal proj", rnd(rows * S, T, d), rnd(d, d, scale=d ** -0.5), None, S),
                    ("mlp2 + resid", rnd(rows, T * S, 4 * d),
                     rnd(d, 4 * d, scale=(4 * d) ** -0.5), h, 1)):
                b = rnd(d, scale=0.1)
                label = f"K8 {tag} {kind} {tuple(x.shape)} -> {d}"
                new = lambda: P.matmul_gated_residual(x, w, b, g, r, batch_repeat=rep)
                old = None
                if parent is not None:
                    b32 = b.float().contiguous()
                    out = torch.empty(x.shape[0], x.shape[1], d, dtype=x.dtype, device=dev)
                    if parent_new:
                        def old():
                            geom = gate_geometry(x.shape[0], x.shape[1], x.shape[1], rep)
                            xv = x.reshape(geom.batches, geom.rows, -1)
                            ov = out.reshape(geom.batches, geom.rows_out, d)
                            rv = None if r is None else r.reshape(ov.shape)
                            code = parent.mc_matmul_gated_residual(
                                xv.data_ptr(), w.data_ptr(),
                                map_words(gemm_tma_maps("parent", xv, w, ov, rv)),
                                ov.data_ptr(), b32.data_ptr(), g.data_ptr(),
                                None if rv is None else rv.data_ptr(), geom.batches,
                                geom.rows, geom.rows_out, x.shape[2], d, geom.rep, geom.span,
                                stream())
                            assert code == 0, code
                            return out
                    else:
                        def old():
                            code = parent.mc_matmul_gated_residual(
                                x.data_ptr(), w.data_ptr(), b32.data_ptr(), g.data_ptr(),
                                None if r is None else r.data_ptr(), out.data_ptr(),
                                x.shape[0], x.shape[1], x.shape[1], x.shape[2], d, rep,
                                stream())
                            assert code == 0, code
                            return out
                in_turns(label, new, old, 2 * x.shape[0] * x.shape[1] * x.shape[2] * d)
                times[label]["cublas_gemm_only_ms"] = cuda_ms(lambda: F.linear(x, w, b), reps)
                if r is None:
                    # the 3-D geometry K8 keeps for rows_out != S: 128-row
                    # tiles inside each batch row of T rows
                    b32, s_in = b.float().contiguous(), x.shape[1]
                    tiled = lambda: gemm_launch("3-D", x, w, b32, gate=g, rep=rep,
                                                span=s_in * rep)
                    times[label]["rows_3d_equal"] = bool(torch.equal(tiled(), new()))
                    times[label]["rows_3d_ms"] = cuda_ms(tiled, reps)
                    print(f"  in 3-D rows: {times[label]['rows_3d_ms']:.3f} ms, the same "
                          f"bits: {times[label]['rows_3d_equal']}")
                del x, r
            del h

    # K7: qkv (per-frame view, batch_repeat T) and mlp1 + gelu
    if "k7" in only:
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
                in_turns(label, lambda: P.lnmod_matmul(x, sc, sh, w, b, **kw), None,
                         2 * x.shape[0] * x.shape[1] * d * w.shape[0])
                y = P.lnmod_operand_plain(x, sc, sh, batch_repeat=kw.get("batch_repeat", 1),
                                          dtype=w.dtype)
                times[label]["cublas_gemm_only_ms"] = cuda_ms(lambda: F.linear(y, w, b), reps)
                del y
            del h

    # K6: cross-attention over the caption, residual fused; and its stages
    if "k6" in only:
        for tag, rows, N, L in (("480p", 2, 23850, 300), ("720p", 2, 54000, 300),
                                ("Latte", 2, 16384, 120)):
            h = rnd(rows, N, d)
            wq, wo = rnd(d, d, scale=d ** -0.5), rnd(d, d, scale=d ** -0.5)
            bq, bo = rnd(d, scale=0.05), rnd(d, scale=0.05)
            k, v = rnd(rows, L, d), rnd(rows, L, d)
            scale = 72 ** -0.5
            label = f"K6 {tag} {rows}x{N} x {L} keys"
            in_turns(label, lambda: A.fused_cross_attention(h, wq, bq, k, v, wo, bo, H,
                                                            scale=scale, residual=True),
                     None, 4 * rows * N * d * d + 4 * rows * N * L * d)
            b32 = bq.float().contiguous()
            q = gemm_launch("q", h, wq, b32)
            o = A._cross_attention_launch(q, k, v, H, scale, L)
            times[label]["stages_ms"] = {
                "q projection": cuda_ms(lambda: gemm_launch("q", h, wq, b32), reps),
                "attention": cuda_ms(lambda: A._cross_attention_launch(q, k, v, H, scale, L),
                                     reps),
                "out-projection + residual": cuda_ms(
                    lambda: gemm_launch("o", o, wo, b32, epilogue="resid", resid=h), reps)}
            print(f"  stages: {json.dumps(times[label]['stages_ms'])}")
            del h, q, o
    # K9: the route tiny_kernel_route picks against the general kernel of the
    # other checkout and of this one, called through mc_tiny_attention
    if "k9" in only:
        from magcache_tpu_torch.ops import tiny_attention as TA
        from magcache_tpu_torch.ops.rope import rope_freqs_1d

        for tag, R, T, norm in (("K9 Latte temporal", 2048, 16, False),
                                ("K9 STDiT3 480p temporal, gains + RoPE", 3180, 15, True)):
            qkv = rnd(R, T, 3 * H * D)
            gains = tuple(1.0 + 0.1 * torch.randn(D, generator=gen, device=dev)
                          for _ in range(2)) if norm else (None, None)
            tabs = tuple(torch.from_numpy(a).to(dev) for a in rope_freqs_1d(np.arange(T), D)) \
                if norm else (None, None)
            label = f"K9 {tag[3:]} {R}x{T}, route {TA.tiny_kernel_route(T, D)}"
            new = lambda: TA.tiny_temporal_attention(qkv, *gains, *tabs, H, mode="vpu")

            def general(lib):
                out = torch.empty(R, T, H * D, dtype=torch.bfloat16, device=dev)
                g = [None if t is None else t.expand(H, D).contiguous() for t in gains]
                ptr = lambda t: t.data_ptr() if t is not None else None

                def call():
                    code = lib.mc_tiny_attention(
                        qkv.data_ptr(), out.data_ptr(), ptr(g[0]), ptr(g[1]), ptr(tabs[0]),
                        ptr(tabs[1]), R, T, H, D, D ** -0.5 * LOG2E, 1e-6, stream())
                    assert code == 0, code
                    return out
                return call

            moved = qkv.numel() * 2 * 4 // 3 + sum(t.numel() * 4 for t in gains + tabs
                                                    if t is not None)
            old = None
            if parent is not None and hasattr(parent, "mc_tiny_stream"):
                # a checkout with this one's entries: its library behind
                # this checkout's wrappers
                old = lambda fn=new: with_library(TA, parent, fn)
            elif parent is not None:
                old = general(parent)
            in_turns(label, new, old, 4 * R * H * T * T * D, moved=moved)
            this_general = general(load_cuda_library())
            times[label]["general_max_abs"] = float(
                (new().float() - this_general().float()).abs().max())
            times[label]["general_ms"] = cuda_ms(this_general, reps)
            q4, k4, v4 = (t.reshape(R, T, H, D) for t in A.split_qkv(qkv, H))
            times[label]["sdpa_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in
                                                         (q4, k4, v4)), scale=D ** -0.5),
                reps)
            print(f"  this checkout's general kernel {times[label]['general_ms']:.3f} ms "
                  f"(max |stream - general| {times[label]['general_max_abs']:.3e}); "
                  f"SDPA{' without the norm' if norm else ''} "
                  f"{times[label]['sdpa_ms']:.3f} ms")
            del qkv, q4, k4, v4
    if errs:
        print("max |this - parent| per shape:", json.dumps(errs))
    print(json.dumps({"device": torch.cuda.get_device_name(0), "hgmma": hgmma,
                      "times": times, "max_abs_vs_parent": errs}))


if __name__ == "__main__":
    main()
