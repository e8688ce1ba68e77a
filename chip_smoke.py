"""Smoke run of the PyTorch port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``magcache_tpu_torch`` (never JAX) in ten phases and exits nonzero on
the first failure:

1. environment: a CUDA card is required; prints the card's name and power
   limit (nvidia-smi) and turns TF32 off for f32 matmuls and convolutions;
2. build: compiles the CUDA library (nvcc, sm_90a, one process per source)
   and the Triton kernels from the sources in this checkout;

Wan2.1 T2V-1.3B (K1, K2, K3):
3. each kernel against its plain PyTorch version at the path's shapes
   (832x480x81: 32,760 tokens, 2 CFG lanes, bf16), with the tolerance
   stated, and both times;
4. one full-shape forward (prepare -> trunk -> head) of WAN_1_3B;
5. requests through ``WanPipeline.generate`` at full width, 832x480x17
   (7,800 tokens): full compute, MagCache E012K2R02, and the same schedule
   with lane-asymmetric steps (the half-batch partial trunk). Checks the
   realized skip bits against ``compute_skip_schedule`` and each kernel's
   launch count against the number of trunk runs;
6. the Wan slice on the card (kernels, bf16) against the CPU (plain ops,
   f32) at a narrow width with numpy weights;

Open-Sora 1.2 STDiT3-XL/2 (K3, K5, K6, K7, K8):
7. each kernel against its plain version at the path's shapes (480p 9:16,
   51 frames: 15 frames of 1,590 tokens, a joint CFG batch of 2, bf16);
8. one full-shape forward, 28 layers;
9. requests through ``OpenSoraPipeline.generate`` at 480p x 51 frames and
   30 RFLOW steps: full compute, then MagCache opensora-v1.2 (18 of 30
   steps skipped); checks skip bits, launch counts and latents;
10. the Open-Sora slice on the card (bf16) against the CPU (f32) at hidden
   144, 2 heads of 72, 2 layers, over RFLOW steps with skipped ones.

Kernel times are CUDA-event times of a loop of back-to-back launches
between one event pair, divided by the count (``cuda_ms``). The
second-to-last line of stdout is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Weights are random (seeded); no
checkpoint is read.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import time

import numpy as np
import torch

STEPS = 20            # enough that E012K2R02 elides forwards at 20 steps
TRUNK_LAUNCHES = {"flash_attention_bshd": 60, "rms_norm_rope": 60,
                  "layer_norm_mod": 90}   # per trunk run of 30 blocks
# Open-Sora: 28 (spatial, temporal) block pairs per trunk run
OS_TRUNK_LAUNCHES = {"grouped_attention_fused_qkv": 56, "fused_cross_attention": 56,
                     "lnmod_matmul": 84, "matmul_gated_residual": 112,
                     "layer_norm_mod": 28, "flash_attention_bshd": 0,
                     "rms_norm_rope": 0}
OS_STEPS, OS_FRAMES = 30, 51
H100_BF16_TFLOPS = 989.0  # dense bf16 peak of an H100 SXM at 700 W


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


def cuda_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn`` in ms: ``reps`` back-to-back calls
    between one pair of CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, got: torch.Tensor, want: torch.Tensor, atol: float,
            rtol: float, rel_tol: float = 1e-2) -> float:
    """Fails unless |got - want| <= atol + rtol*|want| everywhere and the
    relative L2 error is within ``rel_tol``."""
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        fail(f"{name}: non-finite kernel output")
    err = (g - w).abs()
    worst = float((err - rtol * w.abs()).max())
    max_abs = float(err.max())
    rel = float((g - w).norm() / w.norm())
    log(f"  {name}: max_abs_err={max_abs:.3e} rel_l2_err={rel:.3e} (tol "
        f"{atol} + {rtol}*|plain| per element, worst excess {worst - atol:.3e}; "
        f"rel L2 tol {rel_tol})")
    if worst > atol or rel > rel_tol:
        fail(f"{name}: kernel disagrees with its plain version")
    return max_abs


def phase_environment():
    log("phase 1: environment")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    log(smi.stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}; allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32}")


def phase_build(dev):
    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import fused_prologue as P
    from magcache_tpu_torch.ops.build import load_cuda_library

    log("phase 2: build")
    t0 = time.time()
    load_cuda_library()
    t_nvcc = time.time() - t0
    # first launches compile the Triton kernels at the main path's widths
    x = torch.randn(1, 256, 1536, device=dev, dtype=torch.bfloat16)
    g = torch.ones(1536, device=dev)
    tab = torch.zeros(256, 64, device=dev)
    P.rms_norm_rope(x, g, tab, tab, 12, eps=1e-6)
    P.layer_norm_mod(x, scale=g[None, None], shift=g[None, None], eps=1e-6)
    P.layer_norm_mod(x, weight=g, bias=g, eps=1e-6)
    q = torch.randn(1, 256, 12, 128, device=dev, dtype=torch.bfloat16)
    A.flash_attention_bshd(q, q, q, fixed_max=16.0)
    A.flash_attention_bshd(q, q, q)
    torch.cuda.synchronize()
    log(f"  build: nvcc {t_nvcc:.1f} s, Triton compile + first launches "
        f"{time.time() - t0 - t_nvcc:.1f} s")


def phase_kernels(dev):
    """Each kernel vs its plain version at the main path's shapes."""
    from magcache_tpu_torch.models.wan import WAN_1_3B, wan_rope_tables
    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import fused_prologue as P

    log("phase 3: kernels vs plain at Wan2.1-1.3B 832x480x81 shapes (bf16)")
    gen = torch.Generator(device=dev).manual_seed(1234)
    B, S, H, D, L = 2, 21 * 30 * 52, 12, 128, 512
    bf = torch.bfloat16

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    rec = {}
    # K1: bf16 out; kernel and plain round at the same points, only the f32
    # summation order differs -> a bf16 ulp or two of the output
    q, k, v = rnd(B, S, H, D), rnd(B, S, H, D), rnd(B, S, H, D)
    ck, cv = rnd(B, L, H, D), rnd(B, L, H, D)
    cases = [("self, fixed_max=16", (q, k, v), 16.0),
             ("cross 512 keys, fixed_max=16", (q, ck, cv), 16.0),
             ("self, running max", (q, k, v), None)]
    for label, (qq, kk, vv), fm in cases:
        got = A.flash_attention_bshd(qq, kk, vv, fixed_max=fm)
        want = A.flash_attention_bshd_plain(qq, kk, vv, fixed_max=fm)
        err = compare(f"K1 flash_attention_bshd [{label}]", got, want,
                      atol=2e-3, rtol=2e-2)
        ms = cuda_ms(lambda: A.flash_attention_bshd(qq, kk, vv, fixed_max=fm), 5)
        pms = cuda_ms(lambda: A.flash_attention_bshd_plain(qq, kk, vv,
                                                           fixed_max=fm), 2)
        flops = 4 * B * H * S * kk.shape[1] * D
        log(f"  K1 [{label}]: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} "
            f"TFLOP/s), plain {pms:.3f} ms")
        rec.setdefault("flash_attention_bshd", (err, ms, pms))
    del q, k, v, ck, cv

    # K2/K3: a flipped bf16 rounding of the normed value moves an output by
    # one ulp of its largest pair element -> atol 3e-2 at |y| < 8
    x = rnd(B, S, H * D, scale=2.0)
    gain = 1.0 + rnd(H * D, dtype=torch.float32, scale=0.1)
    cos_np, sin_np = wan_rope_tables(WAN_1_3B, (21, 30, 52))
    cos, sin = torch.from_numpy(cos_np).to(dev), torch.from_numpy(sin_np).to(dev)
    got = P.rms_norm_rope(x, gain, cos, sin, H, eps=1e-6)
    want = P.rms_norm_rope_plain(x, gain, cos, sin, H, eps=1e-6)
    err = compare("K2 rms_norm_rope [token scope]", got, want, atol=3e-2,
                  rtol=1.6e-2)
    ms = cuda_ms(lambda: P.rms_norm_rope(x, gain, cos, sin, H, eps=1e-6))
    pms = cuda_ms(lambda: P.rms_norm_rope_plain(x, gain, cos, sin, H, eps=1e-6))
    gbs = 2 * x.numel() * 2 / ms / 1e6
    log(f"  K2: kernel {ms:.3f} ms ({gbs:.0f} GB/s), plain {pms:.3f} ms")
    rec["rms_norm_rope"] = (err, ms, pms)

    sc = rnd(B, 1, H * D, dtype=torch.float32, scale=0.1)
    sh = rnd(B, 1, H * D, dtype=torch.float32, scale=0.1)
    w = 1.0 + rnd(H * D, dtype=torch.float32, scale=0.1)
    bias = rnd(H * D, dtype=torch.float32, scale=0.1)
    for label, kw in (("mod", dict(scale=sc, shift=sh)),
                      ("affine", dict(weight=w, bias=bias))):
        got = P.layer_norm_mod(x, eps=1e-6, **kw)
        want = P.layer_norm_mod_plain(x, eps=1e-6, **kw)
        err = compare(f"K3 layer_norm_mod [{label}]", got, want, atol=3e-2,
                      rtol=1.6e-2)
        ms = cuda_ms(lambda: P.layer_norm_mod(x, eps=1e-6, **kw))
        pms = cuda_ms(lambda: P.layer_norm_mod_plain(x, eps=1e-6, **kw))
        log(f"  K3 [{label}]: kernel {ms:.3f} ms "
            f"({2 * x.numel() * 2 / ms / 1e6:.0f} GB/s), plain {pms:.3f} ms")
        rec.setdefault("layer_norm_mod", (err, ms, pms))
    return rec


def make_model(dev):
    from magcache_tpu_torch.models.wan import WAN_1_3B, WanModel

    cfg = dataclasses.replace(WAN_1_3B, dtype="bfloat16")
    t0 = time.time()
    model = WanModel(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False)
    torch.cuda.synchronize()
    log(f"  WAN_1_3B bf16 random init: {time.time() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params")
    return model


def phase_forward(dev, model):
    from magcache_tpu_torch.models.text import MockTextEncoder
    from magcache_tpu_torch.models.wan import make_wan_core

    log("phase 4: one full-shape forward, WAN_1_3B 832x480x81, 2 lanes")
    grid = (21, 30, 52)
    core = make_wan_core(model, grid)
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((2, 21, 60, 104, 16), generator=gen, device=dev)
    t = torch.full((2,), 900.0, device=dev)
    ctx = MockTextEncoder(512, 4096, scale=0.5)(["a cat", ""], device=dev)
    for run in ("first", "second"):
        torch.cuda.synchronize()
        t0 = time.time()
        hidden, c = core.prepare(x, t, {"context": ctx})
        out = core.head(core.trunk(hidden, c), c)
        torch.cuda.synchronize()
        log(f"  forward ({run} call): {time.time() - t0:.3f} s, "
            f"{hidden.shape[1]} tokens")
    if tuple(out.shape) != (2, 21, 60, 104, 16) or not bool(torch.isfinite(out).all()):
        fail(f"forward output {tuple(out.shape)} is not finite or misshapen")
    log(f"  output {tuple(out.shape)} finite, std {float(out.float().std()):.4f}")


def reset_counts():
    """Sets every kernel wrapper's launch count to 0; returns them by name."""
    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import fused_prologue as P

    fns = {"flash_attention_bshd": A.flash_attention_bshd,
           "rms_norm_rope": P.rms_norm_rope,
           "layer_norm_mod": P.layer_norm_mod,
           "grouped_attention_fused_qkv": A.grouped_attention_fused_qkv,
           "fused_cross_attention": A.fused_cross_attention,
           "lnmod_matmul": P.lnmod_matmul,
           "matmul_gated_residual": P.matmul_gated_residual}
    for fn in fns.values():
        fn.launches = 0
    return fns


def phase_requests(dev, model):
    from magcache_tpu_torch.core.magcache import compute_skip_schedule
    from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

    log(f"phase 5: requests through WanPipeline.generate, 832x480x17, "
        f"{STEPS} UniPC steps, CFG 5.0")
    base = dict(size=(832, 480), frame_num=17, sample_steps=STEPS,
                sample_shift=5.0, guide_scale=5.0)
    full = WanPipeline(WanPipelineConfig(**base), dev, model=model)
    cached = WanPipeline(WanPipelineConfig(use_magcache=True, **base), dev,
                         model=model)
    sched = compute_skip_schedule(cached._cache_cfg()).reshape(STEPS, 2)
    if not sched.any():
        fail("E012K2R02 elides no forward at this step count")
    # the same schedule with the uncond lane computing on every other skipped
    # step: lane-asymmetric steps run the half-batch trunk
    asym = sched.copy()
    asym[np.flatnonzero(sched.all(1))[::2], 1] = False
    requests = [("full compute", full, None, np.zeros((STEPS, 1), bool)),
                ("MagCache E012K2R02", cached, None, sched),
                ("MagCache, lane-asymmetric override", cached, asym, asym)]
    counts = {k: fn for k, fn in reset_counts().items() if k in TRUNK_LAUNCHES}
    total = {k: 0 for k in counts}
    for label, pipe, override, want in requests:
        before = {k: fn.launches for k, fn in counts.items()}
        out = pipe.generate("Two anthropomorphic cats fight on a stage.",
                            seed=3, skip_override=override)
        lat = out.latents
        if tuple(lat.shape) != (1, 5, 60, 104, 16) or not bool(torch.isfinite(lat).all()):
            fail(f"{label}: latents {tuple(lat.shape)} not finite or misshapen")
        if not np.array_equal(out.skips, want):
            fail(f"{label}: realized skips differ from the schedule")
        runs = int((~out.skips.all(1)).sum())
        for k, fn in counts.items():
            got = fn.launches - before[k]
            if got != TRUNK_LAUNCHES[k] * runs:
                fail(f"{label}: {k} launched {got} times, expected "
                     f"{TRUNK_LAUNCHES[k]} x {runs} trunk runs")
            total[k] += got
        log(f"  {label}: {out.timings['total_s']:.3f} s, skipped "
            f"{int(out.skips.sum())} lane-forwards of {STEPS * 2}, "
            f"{runs} trunk runs ({int((out.skips.sum(1) == 1).sum())} "
            f"half-batch), latents std {float(lat.std()):.4f}")
    log(f"  launches in phase 5: {total}")
    return total


def _numpy_wan_tree(cfg, rng):
    """A random Wan parameter tree in the JAX package's layout (depth-stacked
    blocks, ``w: [d_in, d_out]``)."""
    d, L = cfg.dim, cfg.layers

    def lin(d_in, d_out, depth=None):
        shape = (d_in, d_out) if depth is None else (depth, d_in, d_out)
        return {"w": rng.standard_normal(shape) / math.sqrt(d_in),
                "b": rng.standard_normal(shape[:-2] + (d_out,)) * 0.02}

    blocks = {n: lin(d, d, L) for n in ("q", "k", "v", "o", "cross_q",
                                        "cross_k", "cross_v", "cross_o")}
    blocks.update(ffn1=lin(d, cfg.ffn_dim, L), ffn2=lin(cfg.ffn_dim, d, L),
                  modulation=rng.standard_normal((L, 6, d)) / math.sqrt(d))
    for n in ("norm_q", "norm_k", "cross_norm_q", "cross_norm_k", "norm3_w"):
        blocks[n] = 1.0 + 0.1 * rng.standard_normal((L, d))
    blocks["norm3_b"] = 0.1 * rng.standard_normal((L, d))
    return {"patch_embedding": lin(cfg.patch_in, d),
            "text_embedding": {"in": lin(cfg.text_dim, d), "out": lin(d, d)},
            "time_embedding": {"in": lin(cfg.freq_dim, d), "out": lin(d, d)},
            "time_projection": lin(d, 6 * d),
            "blocks": blocks,
            "head": {"modulation": rng.standard_normal((2, d)) / math.sqrt(d),
                     "out": lin(d, cfg.patch_out)}}


def phase_card_vs_cpu(dev):
    from magcache_tpu_torch.core.presets import make_config
    from magcache_tpu_torch.core.sampler import sample_unipc
    from magcache_tpu_torch.models.convert import wan_params_from_numpy
    from magcache_tpu_torch.models.text import MockTextEncoder
    from magcache_tpu_torch.models.wan import WanConfig, WanModel, make_wan_core
    from magcache_tpu_torch.schedulers.unipc import UniPCSchedule

    log("phase 6: the slice on the card (kernels, bf16) vs the CPU (plain, f32)")
    cfg = WanConfig.tiny(dim=256, heads=2, ffn_dim=512, layers=2)
    grid = (2, 8, 12)                     # 192 tokens: K1 runs (> 128)
    rng = np.random.default_rng(11)
    tree = _numpy_wan_tree(cfg, rng)
    x0 = rng.standard_normal((1, 2, 16, 24, cfg.in_channels)).astype(np.float32)
    ctx = MockTextEncoder(cfg.text_len, cfg.text_dim, scale=0.5)(["a cat", ""])
    # steps 2 (both lanes skip), 4 and 5 (one lane skips)
    mask = np.array([[0, 0], [0, 0], [1, 1], [0, 0], [1, 0], [0, 1]], bool)
    sch = UniPCSchedule.create(len(mask), shift=5.0)
    outs = {}
    counts = {k: fn for k, fn in reset_counts().items() if k in TRUNK_LAUNCHES}
    for name, device, dtype in (("card", dev, torch.bfloat16),
                                ("cpu", torch.device("cpu"), torch.float32)):
        c = dataclasses.replace(cfg, dtype=str(dtype).split(".")[1])
        model = WanModel(c, device)
        model.load_state_dict(wan_params_from_numpy(tree, c, device))
        core = make_wan_core(model, grid)
        lat, skips = sample_unipc(core, torch.from_numpy(x0).to(device),
                                  {"context": ctx.to(device)}, sch,
                                  cache_cfg=make_config("wan2.1-t2v-1.3B", len(mask)),
                                  guidance_scale=5.0, skip_mask_override=mask,
                                  return_skips=True)
        outs[name] = lat.float().cpu()
    got, want = outs["card"], outs["cpu"]
    if not bool(torch.isfinite(got).all()):
        fail("card latents are not finite")
    rel = float((got - want).norm() / want.norm())
    max_abs = float((got - want).abs().max())
    launched = {k: fn.launches for k, fn in counts.items()}
    # bf16 activations through 2 blocks and 6 steps vs f32: rounding of
    # ~2^-8 per op, accumulated -> a few percent at most
    log(f"  rel L2 {rel:.3e} (tol 5e-2), max_abs_err {max_abs:.3e}, "
        f"card launches {launched}")
    if rel > 5e-2 or not all(launched.values()):
        fail("card and CPU slices disagree, or a kernel did not run")

# ---------------------------------------------------------------- Open-Sora
def phase_os_kernels(dev):
    """K3, K5-K8 vs their plain versions at STDiT3-XL/2 480p x 51 shapes."""
    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import fused_prologue as P
    from magcache_tpu_torch.ops.rope import grouped_rope_tables

    log("phase 7: kernels vs plain at STDiT3-XL/2 480p 9:16 x 51 shapes (bf16)")
    gen = torch.Generator(device=dev).manual_seed(4321)
    rows, T, S, d, H, L = 2, 15, 1590, 1152, 16, 300
    N = T * S
    bf = torch.bfloat16

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    rec = {}

    # K7/K8: a flipped bf16 rounding of an intermediate (the GEMM operand,
    # the pre-gate product, the gated value before the residual add) of
    # magnitude < 8 moves an output by up to one ulp there, 2^-5
    def record(name, label, got, want, ms, pms, flops, atol=4e-2, rtol=2e-2):
        err = compare(f"{name} [{label}]", got, want, atol=atol, rtol=rtol)
        log(f"  {name} [{label}]: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} "
            f"TFLOP/s, {flops / ms / 1e9 / H100_BF16_TFLOPS:.1%} of "
            f"{H100_BF16_TFLOPS:.0f}), plain {pms:.3f} ms")
        rec.setdefault(name, (err, ms, pms))

    # K7: the spatial qkv projection (per-frame view, batch_repeat 15) and
    # mlp1 with the gelu epilogue
    h = rnd(rows, N, d)
    sc, sh = rnd(rows, d, dtype=torch.float32, scale=0.1), rnd(rows, d, dtype=torch.float32, scale=0.1)
    for label, x, w, b, kw in (
            ("qkv 30x1590x1152 -> 3456, batch_repeat 15", h.reshape(rows * T, S, d),
             rnd(3 * d, d, scale=d ** -0.5), rnd(3 * d, scale=0.1), dict(batch_repeat=T)),
            ("mlp1 2x23850x1152 -> 4608, gelu", h, rnd(4 * d, d, scale=d ** -0.5),
             rnd(4 * d, scale=0.1), dict(act="gelu"))):
        got = P.lnmod_matmul(x, sc, sh, w, b, **kw)
        want = P.lnmod_matmul_plain(x, sc, sh, w, b, **kw)
        record("lnmod_matmul", label, got, want,
               cuda_ms(lambda: P.lnmod_matmul(x, sc, sh, w, b, **kw)),
               cuda_ms(lambda: P.lnmod_matmul_plain(x, sc, sh, w, b, **kw), 2),
               2 * x.shape[0] * x.shape[1] * d * w.shape[0])
        del got, want

    # K8: spatial proj + residual, temporal proj (gate row per 1,590 rows, no
    # residual), mlp2 + residual
    g = rnd(rows, d, dtype=torch.float32, scale=0.5)
    for label, x, w, r, kw in (
            ("proj spatial 30x1590x1152 + resid", rnd(rows * T, S, d),
             rnd(d, d, scale=d ** -0.5), h.reshape(rows * T, S, d), dict(batch_repeat=T)),
            ("proj temporal 3180x15x1152, batch_repeat 1590", rnd(rows * S, T, d),
             rnd(d, d, scale=d ** -0.5), None, dict(batch_repeat=S, rows_out=T)),
            ("mlp2 2x23850x4608 + resid", rnd(rows, N, 4 * d),
             rnd(d, 4 * d, scale=(4 * d) ** -0.5), h, {})):
        b = rnd(d, scale=0.1)
        got = P.matmul_gated_residual(x, w, b, g, r, **kw)
        want = P.matmul_gated_residual_plain(x, w, b, g, r, **kw)
        record("matmul_gated_residual", label, got, want,
               cuda_ms(lambda: P.matmul_gated_residual(x, w, b, g, r, **kw)),
               cuda_ms(lambda: P.matmul_gated_residual_plain(x, w, b, g, r, **kw), 2),
               2 * x.shape[0] * x.shape[1] * x.shape[2] * d)
        del got, want, x

    # K5: spatial (one group per frame) and temporal (groups of 15, RoPE)
    gains = (1.0 + rnd(H, 72, dtype=torch.float32, scale=0.1),
             1.0 + rnd(H, 72, dtype=torch.float32, scale=0.1))
    tabs = tuple(torch.from_numpy(a).to(dev) for a in grouped_rope_tables(T, T, 72))
    attn = dict(scale=72 ** -0.5, qk_gains=gains, true_d=72, eps=1e-6,
                fixed_max=A.QKNORM_FIXED_MAX)
    for label, qkv, kw, flops in (
            ("spatial 30x1590, group 1590", rnd(rows * T, S, 3 * d), dict(group=S),
             4 * rows * T * H * S * S * 72),
            ("temporal 47700, group 15, rope", rnd(1, rows * S * T, 3 * d),
             dict(group=T, rope_tables=tabs), 4 * rows * S * H * T * T * 72)):
        got = A.grouped_attention_fused_qkv(qkv, H, **kw, **attn)
        want = A.grouped_attention_fused_qkv_plain(qkv, H, **kw, **attn)
        record("grouped_attention_fused_qkv", label, got, want,
               cuda_ms(lambda: A.grouped_attention_fused_qkv(qkv, H, **kw, **attn)),
               cuda_ms(lambda: A.grouped_attention_fused_qkv_plain(qkv, H, **kw, **attn), 2),
               flops, atol=1e-2)
        del got, want, qkv

    # K6: cross-attention over the 300-token caption, residual fused
    wq, wo = rnd(d, d, scale=d ** -0.5), rnd(d, d, scale=d ** -0.5)
    bq, bo = rnd(d, scale=0.05), rnd(d, scale=0.05)
    k, v = rnd(rows, L, d), rnd(rows, L, d)
    got = A.fused_cross_attention(h, wq, bq, k, v, wo, bo, H, scale=72 ** -0.5,
                                  true_d=72, residual=True)
    want = A.fused_cross_attention_plain(h, wq, bq, k, v, wo, bo, H,
                                         scale=72 ** -0.5, true_d=72, residual=True)
    record("fused_cross_attention", "2x23850 x 300 keys, residual", got, want,
           cuda_ms(lambda: A.fused_cross_attention(h, wq, bq, k, v, wo, bo, H,
                                                   scale=72 ** -0.5, residual=True)),
           cuda_ms(lambda: A.fused_cross_attention_plain(h, wq, bq, k, v, wo, bo, H,
                                                         scale=72 ** -0.5,
                                                         residual=True), 2),
           4 * rows * N * d * d + 4 * rows * N * L * d)

    # K3 at the temporal block's shape (mod mode)
    got = P.layer_norm_mod(h, scale=sc, shift=sh, eps=1e-6)
    want = P.layer_norm_mod_plain(h, scale=sc, shift=sh, eps=1e-6)
    compare("layer_norm_mod [temporal mod, 2x23850x1152]", got, want, atol=3e-2,
            rtol=1.6e-2)
    ms = cuda_ms(lambda: P.layer_norm_mod(h, scale=sc, shift=sh, eps=1e-6))
    pms = cuda_ms(lambda: P.layer_norm_mod_plain(h, scale=sc, shift=sh, eps=1e-6))
    log(f"  K3 [temporal mod]: kernel {ms:.3f} ms "
        f"({2 * h.numel() * 2 / ms / 1e6:.0f} GB/s), plain {pms:.3f} ms")
    return rec


def make_os_model(dev):
    from magcache_tpu_torch.models.stdit3 import STDIT3_XL_2, STDiT3Model

    cfg = dataclasses.replace(STDIT3_XL_2, dtype="bfloat16")
    t0 = time.time()
    model = STDiT3Model(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False)
    torch.cuda.synchronize()
    log(f"  STDiT3-XL/2 bf16 random init: {time.time() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params")
    return model


def phase_os_forward(dev, model):
    from magcache_tpu_torch.models.stdit3 import make_stdit3_core
    from magcache_tpu_torch.models.text import MockTextEncoder

    log("phase 8: one full-shape forward, STDiT3-XL/2 480p 9:16 x 51, 2 rows")
    grid = (15, 30, 53)
    core = make_stdit3_core(model, grid, pixel_size=(480, 854))
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn((2, 15, 60, 106, 4), generator=gen, device=dev)
    t = torch.full((2,), 900.0, device=dev)
    cond = {"y": MockTextEncoder(300, 4096, scale=0.5)(["a boat", ""], device=dev),
            "fps": torch.full((2,), 24.0, device=dev)}
    counts = reset_counts()
    for run in ("first", "second"):
        torch.cuda.synchronize()
        t0 = time.time()
        hidden, c = core.prepare(x, t, cond)
        out = core.head(core.trunk(hidden, c), c)
        torch.cuda.synchronize()
        log(f"  forward ({run} call): {time.time() - t0:.3f} s, "
            f"{hidden.shape[1]} tokens x {hidden.shape[0]} rows")
    if tuple(out.shape) != (2, 15, 60, 106, 8) or not bool(torch.isfinite(out).all()):
        fail(f"forward output {tuple(out.shape)} is not finite or misshapen")
    per_run = {k: fn.launches // 2 for k, fn in counts.items()}
    log(f"  output {tuple(out.shape)} finite, std {float(out.float().std()):.4f}; "
        f"launches per forward {per_run}")
    if per_run != OS_TRUNK_LAUNCHES:
        fail(f"launches per forward {per_run} != {OS_TRUNK_LAUNCHES}")


def phase_os_requests(dev, model):
    from magcache_tpu_torch.core.magcache import compute_skip_schedule
    from magcache_tpu_torch.pipelines.open_sora import (OpenSoraPipeline,
                                                        OpenSoraPipelineConfig)

    log(f"phase 9: requests through OpenSoraPipeline.generate, 480p 9:16 x "
        f"{OS_FRAMES} frames, {OS_STEPS} RFLOW steps, cfg 7.0")
    base = dict(resolution="480p", aspect_ratio="9:16", num_frames=OS_FRAMES,
                num_sampling_steps=OS_STEPS, cfg_scale=7.0, dtype="bfloat16")
    full = OpenSoraPipeline(OpenSoraPipelineConfig(**base), dev, model=model)
    cached = OpenSoraPipeline(OpenSoraPipelineConfig(use_magcache=True, **base),
                              dev, model=model)
    sched = compute_skip_schedule(cached._cache_cfg()).reshape(OS_STEPS, 1)
    ceiling = OS_STEPS / (OS_STEPS - int(sched.sum()))
    counts = reset_counts()
    total = {k: 0 for k in counts}
    secs = {}
    for label, pipe, want in (("full compute", full, np.zeros((OS_STEPS, 1), bool)),
                              ("MagCache opensora-v1.2", cached, sched)):
        before = {k: fn.launches for k, fn in counts.items()}
        out = pipe.generate("A red sailboat glides across a calm bay at dawn.",
                            seed=3)
        lat = out.latents
        if tuple(lat.shape) != (1, 15, 60, 106, 4) or not bool(torch.isfinite(lat).all()):
            fail(f"{label}: latents {tuple(lat.shape)} not finite or misshapen")
        if not np.array_equal(out.skips, want):
            fail(f"{label}: realized skips differ from the schedule")
        runs = int((~out.skips.all(1)).sum())
        for k, fn in counts.items():
            got = fn.launches - before[k]
            if got != OS_TRUNK_LAUNCHES[k] * runs:
                fail(f"{label}: {k} launched {got} times, expected "
                     f"{OS_TRUNK_LAUNCHES[k]} x {runs} trunk runs")
            total[k] += got
        secs[label] = out.timings["total_s"]
        log(f"  {label}: {secs[label]:.3f} s/video, {runs} of {OS_STEPS} "
            f"forwards computed, skipped steps "
            f"{np.flatnonzero(out.skips.any(1)).tolist()}, latents std "
            f"{float(lat.std()):.4f}")
    speedup = secs["full compute"] / secs["MagCache opensora-v1.2"]
    log(f"  speedup {speedup:.3f}x against a schedule ceiling of {ceiling:.3f}x "
        f"({OS_STEPS} / {OS_STEPS - int(sched.sum())} forwards)")
    if int(sched.sum()) != 18:
        fail(f"opensora-v1.2 skips {int(sched.sum())} of 30 steps, expected 18")
    log(f"  launches in phase 9: {total}")
    return total


def _numpy_stdit3_tree(cfg, rng):
    """A random STDiT3 parameter tree in the JAX package's layout
    (depth-stacked blocks, ``w: [d_in, d_out]``)."""
    d, L = cfg.hidden, cfg.depth

    def lin(d_in, d_out, depth=None):
        shape = (d_in, d_out) if depth is None else (depth, d_in, d_out)
        return {"w": rng.standard_normal(shape) / math.sqrt(d_in),
                "b": rng.standard_normal(shape[:-2] + (d_out,)) * 0.02}

    def group():
        g = {n: lin(d, w * d, L) for n, w in (("qkv", 3), ("proj", 1), ("cross_q", 1),
                                              ("cross_kv", 2), ("cross_o", 1),
                                              ("mlp1", cfg.mlp_ratio))}
        g["mlp2"] = lin(cfg.mlp_ratio * d, d, L)
        g["scale_shift"] = rng.standard_normal((L, 6, d)) / math.sqrt(d)
        g["q_norm"] = 1.0 + 0.1 * rng.standard_normal((L, cfg.head_dim))
        g["k_norm"] = 1.0 + 0.1 * rng.standard_normal((L, cfg.head_dim))
        return g

    return {"y_null": rng.standard_normal((cfg.caption_max_len, cfg.caption_dim)),
            "patch_embed": lin(cfg.patch_in, d),
            "t_embed": {"in": lin(cfg.freq_dim, d), "out": lin(d, d)},
            "fps_embed": {"in": lin(cfg.freq_dim, d), "out": lin(d, d)},
            "t_block": lin(d, 6 * d),
            "y_embed": {"in": lin(cfg.caption_dim, d), "out": lin(d, d)},
            "spatial": group(), "temporal": group(),
            "final": {"scale_shift": rng.standard_normal((2, d)) / math.sqrt(d),
                      "out": lin(d, cfg.patch_out)}}


def phase_os_card_vs_cpu(dev):
    from magcache_tpu_torch.core.presets import make_config
    from magcache_tpu_torch.core.sampler import sample_euler
    from magcache_tpu_torch.models.convert import stdit3_params_from_numpy
    from magcache_tpu_torch.models.stdit3 import (STDiT3Config, STDiT3Model,
                                                  make_stdit3_core)
    from magcache_tpu_torch.models.text import MockTextEncoder
    from magcache_tpu_torch.schedulers.rflow import RFlowSchedule

    log("phase 10: the Open-Sora slice on the card (kernels, bf16) vs the CPU "
        "(plain, f32)")
    cfg = STDiT3Config(hidden=144, heads=2, depth=2, caption_dim=64, freq_dim=64,
                       caption_max_len=20)
    grid = (5, 5, 8)                 # frames of 40 tokens (> 16), T = 5
    rng = np.random.default_rng(12)
    tree = _numpy_stdit3_tree(cfg, rng)
    x0 = rng.standard_normal((1, 5, 10, 16, 4)).astype(np.float32)
    y = MockTextEncoder(20, 64, scale=0.5)(["a red boat", ""])
    mask = np.array([0, 0, 1, 0, 1, 1, 0, 0], bool)[:, None]
    sch = RFlowSchedule.create(len(mask), use_timestep_transform=True, height=80,
                               width=128, num_frames=17)

    def combine(chunks):
        return chunks[1][..., :4] + 7.0 * (chunks[0][..., :4] - chunks[1][..., :4])

    outs = {}
    counts = reset_counts()
    for name, device, dtype in (("card", dev, torch.bfloat16),
                                ("cpu", torch.device("cpu"), torch.float32)):
        c = dataclasses.replace(cfg, dtype=str(dtype).split(".")[1])
        model = STDiT3Model(c, device)
        model.load_state_dict(stdit3_params_from_numpy(tree, c, device))
        core = make_stdit3_core(model, grid, pixel_size=(80, 128))
        lat, skips = sample_euler(
            core, torch.from_numpy(x0).to(device),
            {"y": y.to(device), "fps": torch.full((2,), 24.0, device=device)},
            timesteps=sch.timesteps, dts=sch.dts(), lanes=2, combine_fn=combine,
            cache_cfg=make_config("opensora-v1.2", len(mask)),
            skip_mask_override=mask, return_skips=True)
        outs[name] = lat.float().cpu()
    got, want = outs["card"], outs["cpu"]
    if not bool(torch.isfinite(got).all()):
        fail("card latents are not finite")
    rel = float((got - want).norm() / want.norm())
    max_abs = float((got - want).abs().max())
    launched = {k: fn.launches for k, fn in counts.items()}
    # bf16 activations through 2 block pairs and 5 computed steps vs f32:
    # rounding of ~2^-8 per op, accumulated -> a few percent at most
    log(f"  rel L2 {rel:.3e} (tol 5e-2), max_abs_err {max_abs:.3e}, "
        f"card launches {launched}")
    runs = int((~mask).sum())
    if rel > 5e-2 or any(launched[k] != 2 * n // 28 * runs
                         for k, n in OS_TRUNK_LAUNCHES.items()):
        fail("card and CPU slices disagree, or a kernel did not run as expected")


def main():
    phase_environment()
    dev = torch.device("cuda", 0)
    t0 = time.time()
    phase_build(dev)
    rec = phase_kernels(dev)
    log("phase 4/5 model:")
    model = make_model(dev)
    phase_forward(dev, model)
    launches = phase_requests(dev, model)
    del model
    torch.cuda.empty_cache()
    phase_card_vs_cpu(dev)
    t_wan = time.time() - t0
    rec.update(phase_os_kernels(dev))
    torch.cuda.empty_cache()
    log("phase 8/9 model:")
    model = make_os_model(dev)
    phase_os_forward(dev, model)
    os_launches = phase_os_requests(dev, model)
    del model
    torch.cuda.empty_cache()
    phase_os_card_vs_cpu(dev)
    log(f"all phases passed in {time.time() - t0:.1f} s (Wan {t_wan:.1f} s)")

    meta = {
        "flash_attention_bshd": ("cuda", "magcache_tpu_torch/csrc/flash_attention.cu",
                                 "magcache_tpu/ops/attention.py:430"),
        "rms_norm_rope": ("triton", "magcache_tpu_torch/csrc/prologue_triton.py",
                          "magcache_tpu/ops/fused_prologue.py:342"),
        "layer_norm_mod": ("triton", "magcache_tpu_torch/csrc/prologue_triton.py",
                           "magcache_tpu/ops/fused_prologue.py:440"),
        "grouped_attention_fused_qkv": ("cuda", "magcache_tpu_torch/csrc/grouped_attention.cu",
                                        "magcache_tpu/ops/attention.py:755"),
        "fused_cross_attention": ("cuda", "magcache_tpu_torch/csrc/cross_attention.cu",
                                  "magcache_tpu/ops/attention.py:933"),
        "lnmod_matmul": ("cuda", "magcache_tpu_torch/csrc/fused_matmul.cu",
                         "magcache_tpu/ops/fused_prologue.py:205"),
        "matmul_gated_residual": ("cuda", "magcache_tpu_torch/csrc/fused_matmul.cu",
                                  "magcache_tpu/ops/fused_prologue.py:66"),
    }
    kernels = []
    for name, (route, source, replaces) in meta.items():
        err, ms, pms = rec[name]
        by_path = {"wan": launches.get(name, 0), "open-sora": os_launches[name]}
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, "max_abs_err": err,
                        "ms": ms, "plain_ms": pms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
