"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``magcache_tpu_torch`` (never JAX) in six phases and exits nonzero on
the first failure:

1. environment: a CUDA card is required; prints the card's name and power
   limit (nvidia-smi) and turns TF32 off for f32 matmuls and convolutions;
2. build: compiles the CUDA library (nvcc, sm_90a) and the Triton kernels
   from the sources in this checkout;
3. each kernel against its plain PyTorch version at the main path's shapes
   (Wan2.1-1.3B at 832x480x81: 32,760 tokens, 2 CFG lanes, bf16), with the
   tolerance stated, and both times (CUDA events, median);
4. one full-shape forward (prepare -> trunk -> head) of WAN_1_3B at
   832x480x81;
5. requests through ``WanPipeline.generate`` at full width, 832x480x17 (7,800
   tokens): full compute, MagCache E012K2R02, and the same schedule with
   lane-asymmetric steps (the half-batch partial trunk). Checks the realized
   skip bits against ``compute_skip_schedule`` and each kernel's launch count
   against the number of trunk runs;
6. the whole slice on the card (kernels, bf16) against the CPU (plain ops,
   f32) at a narrow width with numpy weights, over UniPC steps with an
   all-skip and a lane-asymmetric step.

The second-to-last line of stdout is the kernels' JSON record, the last
line ``{"ok": true, "device": {...}}``. Weights are random (seeded); no
checkpoint is read.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import time

import numpy as np
import torch

STEPS = 20            # enough that E012K2R02 elides forwards at 20 steps
TRUNK_LAUNCHES = {"flash_attention_bshd": 60, "rms_norm_rope": 60,
                  "layer_norm_mod": 90}   # per trunk run of 30 blocks


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


def cuda_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` in ms over ``reps`` runs (CUDA events)."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name: str, got: torch.Tensor, want: torch.Tensor, atol: float,
            rtol: float) -> float:
    """Fails unless |got - want| <= atol + rtol*|want| everywhere."""
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        fail(f"{name}: non-finite kernel output")
    err = (g - w).abs()
    worst = float((err - rtol * w.abs()).max())
    max_abs = float(err.max())
    rel = float((g - w).norm() / w.norm())
    log(f"  {name}: max_abs_err={max_abs:.3e} rel_l2_err={rel:.3e} (tol "
        f"{atol} + {rtol}*|plain| per element, worst excess {worst - atol:.3e})")
    if worst > atol:
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
        ms = cuda_ms(lambda: A.flash_attention_bshd(qq, kk, vv, fixed_max=fm))
        pms = cuda_ms(lambda: A.flash_attention_bshd_plain(qq, kk, vv,
                                                           fixed_max=fm), 3)
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
    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import fused_prologue as P

    for fn in (A.flash_attention_bshd, P.rms_norm_rope, P.layer_norm_mod):
        fn.launches = 0
    return {"flash_attention_bshd": A.flash_attention_bshd,
            "rms_norm_rope": P.rms_norm_rope,
            "layer_norm_mod": P.layer_norm_mod}


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
    counts = reset_counts()
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
    counts = reset_counts()
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
    log(f"all phases passed in {time.time() - t0:.1f} s")

    meta = {
        "flash_attention_bshd": ("cuda", "magcache_tpu_torch/csrc/flash_attention.cu",
                                 "magcache_tpu/ops/attention.py:430"),
        "rms_norm_rope": ("triton", "magcache_tpu_torch/csrc/prologue_triton.py",
                          "magcache_tpu/ops/fused_prologue.py:342"),
        "layer_norm_mod": ("triton", "magcache_tpu_torch/csrc/prologue_triton.py",
                           "magcache_tpu/ops/fused_prologue.py:440"),
    }
    kernels = []
    for name, (route, source, replaces) in meta.items():
        err, ms, pms = rec[name]
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": pms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
