"""Times K2 (``rms_norm_rope``, token and head scope), K3 and K3p
(``layer_norm_mod``) at every shape of PERF.md's kernel table, and the
forwards they run in, on one card; with ``--turns DIR``, another checkout's
in turns.

    python tools/time_prologue_kernels.py [--tree DIR] [--forwards] [--json PATH]
    python tools/time_prologue_kernels.py --turns build/parent [--forwards]

``--tree DIR`` (default: this checkout) times the ``magcache_tpu_torch``
of DIR, e.g. ``git archive`` of the parent unpacked under ``build/``: only
the wrappers' public signatures are used, which both keep. At each shape:
the device time of one call from a CUDA graph of 20 calls ("graph"), the
time of one of 20 back-to-back wrapper calls between CUDA events ("loop":
the host's dispatch included), the least time the card could take (bytes
over 3.35 TB/s, each input read once and the output written once) and,
where one PyTorch call computes the same function, its graph time
(``F.layer_norm``: affine with bf16 weight and bias, plain, and mod where
every sample has one modulation row, as weight 1 + scale and bias shift).
At the launch-bound 2x256x3,072 also the host's time for one wrapper call
(1,000 calls, no synchronisation between them).

``--forwards`` adds, with the tree's ``chip_smoke.py`` helpers: the
FLUX.1-dev forward at 1024x1024 under ``torch.profiler`` (wall time, device
busy time, idle share), the Qwen-Image text-to-image forward at 1664x928,
the Wan2.1-1.3B forward at 832x480x81 and one ``OPEN_SORA_PAB`` request on
the packed route at 480p 9:16 x 17 frames, 30 steps (seconds a video); each
the second of two calls.

``--turns DIR`` runs this script on DIR, on this checkout, on this checkout
and on DIR again, one process each (the order cancels a drift of the
card), writes each run's JSON under ``--out_dir`` (default
``build/prologue_timing/``) and prints every shape side by side. The
card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_TBPS = 3.35          # H100 SXM HBM3


def _args():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", default=ROOT, help="the checkout whose port is timed")
    p.add_argument("--forwards", action="store_true", help="also the end-to-end forwards")
    p.add_argument("--json", default=None, help="write the results here")
    p.add_argument("--turns", default=None,
                   help="a second checkout: time it and this one in turns")
    p.add_argument("--out_dir", default=os.path.join(ROOT, "build", "prologue_timing"),
                   help="where --turns writes each run's JSON")
    return p.parse_args()


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def graph_ms(torch, fn, reps: int = 20) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def loop_ms(torch, fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(torch, fn, calls: int = 1000) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def kernel_shapes():
    """``(kernel, label, kind, params)`` for every row of PERF.md's K2, K2h,
    K3 and K3p entries. kind "k2": (b, s, heads); "k2h": (b, s, row, col);
    "k3": (b, s, d, mode, one_row)."""
    k2 = [("K2", f"Wan {b}x{s}x{h * 128}", "k2", (b, s, h)) for b, s, h in (
        (2, 32760, 12), (2, 32760, 40), (2, 27280, 24), (4, 7800, 12))]
    k2h = [("K2h", label, "k2h", p) for label, p in (
        ("FLUX image q 1x4096 (rows of 9216)", (1, 4096, 9216, 0)),
        ("FLUX text k 1x512 (rows of 9216)", (1, 512, 9216, 3072)),
        ("FLUX single-block q 1x4608 (rows of 21504)", (1, 4608, 21504, 0)),
        ("HunyuanVideo image q 1x118800 (rows of 9216)", (1, 118800, 9216, 0)),
        ("HunyuanVideo text k 1x256 (rows of 9216)", (1, 256, 9216, 3072)),
        ("HunyuanVideo single-block q 1x119056 (rows of 21504)", (1, 119056, 21504, 0)),
        ("FramePack image q 1x17664 (rows of 9216)", (1, 17664, 9216, 0)),
        ("Qwen-Image image q 2x6032 (rows of 9216)", (2, 6032, 9216, 0)),
        ("Qwen-Image text k 2x256 (rows of 9216)", (2, 256, 9216, 3072)),
        ("Qwen-Image-Edit image q 2x12064 (rows of 9216)", (2, 12064, 9216, 0)))]
    k3 = [(("K3p" if mode == "plain" else "K3"), f"{label} {b}x{s}x{d} {mode}", "k3",
           (b, s, d, mode, one))
          for label, b, s, d, modes, one in (
              ("Wan", 2, 32760, 1536, ("mod", "affine", "plain"), False),
              ("STDiT3 temporal 480p", 2, 23850, 1152, ("mod",), False),
              ("STDiT3 temporal 720p", 2, 54000, 1152, ("mod",), False),
              ("Latte", 2, 16384, 1152, ("mod",), False),
              ("FLUX", 1, 4096, 3072, ("mod",), True),
              ("Wan micro-batch", 4, 7800, 1536, ("mod", "affine"), False),
              ("I2V-14B", 2, 32760, 5120, ("mod", "affine", "plain"), False),
              ("TI2V-5B", 2, 27280, 3072, ("mod", "affine", "plain"), False),
              ("TI2V-5B t = 0 prefix", 2, 880, 3072, ("mod",), False),
              ("HunyuanVideo", 1, 118800, 3072, ("mod",), True),
              ("Qwen-Image image stream", 2, 6032, 3072, ("mod",), True),
              ("Qwen-Image text stream", 2, 256, 3072, ("mod",), True),
              ("Open-Sora 480p x 17", 2, 7950, 1152, ("mod",), False))
          for mode in modes]
    return k2 + k2h + k3


def time_kernels(torch, dev):
    import torch.nn.functional as F

    from magcache_tpu_torch.ops import fused_prologue as P

    gen = torch.Generator(device=dev).manual_seed(26)
    bf = torch.bfloat16

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    out = []
    for kernel, label, kind, p in kernel_shapes():
        lib = None
        host = None
        if kind in ("k2", "k2h"):
            if kind == "k2":
                b, s, h = p
                x = rnd(b, s, h * 128, scale=2.0)
                gain, scope = 1.0 + rnd(h * 128, dtype=torch.float32, scale=0.1), "token"
            else:
                b, s, row, col = p
                h = 24
                x = rnd(b, s, row, scale=2.0)[..., col:col + 3072]
                gain, scope = 1.0 + rnd(128, dtype=torch.float32, scale=0.1), "head"
            cos, sin = rnd(s, 64, dtype=torch.float32), rnd(s, 64, dtype=torch.float32)

            def fn():
                return P.rms_norm_rope(x, gain, cos, sin, h, eps=1e-6, norm_scope=scope)

            moved = 2 * b * s * h * 128 * 2 + 4 * (gain.numel() + cos.numel() + sin.numel())
            if kind == "k2h" and (b, s) == (2, 256):
                host = host_us(torch, fn)
        else:
            b, s, d, mode, one = p
            x = rnd(b, s, d, scale=2.0)
            if mode == "mod":
                if one:
                    sc, sh = (rnd(1, 1, d, dtype=torch.float32, scale=0.3).expand(b, 1, d)
                              for _ in "ab")
                else:
                    sc, sh = (rnd(b, 1, d, dtype=torch.float32, scale=0.3) for _ in "ab")
                kw = dict(scale=sc, shift=sh)
                tables = 2 * (1 if one else b) * d
                if one:
                    wb, bb = (1.0 + sc[0]).view(-1).to(bf), sh[0].view(-1).to(bf)
                    lib = lambda: F.layer_norm(x, (d,), wb, bb, eps=1e-6)   # noqa: E731
            elif mode == "affine":
                w, bias = 1.0 + rnd(d, dtype=torch.float32, scale=0.1), rnd(
                    d, dtype=torch.float32, scale=0.1)
                kw, tables = dict(weight=w, bias=bias), 2 * d
                wb, bb = w.to(bf), bias.to(bf)
                lib = lambda: F.layer_norm(x, (d,), wb, bb, eps=1e-6)   # noqa: E731
            else:
                kw, tables = {}, 0
                lib = lambda: F.layer_norm(x, (d,), eps=1e-6)           # noqa: E731

            def fn():
                return P.layer_norm_mod(x, eps=1e-6, **kw)

            moved = 2 * x.numel() * 2 + 4 * tables
            if (b, s, d) == (2, 256, 3072):
                host = host_us(torch, fn)
        r = {"kernel": kernel, "shape": label, "graph_ms": graph_ms(torch, fn),
             "loop_ms": loop_ms(torch, fn), "bound_ms": moved / (HBM_TBPS * 1e9),
             "library_ms": graph_ms(torch, lib) if lib else None, "host_us": host}
        out.append(r)
        print(f"  {kernel:4s} {label:58s} graph {r['graph_ms']:.4f}  loop {r['loop_ms']:.4f}  "
              f"bound {r['bound_ms']:.4f}"
              + (f"  F.layer_norm {r['library_ms']:.4f}" if lib else "")
              + (f"  host {host:.1f} us a call" if host else ""), flush=True)
        del x
        torch.cuda.empty_cache()
    return out


def time_forwards(torch, dev):
    """The end-to-end numbers, built with the timed tree's chip_smoke.py."""
    import chip_smoke as cs

    res = {}

    def second_of_two(fn):
        fn()
        _, ms = cs.timed_once(fn)
        return ms / 1e3

    # FLUX.1-dev, profiled
    from magcache_tpu_torch.models.flux import make_flux_core

    model = cs.make_flux_model(dev)
    core = make_flux_core(model, cs.FLUX_TXT, *cs.FLUX_GRID)
    gen = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn((1, 4096, 64), generator=gen, device=dev)
    t = torch.full((1,), 900.0, device=dev)
    cond = cs._flux_cond(dev, "a red fox in fresh snow")

    def flux():
        hidden, c = core.prepare(x, t, cond)
        return core.head(core.trunk(hidden, c), c)

    res["flux_forward_s"] = second_of_two(flux)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        flux()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.device_time_total for e in prof.key_averages() if e.device_time_total > 0
               and e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    res.update(flux_profiled_wall_ms=wall, flux_busy_ms=busy,
               flux_idle_share=max(0.0, 1 - busy / wall))
    del model, core
    torch.cuda.empty_cache()

    # Qwen-Image text-to-image
    from magcache_tpu_torch.models.qwen_image import make_qwen_image_core
    from magcache_tpu_torch.models.text import MockTextEncoder

    model = cs.make_qwen_model(dev)
    gh, gw = cs.QI_GRID
    core = make_qwen_image_core(model, cs.QI_TXT, gh, gw, ref_images=0)
    gen = torch.Generator(device=dev).manual_seed(77)
    txt = MockTextEncoder(cs.QI_TXT, 3584, scale=0.5)([cs.TEXT_PROMPTS[0], " "], device=dev)
    x = torch.randn((2, gh * gw, 64), generator=gen, device=dev)
    t = torch.full((2,), 900.0, device=dev)

    def qwen():
        hidden, c = core.prepare(x, t, {"txt": txt})
        return core.head(core.trunk(hidden, c), c)

    res["qwen_image_forward_s"] = second_of_two(qwen)
    del model, core
    torch.cuda.empty_cache()

    # Wan2.1-1.3B at 832x480x81
    from magcache_tpu_torch.models.text import MockTextEncoder as Mock
    from magcache_tpu_torch.models.wan import make_wan_core

    model = cs.make_model(dev)
    core = make_wan_core(model, (21, 30, 52))
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((2, 21, 60, 104, 16), generator=gen, device=dev)
    t = torch.full((2,), 900.0, device=dev)
    ctx = Mock(512, 4096, scale=0.5)(["a cat", ""], device=dev)

    def wan():
        hidden, c = core.prepare(x, t, {"context": ctx})
        return core.head(core.trunk(hidden, c), c)

    res["wan_forward_s"] = second_of_two(wan)
    del model, core
    torch.cuda.empty_cache()

    # OPEN_SORA_PAB, packed route, 480p 9:16 x 17, 30 steps
    from magcache_tpu_torch.pipelines.open_sora import OpenSoraPipeline, OpenSoraPipelineConfig

    model = cs.make_os_model(dev)
    pipe = OpenSoraPipeline(OpenSoraPipelineConfig(
        route="packed", resolution="480p", aspect_ratio="9:16", num_frames=cs.OS17_FRAMES,
        num_sampling_steps=cs.OS_STEPS, cfg_scale=7.0, dtype="bfloat16", enable_pab=True),
        dev, model=model)
    secs = []
    for _ in range(2):
        out = pipe.generate(cs.OS17_PROMPT, seed=3)
        secs.append(out.timings["total_s"])
    res["open_sora_pab_480p17_s"] = secs[-1]
    for k, v in res.items():
        print(f"  {k}: {v:.4f}", flush=True)
    return res


def ptxas_lines(build_dir: str):
    """ptxas's register and spill lines of the prologue kernels."""
    out = []
    for log in glob.glob(os.path.join(build_dir, "*.so.log")):
        lines = open(log).read().splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and (
                    "layer_norm_kernel" in line or "rms_norm_rope_kernel" in line):
                out.append(line.split("'")[1])
                out += [ln.strip() for ln in lines[i + 1:i + 4]
                        if "registers" in ln or "spill" in ln]
    return out


def run_one(args):
    sys.path.insert(0, os.path.abspath(args.tree))
    os.chdir(os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this script times the kernels on one")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from magcache_tpu_torch.ops.build import BUILD_DIR, load_cuda_library

    print(card(), flush=True)
    print(f"tree {os.path.abspath(args.tree)}", flush=True)
    t0 = time.time()
    load_cuda_library()
    print(f"  library built in {time.time() - t0:.1f} s", flush=True)
    for line in ptxas_lines(BUILD_DIR):
        print(f"  ptxas: {line}", flush=True)
    res = {"card": card(), "tree": os.path.abspath(args.tree),
           "kernels": time_kernels(torch, dev)}
    if args.forwards:
        res["forwards"] = time_forwards(torch, dev)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)


def run_turns(args):
    out_dir = os.path.abspath(args.out_dir)
    os.makedirs(out_dir, exist_ok=True)
    print(card(), flush=True)
    runs = []
    for i, (tag, tree) in enumerate((("parent", args.turns), ("change", ROOT),
                                     ("change", ROOT), ("parent", args.turns))):
        path = os.path.join(out_dir, f"prologue_{i}_{tag}.json")
        cmd = [sys.executable, os.path.abspath(__file__), "--tree", tree, "--json", path]
        cmd += ["--forwards"] if args.forwards else []
        print(f"== run {i}: {tag} ({tree})", flush=True)
        proc = subprocess.run(cmd, cwd=ROOT)
        if proc.returncode:
            raise SystemExit(f"run {i} ({tag}) failed with {proc.returncode}")
        with open(path) as f:
            runs.append((tag, json.load(f)))
    print_turns(runs, args.forwards)


def print_turns(runs, forwards: bool) -> None:
    """Every shape's times, parent's runs beside the change's."""
    print("\nshape | parent graph ms (runs 0, 3) | change graph ms (runs 1, 2) | parent loop "
          "| change loop | bound | F.layer_norm | host us parent / change")
    for j, r in enumerate(runs[0][1]["kernels"]):
        by = {tag: [] for tag in ("parent", "change")}
        for tag, res in runs:
            by[tag].append(res["kernels"][j])
        fmt = lambda rs, k: " / ".join("-" if x[k] is None else f"{x[k]:.4f}" for x in rs)  # noqa: E731
        host = ("" if r["host_us"] is None else
                f" | {fmt(by['parent'], 'host_us')} / {fmt(by['change'], 'host_us')}")
        print(f"{r['kernel']} {r['shape']} | {fmt(by['parent'], 'graph_ms')} | "
              f"{fmt(by['change'], 'graph_ms')} | {fmt(by['parent'], 'loop_ms')} | "
              f"{fmt(by['change'], 'loop_ms')} | {r['bound_ms']:.4f} | "
              f"{fmt(by['change'], 'library_ms')}{host}")
    if forwards:
        for key in runs[0][1]["forwards"]:
            vals = [f"{tag} {res['forwards'][key]:.4f}" for tag, res in runs]
            print(f"{key}: " + ", ".join(vals))


if __name__ == "__main__":
    a = _args()
    if a.turns:
        run_turns(a)
    else:
        run_one(a)
