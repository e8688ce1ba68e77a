"""Where one DiT forward spends its device time, on one NVIDIA card.

    python tools/profile_torch_forward.py [--model wan|open-sora|flux|latte|vae|umt5]
        [--frames N] [--resolution 480p|720p] [--route packed|grouped|vpu]
        [--no_qk_norm] [--top 15]

Builds the model (bf16, random seeded weights) from ``magcache_tpu_torch``:
WAN_1_3B at 832x480 (default 81 frames, 2 CFG lanes), STDiT3-XL/2 at the
Open-Sora 9:16 bucket of ``--resolution`` (default 480p, 51 frames, the joint
CFG batch of 2; 720p is 1280x720, frames of 3,600 tokens through K1q; on
``--route``, and without qk-norm with ``--no_qk_norm``), FLUX.1-dev at
1024x1024 (4,096 image + 512 text tokens, one row) or Latte-1 at 512x512 (default
16 frames, the joint CFG batch of 2, 120 caption tokens) on ``--route``;
or Wan's ends: the Wan2.1 VAE decoding 832x480 latents (default 81 frames,
streamed one latent frame a call, ``--vae_dtype``) or UMT5-XXL (f32)
encoding 2 prompts x 512 tokens. Runs one warm-up forward (prepare -> trunk
-> head; the decode; the encode) and traces a second with ``torch.profiler``.
Prints the wall time, the summed device time, the device's idle share of the
wall time, and the kernels with the most device time. Needs a card: exits
nonzero without one.
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
    p.add_argument("--model", choices=["wan", "open-sora", "flux", "latte", "vae", "umt5"],
                   default="wan")
    p.add_argument("--frames", type=int, default=None,
                   help="pixel frames (default 81 for Wan, 51 for Open-Sora, 16 for "
                        "Latte)")
    p.add_argument("--resolution", default="480p",
                   help="open-sora bucket resolution (480p, 720p)")
    p.add_argument("--route", default="packed", choices=["packed", "grouped", "vpu"],
                   help="latte block composition")
    p.add_argument("--vae_dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--no_qk_norm", action="store_true",
                   help="open-sora: STDiT3 with qk_norm=False")
    p.add_argument("--top", type=int, default=15)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from magcache_tpu_torch.models.text import MockTextEncoder

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    # f32 work (the VAE's convolutions, UMT5's GEMMs) in plain f32, as
    # chip_smoke.py runs it
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    g = torch.Generator(device=dev).manual_seed(1)
    rows = 1 if args.model == "flux" else 2
    t = torch.full((rows,), 900.0, device=dev)
    if args.model == "wan":
        from magcache_tpu_torch.models.wan import WAN_1_3B, WanModel, make_wan_core

        model = WanModel(dataclasses.replace(WAN_1_3B, dtype="bfloat16"), dev).init(gen)
        lat_f = ((args.frames or 81) - 1) // 4 + 1
        grid = (lat_f, 30, 52)
        core = make_wan_core(model, grid)
        x = torch.randn((2, lat_f, 60, 104, 16), generator=g, device=dev)
        cond = {"context": MockTextEncoder(512, 4096, 0.5)(["a cat", ""], device=dev)}
    elif args.model in ("vae", "umt5"):
        grid = rows = None
    elif args.model == "flux":
        from magcache_tpu_torch.models.flux import FLUX_DEV, FluxModel, make_flux_core
        from magcache_tpu_torch.models.text import MockPooledEncoder

        model = FluxModel(dataclasses.replace(FLUX_DEV, dtype="bfloat16"), dev).init(gen)
        grid = (1, 64, 64)
        core = make_flux_core(model, 512, 64, 64)
        x = torch.randn((1, 4096, 64), generator=g, device=dev)
        cond = {"txt": MockTextEncoder(512, 4096, 0.5)(["a fox"], device=dev),
                "vec": MockPooledEncoder(768)(["a fox"], device=dev),
                "guidance": torch.full((1,), 3.5, device=dev)}
    elif args.model == "latte":
        from magcache_tpu_torch.models.latte import LATTE_1, LatteModel, make_latte_core

        model = LatteModel(dataclasses.replace(LATTE_1, dtype="bfloat16"), dev).init(gen)
        grid = (args.frames or 16, 32, 32)
        core = make_latte_core(model, grid, 120, route=args.route)
        x = torch.randn((2, grid[0], 64, 64, 4), generator=g, device=dev)
        cond = {"y": MockTextEncoder(120, 4096, 0.5)(["a boat", ""], device=dev)}
    else:
        from magcache_tpu_torch.models.stdit3 import (STDIT3_XL_2, STDiT3Model,
                                                      make_stdit3_core)
        from magcache_tpu_torch.pipelines.open_sora_cond import (get_image_size,
                                                                 get_latent_t)

        model = STDiT3Model(dataclasses.replace(STDIT3_XL_2, dtype="bfloat16",
                                                qk_norm=not args.no_qk_norm), dev).init(gen)
        lat_t = get_latent_t(args.frames or 51)
        height, width = get_image_size(args.resolution, "9:16")
        grid = (lat_t, height // 16, width // 16)
        core = make_stdit3_core(model, grid, route=args.route, pixel_size=(height, width))
        x = torch.randn((2, lat_t, height // 8, width // 8, 4), generator=g, device=dev)
        cond = {"y": MockTextEncoder(300, 4096, 0.5)(["a boat", ""], device=dev),
                "fps": torch.full((2,), 24.0, device=dev)}

    def forward():
        hidden, ctx = core.prepare(x, t, cond)
        return core.head(core.trunk(hidden, ctx), ctx)

    what = None if grid is None else f"{grid[0] * grid[1] * grid[2]} tokens x {rows} rows"
    if args.model == "vae":
        from magcache_tpu_torch.models.vae_wan import WAN21_VAE, WanVAE

        vae = WanVAE(dataclasses.replace(WAN21_VAE, dtype=args.vae_dtype), dev).init(gen)
        lat_f = ((args.frames or 81) - 1) // 4 + 1
        z = torch.randn((1, lat_f, 60, 104, 16), generator=g, device=dev)
        what = f"latents {tuple(z.shape)}, {args.vae_dtype}"

        def forward():
            return vae.decode(z)
    elif args.model == "umt5":
        from magcache_tpu_torch.models.text import FallbackHashTokenizer
        from magcache_tpu_torch.models.umt5 import UMT5_XXL, UMT5Encoder

        enc = UMT5Encoder(UMT5_XXL, tokenizer=FallbackHashTokenizer(UMT5_XXL.vocab_size),
                          device=dev, generator=gen)
        what = "2 prompts x 512 tokens, f32"

        def forward():
            return enc(["a cat", "a dog"])

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
    print(f"{args.model}: {what}: wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:args.top]:
        ms = e.device_time_total / 1e3
        print(f"  {ms:9.2f} ms  {100 * ms / busy_ms:5.1f}%  x{e.count:<5d} {e.key[:90]}")


if __name__ == "__main__":
    main()
