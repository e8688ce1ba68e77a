"""``python -m magcache_tpu_torch.cli.evaluate``: the quality gate, cached
runs against full-compute goldens (the reference's
``eval/magcache/common_metrics/eval.py:76-150`` pair flow and the
``batch_eval.py`` directory walker).

  # paired directories of .npy videos; LPIPS on the card (--device cuda,
  # the default), PSNR and SSIM on the host
  python -m magcache_tpu_torch.cli.evaluate --cached out/magcache --golden out/full \\
      --lpips_weights lpips_alex.pth --report report.txt

  # the self-check: tiny models on the CPU only (their head dims are not
  # ones the kernels take), full compute against each cache, one seed
  python -m magcache_tpu_torch.cli.evaluate --self_check --device cpu --json EVAL.json
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser("magcache_tpu_torch evaluate")
    p.add_argument("--cached", help="dir of cached-run .npy videos")
    p.add_argument("--golden", help="dir of full-compute .npy videos")
    p.add_argument("--lpips_weights",
                   help="an lpips.LPIPS(net='alex') checkpoint; without it LPIPS is "
                        "dropped (a random backbone cannot gate quality)")
    p.add_argument("--metrics", default="psnr,ssim,lpips")
    p.add_argument("--report", help="write a text report here")
    p.add_argument("--json", help="write the aggregate JSON here")
    p.add_argument("--self_check", action="store_true",
                   help="tiny-model full-against-cached self-consistency run")
    p.add_argument("--decode", action="store_true",
                   help="self_check: also decode the Wan latents through one random "
                        "tiny Wan VAE and report pixel-space decoded_* metrics")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="torch device for LPIPS; 'cuda' (default) needs a card. "
                        "--self_check runs on 'cpu' only")
    return p


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def _norm_latents(lat) -> np.ndarray:
    """Latents as ``[T, H, W, <=3]`` frames, unnormalised: the pair shares
    one min-max in ``_latent_metrics``, so a global magnitude drift shows.
    The resulting PSNR / SSIM are latent-space numbers (random weights, no
    decode): a structural cache gate, keyed ``latent_``."""
    lat = np.asarray(lat)
    while lat.ndim > 4:
        lat = lat[0]
    if lat.ndim == 3:                       # [H, W, C] image -> 1-frame video
        lat = lat[None]
    return lat[..., :3].astype(np.float32)


def _skip_count(skips) -> dict:
    """Skipped and total lane-forwards (and sections, for a section loop's
    ``[sections, steps, lanes]`` bits)."""
    a = np.asarray(skips).astype(bool)
    out = {"skipped": int(a.sum()), "total": int(a.size)}
    if a.ndim == 3:
        out["sections"] = int(a.shape[0])
    return out


def _latent_metrics(a, b) -> dict:
    from magcache_tpu_torch.eval.compare import compare_videos

    lo = min(a.min(), b.min())
    hi = max(a.max(), b.max())
    sc = max(hi - lo, 1e-8)
    m = compare_videos(((a - lo) / sc).astype(np.float32),
                       ((b - lo) / sc).astype(np.float32), metrics=("psnr", "ssim"))
    return {f"latent_{k}": v for k, v in m.items()}


def _run_variants(label, variants, build, generate, to_frames, times) -> tuple:
    """Each variant's pipeline (``build(variant, model)``, sharing the first
    one's weights) and output: ``(frames, skips, raw latents)`` by variant;
    the cached variants record their realized skip bits."""
    frames, skips, raw, model = {}, {}, {}, None
    for variant in variants:
        pipe = build(variant, model)
        model = pipe.model
        t0 = time.time()
        out = generate(pipe)
        times[f"{label}_{variant}"] = time.time() - t0
        raw[variant] = _host(out.latents)
        frames[variant] = _norm_latents(to_frames(pipe, out.latents))
        if variant != "full" and out.skips is not None:
            skips[variant] = _skip_count(out.skips)
    return frames, skips, raw


def _self_check(args) -> dict:
    """Full compute against cached variants on tiny models at one seed: the
    structural analogue of the reference's golden comparison, without
    checkpoints. Every cached variant records its realized skip bits, and
    the check fails when a comparator skipped nothing (a cached run that
    never caches is no evidence). Thresholds are forced to values that
    skip on a random tiny model: they gate the mechanism, not quality."""
    from magcache_tpu_torch.models.flux import unpack_latents
    from magcache_tpu_torch.pipelines.flux import FluxPipeline, FluxPipelineConfig
    from magcache_tpu_torch.pipelines.framepack import (FramePackPipeline,
                                                        FramePackPipelineConfig)
    from magcache_tpu_torch.pipelines.omnigen2 import (OmniGen2Pipeline,
                                                       OmniGen2PipelineConfig)
    from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

    dev, steps, seed = args.device, args.steps, args.seed   # "cpu": main() refuses others
    prompt = "a calico cat on a windowsill"
    result = {
        "mode": ("tiny-self-consistency (random init; latent-space metrics; "
                 "structural cache gate only; thresholds forced to skip)"),
        "steps": steps,
        "seed": seed,
    }
    times = {}
    lat_frames = lambda pipe, lat: _host(lat)

    # ---- Wan t2v (UniPC, two lanes): full / magcache / teacache ----------
    def wan(variant, model):
        # a loose threshold and a low retention floor skip at 8 steps; the
        # TeaCache polynomial gives O(1e4) on random weights, so its gate
        # takes an enormous threshold: every step inside the window skips
        return WanPipeline(WanPipelineConfig(
            task="t2v", tiny=True, size=(64, 64), frame_num=9, sample_steps=steps,
            sample_solver="unipc", dtype="float32", use_magcache=variant == "magcache",
            magcache_thresh=0.3, retention_ratio=0.1,
            enable_teacache=variant == "teacache", teacache_thresh=1e9), dev, model=model)

    outs, skips, raw = _run_variants("wan", ("full", "magcache", "teacache"), wan,
                                     lambda p: p.generate(prompt, seed=seed), lat_frames,
                                     times)
    result["wan"] = {"magcache_vs_full": _latent_metrics(outs["magcache"], outs["full"]),
                     "teacache_vs_full": _latent_metrics(outs["teacache"], outs["full"]),
                     "skips": skips}
    if args.decode:
        # pixel space through one random tiny Wan VAE (a fixed nonlinear map)
        import torch

        from magcache_tpu_torch.eval.compare import compare_videos
        from magcache_tpu_torch.models.vae_wan import WanVAE, WanVAEConfig

        vae = WanVAE(WanVAEConfig.tiny(z_channels=16), dev).init(
            torch.Generator(device=dev).manual_seed(7)).requires_grad_(False)
        with torch.inference_mode():
            dec = {v: ((np.clip(_host(vae.decode(torch.from_numpy(lat).to(dev)))[0], -1, 1)
                        + 1) / 2).astype(np.float32) for v, lat in raw.items()}
        for v in ("magcache", "teacache"):
            result["wan"][f"decoded_{v}_vs_full"] = compare_videos(
                dec[v], dec["full"], metrics=("psnr", "ssim"))

    # ---- Wan2.2 ti2v (latent replacement, per-token t): full / magcache ---
    img = (np.random.default_rng(seed).random((32, 64, 3)) * 255).astype(np.uint8)

    def ti2v(variant, model):
        return WanPipeline(WanPipelineConfig(
            model="wan2.2-ti2v-5B-i2v", task="ti2v", tiny=True, size=(64, 32), frame_num=9,
            sample_steps=steps, sample_solver="unipc", sample_shift=5.0, dtype="float32",
            use_magcache=variant == "magcache", magcache_thresh=0.3, retention_ratio=0.1),
            dev, model=model)

    touts, tskips, _ = _run_variants("ti2v", ("full", "magcache"), ti2v,
                                     lambda p: p.generate(prompt, seed=seed, image=img),
                                     lat_frames, times)
    result["ti2v"] = {"magcache_vs_full": _latent_metrics(touts["magcache"], touts["full"]),
                      "skips": tskips}

    # ---- FLUX (one lane, Euler): full / magcache --------------------------
    def flux(variant, model):
        return FluxPipeline(FluxPipelineConfig(
            tiny=True, height=64, width=64, txt_len=32, num_inference_steps=steps,
            dtype="float32", use_magcache=variant == "magcache", magcache_thresh=0.3,
            retention_ratio=0.1), dev, model=model)

    fouts, fskips, _ = _run_variants(
        "flux", ("full", "magcache"), flux, lambda p: p.generate(prompt, seed=seed),
        lambda pipe, lat: _host(unpack_latents(lat, *pipe.grid)), times)
    result["flux"] = {"magcache_vs_full": _latent_metrics(fouts["magcache"], fouts["full"]),
                      "skips": fskips}

    # ---- FramePack (a section loop): full / teacache ----------------------
    def framepack(variant, model):
        return FramePackPipeline(FramePackPipelineConfig(
            tiny=True, pyramid=False, height=64, width=64, txt_len=16,
            latent_window_size=3, total_sections=2, steps=steps,
            use_teacache=variant == "teacache", teacache_thresh=1e9), dev, model=model)

    pouts, pskips, _ = _run_variants("framepack", ("full", "teacache"), framepack,
                                     lambda p: p.generate(prompt, seed=seed), lat_frames,
                                     times)
    result["framepack"] = {"teacache_vs_full": _latent_metrics(pouts["teacache"],
                                                               pouts["full"]),
                           "skips": pskips}

    # ---- OmniGen2 (three branches): full / taylorseer ---------------------
    def omnigen2(variant, model):
        return OmniGen2Pipeline(OmniGen2PipelineConfig(
            tiny=True, height=128, width=128, num_inference_steps=steps, dtype="float32",
            enable_taylorseer=variant == "taylorseer", taylorseer_warmup=2,
            taylorseer_interval=3), dev, model=model)

    oouts, oskips, _ = _run_variants("omnigen2", ("full", "taylorseer"), omnigen2,
                                     lambda p: p.generate(prompt, seed=seed), lat_frames,
                                     times)
    result["omnigen2"] = {"taylorseer_vs_full": _latent_metrics(oouts["taylorseer"],
                                                                oouts["full"]),
                          "skips": oskips}

    # ---- the gate: a comparator that never skipped proves nothing ---------
    for fam, key in (("wan", "magcache"), ("wan", "teacache"), ("ti2v", "magcache"),
                     ("flux", "magcache"), ("framepack", "teacache"),
                     ("omnigen2", "taylorseer")):
        sc = result[fam]["skips"].get(key)
        if not sc or sc["skipped"] == 0:
            raise SystemExit(f"self-check: {fam}/{key} performed zero skips")

    # the round-2 artifact's top-level aliases, as JAX writes them
    result["metrics_magcache_vs_full"] = result["wan"]["magcache_vs_full"]
    result["metrics_teacache_vs_full"] = result["wan"]["teacache_vs_full"]
    result["seconds"] = times
    return result


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    device = torch.device(args.device)
    if args.self_check and device.type != "cpu":
        raise SystemExit(f"--self_check on {args.device}: the toy models' head dims are "
                         "not ones the kernels take; pass --device cpu to run it on the "
                         "plain ops")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    if args.lpips_weights:
        from magcache_tpu_torch.eval.metrics import load_lpips_weights

        load_lpips_weights(args.lpips_weights, device=device)

    if args.self_check:
        result = _self_check(args)
    else:
        if not (args.cached and args.golden):
            raise SystemExit("--cached and --golden are required (or --self_check)")
        from magcache_tpu_torch.eval.compare import compare_dirs, write_report

        metrics = [m for m in args.metrics.split(",") if m]
        if "lpips" in metrics and not args.lpips_weights:
            print("note: dropping lpips (no --lpips_weights; a random backbone "
                  "cannot gate quality)")
            metrics = [m for m in metrics if m != "lpips"]
        result = compare_dirs(args.cached, args.golden, metrics=metrics, device=device)
        if args.report:
            write_report(result, args.report)

    print(json.dumps(result if "per_video" not in result else result["mean"], indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
