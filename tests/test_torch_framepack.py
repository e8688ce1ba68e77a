"""The port's FramePack / HunyuanVideo pipeline (``pipelines/framepack.py``)
and its CLI tasks against the JAX package on the CPU: two-section runs in
the padded, F1 and flat-history modes with the JAX package's per-section
noise fed in (latents, the per-section MagCache bits and their reset, the
start latent, ``on_section``), TeaCache, calibration's cross-section
residual carry, the MagCache/TeaCache ValueError; the CLI's ``hunyuan``,
``framepack`` and ``framepack-f1`` tasks with their aliases, the dash
spelling, ``--image`` and the pyramid canvas check.

The JAX pipeline hands its core ``sigma * 1000``, which its FLUX core
embeds times 1000 again (``test_torch_hunyuan.py``): it runs here with
its schedule's timesteps divided by 1000 and its refiner patched to undo
that, so both sides embed ``sigma * 1000`` everywhere.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.models import hunyuan as JH
from magcache_tpu.pipelines import framepack as JP
from magcache_tpu.schedulers.flow_match import FlowMatchSchedule as JSchedule
from magcache_tpu_torch.cli import generate as cli
from magcache_tpu_torch.core.magcache import compute_skip_schedule
from magcache_tpu_torch.models.convert import hunyuan_params_from_numpy
from magcache_tpu_torch.models.hunyuan import HunyuanModel
from magcache_tpu_torch.pipelines import framepack as TP

# f32 on both sides over 6 Euler steps and 2 sections: GEMM and reduction
# order, held elementwise
F32_TOL = 2e-4
STEPS, SECTIONS = 6, 2


def _np(a):
    return np.array(a, np.float32)


class _FixedSchedule:
    """The JAX schedule with timesteps / 1000 (module doc)."""

    @staticmethod
    def create(n, **kw):
        s = JSchedule.create(n, **kw)
        return dataclasses.replace(s, timesteps=(s.timesteps / 1000).astype(np.float32))


def _pair(monkeypatch, **kw):
    orig = JH._refine_text
    monkeypatch.setattr(JH, "_refine_text",
                        lambda cfg, params, txt, t: orig(cfg, params, txt, t * 1000.0))
    monkeypatch.setattr(JP, "FlowMatchSchedule", _FixedSchedule)
    base = dict(tiny=True, height=64, width=64, latent_window_size=2,
                total_sections=SECTIONS, steps=STEPS, txt_len=8, dtype="float32")
    base.update(kw)
    jp = JP.FramePackPipeline(JP.FramePackPipelineConfig(**base))
    jp.record_skips = True
    tcfg = TP.FramePackPipelineConfig(**base)
    model = HunyuanModel(tcfg.model_config(), "cpu")
    model.load_state_dict(hunyuan_params_from_numpy(
        jax.tree.map(np.asarray, jp.params), tcfg.model_config(), "cpu"))
    return jp, TP.FramePackPipeline(tcfg, "cpu", model=model)


def _jax_draws(seed, shape, n=SECTIONS):
    """The JAX pipeline's section noise: one split of the seed's key each."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(_np(jax.random.normal(sub, shape, jnp.float32)))
    return out


def _run_both(jp, tp, seed=3, start=None):
    draws = _jax_draws(seed, (1,) + tp.lat_shape)
    seen = []
    want = jp.generate("a river at dawn", seed=seed,
                       start_latent=None if start is None else jnp.asarray(start))
    got = tp.generate("a river at dawn", seed=seed,
                      start_latent=None if start is None else torch.from_numpy(start),
                      on_section=lambda i, lat: seen.append((i, tuple(lat.shape))),
                      section_noise=lambda s, shape: torch.from_numpy(draws[s]))
    return want, got, seen


def _start(tp, seed=9):
    return np.random.default_rng(seed).standard_normal((1,) + tp.lat_shape[1:]).astype(np.float32)


@pytest.mark.parametrize("model,pyramid,kw", [
    ("framepack", True, dict(use_magcache=True)),
    ("framepack-f1", True, dict(use_magcache=True, magcache_thresh=0.3)),
    ("hunyuanvideo-544p", False, dict(use_magcache=True, history_frames=2)),
    ("framepack", True, dict(use_teacache=True, teacache_thresh=0.5))])
def test_pipeline_matches_jax(model, pyramid, kw, monkeypatch):
    jp, tp = _pair(monkeypatch, model=model, pyramid=pyramid, **kw)
    start = _start(tp)
    want, got, seen = _run_both(jp, tp, start=start)
    frames = SECTIONS * 2 + (1 if model == "framepack" else 0)   # padded: + the start
    assert got.latents.shape == (1, frames, 8, 8, 8) == want.latents.shape
    np.testing.assert_allclose(got.latents.numpy(), _np(want.latents), atol=F32_TOL,
                               rtol=F32_TOL)
    assert [i for i, _ in seen] == list(range(SECTIONS))
    np.testing.assert_array_equal(got.skips, np.asarray(want.skips))
    assert got.skips.shape == (SECTIONS, STEPS, 1)
    if kw.get("use_magcache"):
        # a fresh cache a section: every section realizes the whole schedule
        sched = compute_skip_schedule(tp.cache_cfg())
        assert sched.any()
        for bits in got.skips:
            np.testing.assert_array_equal(bits[:, 0], sched)
    else:
        # TeaCache computes the first and last step of every section
        assert got.skips.any() and not got.skips[:, [0, -1]].any()
    if model == "framepack":
        # padded: back to front, the last section (pad 0) leads with the start
        np.testing.assert_array_equal(got.latents[0, 0].numpy(), start[0])
        assert seen[-1][1][1] == 3 and len(tp._cores) == 2
    assert set(got.timings) == {"text_s", "sections", "total_s"}


def test_calibration_carries_the_residual_across_sections(monkeypatch):
    jp, tp = _pair(monkeypatch, pyramid=False, model="framepack", magcache_calibration=True)
    want, got, _ = _run_both(jp, tp)
    assert got.skips is None and want.skips is None
    # the first section's steps - 1 ratios, then all of the second's: the
    # boundary ratio against the first section's last residual is kept
    assert len(got.calibration["norm_ratio"]) == 2 * STEPS - 1
    for name, vals in got.calibration.items():
        np.testing.assert_allclose(vals, want.calibration[name], atol=2e-4)
    np.testing.assert_allclose(got.latents.numpy(), _np(want.latents), atol=F32_TOL,
                               rtol=F32_TOL)


def test_magcache_and_teacache_together_raise_and_configs_check():
    cfg = TP.FramePackPipelineConfig(tiny=True, height=64, width=64, latent_window_size=2,
                                     total_sections=1, steps=2, txt_len=8,
                                     use_magcache=True, use_teacache=True)
    pipe = TP.FramePackPipeline(cfg, "cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        pipe.generate("x")
    with pytest.raises(ValueError, match="divisible by 64"):
        TP.FramePackPipelineConfig(tiny=True, height=480, width=832)
    with pytest.raises(ValueError, match="one of"):
        TP.FramePackPipelineConfig(model="framepack-f2")
    flat = TP.FramePackPipeline(dataclasses.replace(cfg, pyramid=False, use_teacache=False),
                                "cpu")
    with pytest.raises(ValueError, match="framepack=True"):
        TP.FramePackPipeline(cfg, "cpu", model=flat.model)
    # the padding schedule, back to front (magcache_demo_gradio.py:493-505)
    assert [TP._paddings(n) for n in (1, 3, 4, 5, 7)] == [
        [0], [2, 1, 0], [3, 2, 1, 0], [3, 2, 2, 1, 0], [3, 2, 2, 2, 2, 1, 0]]


def test_seeded_noise_is_the_requests():
    cfg = TP.FramePackPipelineConfig(tiny=True, height=64, width=64, latent_window_size=2,
                                     total_sections=1, steps=2, txt_len=8, dtype="float32")
    pipe = TP.FramePackPipeline(cfg, "cpu")
    a, b = pipe.generate("a fox", seed=4), pipe.generate("a fox", seed=4)
    c = pipe.generate("a fox", seed=5)
    np.testing.assert_array_equal(a.latents.numpy(), b.latents.numpy())
    assert not np.allclose(a.latents.numpy(), c.latents.numpy())


# ---------------------------------------------------------------- CLI
# steps cut from 50 / 25 to keep the suite short: 5 sections x 8 steps
@pytest.mark.parametrize("task,steps,shape,skipped", [
    ("hunyuan", 12, (1, 2, 4, 4, 8), "skipped 8 of 12 forwards"),
    ("framepack", 8, (1, 11, 8, 8, 8), "skipped 20 of 40 forwards"),
    ("framepack-f1", 8, (1, 10, 8, 8, 8), "skipped 20 of 40 forwards")])
def test_cli_tasks_tiny(task, steps, shape, skipped, tmp_path, capsys):
    out = str(tmp_path / task)
    cli.main(["--task", task, "--tiny", "--device", "cpu", "--use_magcache",
              "--sample_steps", str(steps), "--save_file", out])
    lat = np.load(out + "_latents.npy")
    assert lat.shape == shape and np.isfinite(lat).all()
    assert skipped in capsys.readouterr().out


def test_cli_aliases_dash_spelling_and_image(tmp_path, capsys, monkeypatch):
    built = {}
    orig = TP.FramePackPipeline.__init__

    def spy(self, config, *a, **kw):
        built["cfg"] = config
        orig(self, config, *a, **kw)

    monkeypatch.setattr(TP.FramePackPipeline, "__init__", spy)
    img = tmp_path / "img.npy"
    np.save(img, np.random.default_rng(0).random((40, 24, 3)).astype(np.float32))
    out = str(tmp_path / "hy")
    cli.main(["--task", "hunyuan-720p", "--device", "cpu", "--tiny", "--video-size", "720",
              "1280", "--infer-steps", "3", "--embedded-cfg-scale", "4.5", "--flow-shift",
              "5.0", "--neg_prompt", "blurry", "--cfg-scale", "7.5", "--image", str(img),
              "--save-path", out])
    cfg = built["cfg"]
    text = capsys.readouterr().out
    assert (cfg.steps, cfg.guidance, cfg.flow_shift, cfg.history_frames) == (3, 4.5, 5.0, 2)
    assert cfg.model == "hunyuanvideo-544p" and not cfg.pyramid   # --tiny: 32 x 32
    assert "--neg_prompt is ignored" in text and "--cfg_scale != 1.0" in text
    assert np.load(out + "_latents.npy").shape == (1, 2, 4, 4, 8)
    # the full-size defaults, without building the 12.8 B model
    def refuse(config, device):
        built["cfg"] = config
        raise SystemExit("built")

    monkeypatch.setattr(TP, "FramePackPipeline", refuse)
    for argv, want in (
            (["--task", "hunyuan", "--video_size", "720", "1280", "--video_length", "129"],
             dict(model="hunyuanvideo-720p", latent_window_size=33, steps=50, guidance=6.0,
                  txt_len=256, total_sections=1, history_frames=0, flow_shift=7.0)),
            (["--task", "framepack", "--size", "768*512"],
             dict(model="framepack", latent_window_size=21, steps=25, guidance=10.0,
                  total_sections=5, pyramid=True))):
        with pytest.raises(SystemExit, match="built"):
            cli.main(argv + ["--device", "cpu"])
        for k, v in want.items():
            assert getattr(built["cfg"], k) == v, k


def test_cli_checks():
    # the JAX CLI's default canvas (832*480) breaks the pyramid: a message
    # that names --size, before any model is built
    with pytest.raises(SystemExit, match="--size"):
        cli.main(["--task", "framepack", "--device", "cpu"])
    with pytest.raises(SystemExit, match="does not apply"):
        cli.main(["--task", "flux-dev", "--device", "cpu", "--video-length", "9"])
    if not torch.cuda.is_available():
        # the card is the default and there is no fallback
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(["--task", "framepack-f1", "--tiny"])


def test_cli_calibration_then_installed_ratios(tmp_path, capsys):
    cal = str(tmp_path / "fp")
    cli.main(["--task", "framepack-f1", "--tiny", "--device", "cpu", "--magcache_calibration",
              "--infer-steps", "4", "--save_file", cal])
    with open(cal + "_mag_ratio.json") as f:
        ratios = json.load(f)
    # 5 sections carried across: 3 of the first section, 4 of each later one
    assert len(ratios) == 3 + 4 * 4 and np.all(np.isfinite(ratios))
    out = str(tmp_path / "gen")
    cli.main(["--task", "framepack-f1", "--tiny", "--device", "cpu", "--use_magcache",
              "--sample_steps", "4", "--mag_ratios_json", cal + "_mag_ratio.json",
              "--magcache_thresh", "10", "--save_file", out])
    assert np.load(out + "_latents.npy").shape == (1, 10, 8, 8, 8)
    assert "of 20 forwards" in capsys.readouterr().out
