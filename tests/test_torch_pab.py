"""The port's Pyramid Attention Broadcast against the JAX package: the host
masks of every preset, the STDiT3 packed core under PAB (frames below and
above 2,048 tokens, with and without MagCache) and the Latte packed core
under ``LATTE_PAB`` through the samplers and pipelines over enough steps
that every site both reuses and refreshes, in f32 with the same weights and
inputs, and the ``--enable_pab`` CLI flag.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.core import pab as jpab
from magcache_tpu.core import sampler as jsampler
from magcache_tpu.core.presets import make_config as j_make_config
from magcache_tpu.models import stdit3 as JS
from magcache_tpu.pipelines import latte as jlatte
from magcache_tpu.pipelines import open_sora as jos
from magcache_tpu.utils.misc import set_seed as j_set_seed
from magcache_tpu_torch.cli import generate as cli
from magcache_tpu_torch.core import pab as tpab
from magcache_tpu_torch.core.presets import make_config as t_make_config
from magcache_tpu_torch.core.sampler import sample_euler
from magcache_tpu_torch.models import latte as TL
from magcache_tpu_torch.models import stdit3 as TS
from magcache_tpu_torch.pipelines import latte as tlatte
from magcache_tpu_torch.pipelines import open_sora as tos
from magcache_tpu_torch.schedulers.ddim_eps import DDIMEpsSchedule
from magcache_tpu_torch.schedulers.rflow import RFlowSchedule
from tests.test_torch_latte import _latents_close
from tests.test_torch_latte import _pipeline_pair as latte_pair
from tests.test_torch_opensora import _pipeline_pair as os_pair
from tests.test_torch_opensora_masked import CAP, NARROW, PIPE_TOL, _models

PRESETS = ("OPEN_SORA_PAB", "LATTE_PAB", "COGVIDEOX_PAB", "VCHITECT_PAB",
           "OSP_V110_PAB", "OSP_V120_PAB")
FACTORIES = ("OpenSoraPABConfig", "LattePABConfig", "CogVideoXPABConfig",
             "VchitectPABConfig", "OpenSoraPlanV110PABConfig", "OpenSoraPlanV120PABConfig")
TIMESTEPS = {
    "rflow-480p-51": RFlowSchedule.create(30, use_timestep_transform=True, height=480,
                                          width=854, num_frames=51).timesteps,
    "rflow-plain-30": RFlowSchedule.create(30).timesteps,
    "ddim-50": DDIMEpsSchedule.create(50).timesteps.astype(np.float32),
    "ddim-100": DDIMEpsSchedule.create(100).timesteps.astype(np.float32),
    "osp-linear-150": np.linspace(999, 0, 150),
}


@pytest.mark.parametrize("ts", sorted(TIMESTEPS))
@pytest.mark.parametrize("preset", PRESETS)
def test_masks_bit_equal_to_jax(preset, ts):
    cfg, jcfg = getattr(tpab, preset), getattr(jpab, preset)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    t = TIMESTEPS[ts]
    got, want = tpab.broadcast_masks(cfg, t), jpab.broadcast_masks(jcfg, t)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    for temporal in (False, True):
        got = tpab.mlp_skip_masks(cfg, t, 28, temporal=temporal)
        want = jpab.mlp_skip_masks(jcfg, t, 28, temporal=temporal)
        for k in ("reuse", "save"):
            np.testing.assert_array_equal(got[k], want[k])
        assert not (got["reuse"] & got["save"]).any()


def test_factories_and_the_window_rule_match_jax():
    for name in FACTORIES:
        assert (dataclasses.asdict(getattr(tpab, name)(spatial_range=3, mlp_broadcast=True))
                == dataclasses.asdict(getattr(jpab, name)(spatial_range=3, mlp_broadcast=True)))
    cfg = dict(mlp_broadcast=True, mlp_threshold=(100, 900), mlp_range=3)
    t = TIMESTEPS["ddim-50"]
    got = tpab.mlp_skip_masks(tpab.PABConfig(**cfg), t, 4)
    want = jpab.mlp_skip_masks(jpab.PABConfig(**cfg), t, 4)
    for k in ("reuse", "save"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["reuse"].any() and got["save"].any()
    assert tpab._anchor_of([720, 700, 680], 700, {720: {"skip_count": 2}}) == 720


def test_the_published_configurations_reuse_counts():
    m = tpab.broadcast_masks(tpab.OPEN_SORA_PAB, TIMESTEPS["rflow-480p-51"])
    assert [int(m[k].sum()) for k in ("spatial", "temporal", "cross", "mlp")] == [9, 13, 14, 0]
    m = tpab.broadcast_masks(tpab.LATTE_PAB, TIMESTEPS["ddim-50"])
    assert [int(m[k].sum()) for k in ("spatial", "temporal", "cross")] == [17, 23, 28]
    mm = tpab.mlp_skip_masks(tpab.LATTE_PAB, TIMESTEPS["ddim-50"], 28)
    assert set(np.flatnonzero(mm["reuse"].any(0))) == {0, 1, 2, 3, 4}
    assert mm["reuse"].sum() == 5 * 10 and mm["save"].sum() == 5 * 5


# ------------------------------------------------------------------ STDiT3
# every site reuses within 6 steps: RFLOW t = 1000, 833, ..., 167
SMALL_PAB = tpab.PABConfig(
    spatial_broadcast=True, spatial_threshold=(0, 1000), spatial_range=2,
    temporal_broadcast=True, temporal_threshold=(0, 1000), temporal_range=3,
    cross_broadcast=True, cross_threshold=(0, 900), cross_range=2,
    mlp_broadcast=True, mlp_threshold=(0, 1000), mlp_range=3)
J_SMALL_PAB = jpab.PABConfig(**dataclasses.asdict(SMALL_PAB))


def _os_combine(g, c):
    return lambda chunks: chunks[1][..., :c] + g * (chunks[0][..., :c] - chunks[1][..., :c])


@pytest.mark.parametrize("grid,pixels,jax_path,cached", [
    ((3, 3, 5), (48, 80), "interpret", False),     # K5
    ((3, 3, 5), (48, 80), "interpret", True),
    ((1, 46, 46), (736, 736), "0", True),           # 2,116 tokens: K1q
])
def test_stdit3_pab_sampler_matches_jax(grid, pixels, jax_path, cached, monkeypatch):
    """The JAX core on its packed path (Pallas in interpret mode); above
    2,048 tokens its PAB block calls the flash kernel without interpret
    mode, so that case holds the port against the JAX unpacked composition
    (the same math in f32)."""
    monkeypatch.setenv("MAGCACHE_STDIT3_PACKED", jax_path)
    steps = 6
    sch = RFlowSchedule.create(steps)
    jcfg, params, model = _models()
    jcore = JS.make_stdit3_core(jcfg, grid, CAP, pab=J_SMALL_PAB, timesteps=sch.timesteps,
                                pixel_size=pixels)
    tcore = TS.make_stdit3_core(model, grid, pab=SMALL_PAB, timesteps=sch.timesteps,
                                pixel_size=pixels)
    rng = np.random.default_rng(4)
    t_len, h, w = grid
    z = rng.standard_normal((1, t_len, 2 * h, 2 * w, 4)).astype(np.float32)
    y = rng.standard_normal((2, CAP, NARROW["caption_dim"])).astype(np.float32)
    kw = dict(timesteps=sch.timesteps, dts=sch.dts(), lanes=2, combine_fn=_os_combine(7.0, 4))
    tkw, jkw = dict(kw), dict(kw)
    if cached:
        # step 2 skips the trunk: step 3 reuses what step 1 cached
        mask = np.array([[0], [0], [1], [0], [1], [0]], bool)
        tkw.update(cache_cfg=t_make_config("opensora-v1.2", steps), skip_mask_override=mask)
        jkw.update(cache_cfg=j_make_config("opensora-v1.2", steps),
                   skip_mask_override=jnp.asarray(mask))
    want = jax.jit(lambda p, z_, c: jsampler.sample_euler(jcore, p, z_, c, **jkw))(
        params, jnp.asarray(z), {"y": jnp.asarray(y)})
    got = sample_euler(tcore, torch.from_numpy(z), {"y": torch.from_numpy(y)}, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PIPE_TOL, rtol=PIPE_TOL)
    # the state holds only the readable slots, [depth, rows, N, d] each
    hidden, ctx = tcore.prepare(torch.from_numpy(np.concatenate([z, z])),
                                torch.full((2,), 500.0), {"y": torch.from_numpy(y)})
    state = tcore.init_state(hidden, ctx)
    assert sorted(state) == ["sp_attn", "sp_cross", "sp_mlp", "tp_attn", "tp_cross",
                             "tp_mlp"]
    assert state["sp_attn"].shape == (1, 2, t_len * h * w, 144)


def test_stdit3_pab_sites_by_step(monkeypatch):
    """Each site computes exactly on its mask's False steps, and only the
    slots some mask reads exist (OPEN_SORA_PAB reads no MLP slot)."""
    sch = RFlowSchedule.create(30, use_timestep_transform=True, height=480, width=854,
                               num_frames=51)
    _, _, model = _models()
    core = TS.make_stdit3_core(model, (3, 3, 5), pab=tpab.OPEN_SORA_PAB,
                               timesteps=sch.timesteps)
    calls = {"cross": 0, "mlp": 0}
    real_cross, real_lnmod = TS.fused_cross_attention, TS.lnmod_matmul

    def cross(*a, **kw):
        assert kw["residual"] is False
        calls["cross"] += 1
        return real_cross(*a, **kw)

    def lnmod(*a, **kw):
        calls["mlp"] += kw.get("act") == "gelu"
        return real_lnmod(*a, **kw)

    monkeypatch.setattr(TS, "fused_cross_attention", cross)
    monkeypatch.setattr(TS, "lnmod_matmul", lnmod)
    x = torch.zeros(2, 3, 6, 10, 4)
    y = torch.zeros(2, CAP, NARROW["caption_dim"])
    hidden, ctx = core.prepare(x, torch.full((2,), 900.0), {"y": y})
    state = core.init_state(hidden, ctx)
    assert sorted(state) == ["sp_attn", "sp_cross", "tp_attn", "tp_cross"]
    masks = tpab.broadcast_masks(tpab.OPEN_SORA_PAB, sch.timesteps)
    for i in (0, 1, 2, 3):
        calls.update(cross=0, mlp=0)
        core.trunk(hidden, ctx, state, i)
        assert calls == {"cross": 0 if masks["cross"][i] else 2, "mlp": 2}
    # masked frames: K6 without the residual where cross computes, and the
    # unfused MLP (no K7 with gelu)
    hidden, ctx = core.prepare(x, torch.full((2,), 900.0),
                               {"y": y, "x_mask": torch.tensor([[True, False, True]] * 2)})
    for i in (0, 1):
        calls.update(cross=0, mlp=0)
        out, _ = core.trunk(hidden, ctx, state, i)
        assert calls == {"cross": 0 if masks["cross"][i] else 2, "mlp": 0}
        assert out.shape == hidden.shape and torch.isfinite(out).all()


@pytest.mark.parametrize("kw", [dict(enable_pab=True, pab_config=SMALL_PAB),
                                dict(enable_pab=True, pab_config=SMALL_PAB, use_magcache=True),
                                dict(use_magcache=True, cache_policy="rolling")])
def test_opensora_pipeline_pab_and_rolling_match_jax(kw, monkeypatch):
    """Both pipelines read the same (duck-typed) PAB config; the tiny
    clip's timestep transform keeps ``OPEN_SORA_PAB``'s window empty, so the
    window here is wider."""
    monkeypatch.setenv("MAGCACHE_STDIT3_PACKED", "interpret")
    jp, tp = os_pair(num_sampling_steps=10, **kw)
    jp.record_skips = True
    z = np.array(jax.random.normal(jax.random.split(j_set_seed(5), 3)[1],
                                   (1,) + jp.latent_shape, jnp.float32))
    monkeypatch.setattr(tp, "_initial_noise", lambda gen: torch.from_numpy(z))
    want = jp.generate("a red boat at dawn", seed=5)
    got = tp.generate("a red boat at dawn", seed=5)
    np.testing.assert_allclose(got.latents.numpy(), np.asarray(want.latents),
                               atol=PIPE_TOL, rtol=PIPE_TOL)
    if "use_magcache" in kw:
        assert got.skips.any()
        np.testing.assert_array_equal(got.skips.reshape(-1),
                                      np.asarray(jp._cache_cfg().skip_schedule()
                                                 if kw.get("cache_policy") else
                                                 jp.skip_mask_for()).reshape(-1))
    if kw.get("enable_pab"):
        assert tp.core.init_state is not None
        assert tpab.broadcast_masks(tp.config.pab_config, tp.schedule.timesteps)[
            "spatial"].any()


def test_pab_refuses_the_unpacked_routes_and_masked_frames(tmp_path):
    """PAB on the unpacked routes of both models, and an Open-Sora request
    with a reference under PAB (the masked sampler), run to finite outputs;
    PAB without the timesteps raises."""
    _, _, model = _models()
    ts = RFlowSchedule.create(4).timesteps
    latte = TL.LatteModel(TL.LatteConfig.tiny(), "cpu")
    for route in ("grouped", "vpu"):
        for core, shape in ((TS.make_stdit3_core(model, (3, 3, 5), route=route,
                                                 pab=SMALL_PAB, timesteps=ts), (2, 3, 6, 10, 4)),
                            (TL.make_latte_core(latte, (2, 2, 2), 4, route=route,
                                                pab=tpab.LATTE_PAB, timesteps=ts),
                             (2, 2, 4, 4, 4))):
            h, ctx = core.prepare(torch.zeros(shape), torch.full((2,), 900.0),
                                  {"y": torch.zeros(2, 4, 24)})
            out, _ = core.trunk(h, ctx, core.init_state(h, ctx), 0)
            assert torch.isfinite(core.head(out, ctx)).all()
    with pytest.raises(ValueError, match="timesteps"):
        TS.make_stdit3_core(model, (3, 3, 5), pab=SMALL_PAB)
    pipe = tos.OpenSoraPipeline(tos.OpenSoraPipelineConfig(
        tiny=True, num_frames=8, height=32, width=32, num_sampling_steps=2,
        caption_len=6, enable_pab=True), "cpu")
    ref = str(tmp_path / "ref.npy")
    np.save(ref, np.zeros((1, 4, 4, 4), np.float32))
    out = pipe.generate("a cat", ms="0,0,0,0,1,0", refs=ref)
    assert out.latents.shape == (1,) + pipe.latent_shape
    assert torch.isfinite(out.latents).all()
    np.testing.assert_array_equal(out.latents[0, 0].numpy(), 0.0)   # the pinned reference


# ------------------------------------------------------------------- Latte
@pytest.mark.parametrize("kw", [dict(enable_pab=True),
                                dict(enable_pab=True, use_magcache=True, magcache_K=1,
                                     magcache_ratios=tuple(np.linspace(1.0, 0.98, 49)))])
def test_latte_pipeline_latte_pab_matches_jax(kw, monkeypatch):
    """``LATTE_PAB`` over 50 DDIM steps: every site reuses, and the MLPs of
    blocks 0-1 (the tiny model's blocks) replay their anchors."""
    monkeypatch.setenv("MAGCACHE_STDIT3_PACKED", "interpret")
    jp, tp = latte_pair(num_sampling_steps=50, **kw)
    z = np.array(jax.random.normal(j_set_seed(5), (1,) + jp.latent_shape, jnp.float32))
    monkeypatch.setattr(tp, "_initial_noise", lambda gen: torch.from_numpy(z))
    calls = []
    real = TL.LatteBlock._composed
    monkeypatch.setattr(TL.LatteBlock, "_composed",
                        lambda self, *a: calls.append(a[-1][1]["mlp"]) or real(self, *a))
    want = jp.generate("a red boat at dawn", seed=5)
    got = tp.generate("a red boat at dawn", seed=5)
    _latents_close(got.latents.numpy(), np.asarray(want.latents, np.float32))
    assert any(calls) and sorted(tp.core.init_state(*tp.core.prepare(
        torch.zeros((2,) + tp.latent_shape), torch.full((2,), 1.0),
        {"y": torch.zeros(2, 6, tp.model_cfg.caption_dim)}))) == [
            "sp_attn", "sp_cross", "sp_mlp", "tp_attn", "tp_mlp"]
    if "use_magcache" in kw:
        np.testing.assert_array_equal(got.skips, jp.skip_mask_for())
        assert got.skips.any()


@pytest.mark.parametrize("task", ["open-sora", "latte"])
def test_cli_enable_pab(task, tmp_path, capsys):
    out = str(tmp_path / "out")
    cli.main(["--task", task, "--tiny", "--device", "cpu", "--dtype", "float32",
              "--sample_steps", "12", "--enable_pab", "--save_file", out])
    assert np.isfinite(np.load(out + "_latents.npy")).all()
    assert "mode=full+pab" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="does not apply"):
        cli.main(["--tiny", "--device", "cpu", "--enable_pab"])
