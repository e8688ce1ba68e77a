"""Wan2.2 in the port against the JAX package on the CPU, f32: the per-token
timestep (the segmented block and head, the ti2v forward), the Wan2.2 VAE's
layout (a 2x2 pixel shuffle) encoding and decoding, the ti2v image encode
(through a VAE, and the checkpoint-free projection), the ti2v pipeline with
and without an image (latent frame 0 clamped) and with a lane-asymmetric
override, the A14B two-expert MoE (t2v and i2v, both experts' trees,
MagCache across the switch, a guidance pair), the expert split, the skip
schedules of the six Wan2.2 and VACE presets' neighbours, ``boundary_step``,
the refusals, the published trunks and the CLI.

The JAX side is pinned to small widths with ``WanConfig.tiny`` and
``model_cfg_override``, with numpy-drawn trees.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.core.magcache import compute_skip_schedule as j_schedule
from magcache_tpu.models import vae_wan as JW
from magcache_tpu.models import wan as jwan
from magcache_tpu.pipelines import wan as jpipe
from magcache_tpu.schedulers.flow_match import FlowMatchSchedule as JFlow
from magcache_tpu_torch.cli import generate as cli
from magcache_tpu_torch.core.magcache import compute_skip_schedule
from magcache_tpu_torch.core.sampler import DiTCore
from magcache_tpu_torch.models import vae_wan as TW
from magcache_tpu_torch.models import wan as twan
from magcache_tpu_torch.models.convert import wan_params_from_numpy, wan_vae_params_from_numpy
from magcache_tpu_torch.parallel.mesh import run_local_ranks
from magcache_tpu_torch.pipelines import wan as twp
from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig
from magcache_tpu_torch.schedulers.flow_match import FlowMatchSchedule
from magcache_tpu_torch.utils.misc import set_seed

# f32 on both sides; only GEMM/reduction summation order differs (the
# tolerance of tests/test_torch_wan.py for the t2v block)
TOL = 2e-4
# the VAEs' convs in f32 (tests/test_torch_vae_wan.py's)
VAE_TOL = 1e-4
# latents after the sampler, both sides f32
LATENT_TOL = 1e-4

I2V22 = dict(model_type="i2v", in_channels=36, clip_tokens=0)
# the tiny Wan-stride VAE (z 16, stride (4, 8, 8)) of the tiny pipelines
VAE_CFG = dict(base=8, dim_mult=(1, 2, 4, 4), num_res_blocks=1,
               temporal_down=(False, True, True), z_channels=16)


def _rng(seed):
    return np.random.default_rng(seed)


def _numpy_params(init, cfg, seed):
    """A parameter tree in the layout ``init(key, cfg)`` returns, drawn with
    numpy: kernels ``N(0, 1/fan_in)``, vectors ``1 + 0.1 N(0, 1)``."""
    rng = _rng(seed)

    def draw(s):
        if len(s.shape) <= 1:
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree.map(draw, jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0)))


def _models(cfg_kw, grid, seed=0):
    jcfg = jwan.WanConfig.tiny(**cfg_kw)
    params = _numpy_params(jwan.init_wan_params, jcfg, seed)
    tcfg = twan.WanConfig.tiny(**cfg_kw)
    model = twan.WanModel(tcfg, "cpu")
    model.load_state_dict(wan_params_from_numpy(params, tcfg, "cpu"))
    return (jwan.make_wan_core(jcfg, grid), params), twan.make_wan_core(model, grid), model


def _inputs(cfg, grid, batch, seed):
    rng = _rng(seed)
    f, h, w = grid
    x = rng.standard_normal((batch, f, 2 * h, 2 * w, cfg.in_channels)).astype(np.float32)
    ctx = rng.standard_normal((batch, cfg.text_len, cfg.text_dim)).astype(np.float32)
    return x, ctx


# ------------------------------------------------ the per-token timestep
def test_segmented_block_matches_jax():
    cfg_kw = dict(layers=1)
    grid = (3, 4, 6)
    (jcore, params), _, model = _models(cfg_kw, grid, seed=1)
    jcfg = jwan.WanConfig.tiny(**cfg_kw)
    x, ctx = _inputs(jcfg, grid, 2, seed=2)
    cond = {"context": jnp.asarray(ctx), "ti2v_img": jnp.zeros(())}
    hj, cj = jax.jit(jcore.prepare)(params, jnp.asarray(x), jnp.asarray([700.0, 300.0]), cond)
    assert cj["e0"].shape == (2, 2, 6, jcfg.dim)
    cos, sin = jwan.wan_rope_tables(jcfg, grid)
    n0 = grid[1] * grid[2]
    bp = jax.tree.map(lambda a: a[0], params["blocks"])
    want, _, _ = jax.jit(lambda p, carry: jwan._wan_block(
        jcfg, (jnp.asarray(cos), jnp.asarray(sin)), None, n0, p, carry))(
            bp, (hj, cj["e0"], cj["context"]))
    args = [torch.from_numpy(np.array(a)) for a in (hj, cj["e0"], cj["context"], cos, sin)]
    with torch.no_grad():
        got = model.blocks[0](*args, None, n0)
        uniform = model.blocks[0](args[0], args[1][:, 0], *args[2:])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    # the t = 0 row is on: the step's row alone gives another output
    assert (got[:, :n0] - uniform[:, :n0]).abs().max() > 1e-3


@pytest.mark.parametrize("grid", [(2, 4, 4), (3, 8, 8)])
def test_ti2v_forward_matches_jax(grid):
    (jcore, params), tcore, _ = _models({}, grid, seed=3)
    x, ctx = _inputs(twan.WanConfig.tiny(), grid, 2, seed=4)
    t = np.array([900.0, 250.0], np.float32)
    hj, cj = jax.jit(jcore.prepare)(params, jnp.asarray(x), jnp.asarray(t),
                                    {"context": jnp.asarray(ctx), "ti2v_img": jnp.zeros(())})
    ht, ct = tcore.prepare(torch.from_numpy(x), torch.from_numpy(t),
                           {"context": torch.from_numpy(ctx), "ti2v_img": None})
    assert tuple(ct["e"].shape) == (2, 2, 96) and tuple(ct["e0"].shape) == (2, 2, 6, 96)
    for key in ("e", "e0", "context"):
        np.testing.assert_allclose(ct[key].numpy(), np.asarray(cj[key]), atol=TOL, rtol=TOL)
    oj = jcore.head(params, jcore.trunk(params, hj, cj), cj)
    ot = tcore.head(tcore.trunk(ht, ct), ct)
    assert ot.shape == x.shape
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=TOL, rtol=TOL)


def test_per_token_timestep_refused_under_sequence_parallelism():
    model = twan.WanModel(twan.WanConfig.tiny(), "cpu")
    x, ctx = _inputs(model.cfg, (2, 4, 4), 1, seed=5)

    def rank(plan):
        core = twan.make_wan_core(model, (2, 4, 4), plan)
        return core.prepare(torch.from_numpy(x), torch.full((1,), 5.0),
                            {"context": torch.from_numpy(ctx), "ti2v_img": None})

    with pytest.raises(NotImplementedError, match="per-token timestep"):
        run_local_ranks(2, rank, device="cpu")
    with pytest.raises(NotImplementedError, match="sp > 1"):
        WanPipelineConfig(model="wan2.2-ti2v-5B-i2v", task="ti2v", sp=2)


# ------------------------------------------------------ the Wan2.2 VAE layout
WAN22_TINY = dict(base=8, dim_mult=(1, 2, 2), temporal_down=(True, True), patchify=2,
                  z_channels=12)


@pytest.mark.parametrize("way", ["encode", "decode"])
def test_wan22_vae_layout_matches_jax(way):
    jcfg, tcfg = JW.WanVAEConfig.tiny(**WAN22_TINY), TW.WanVAEConfig.tiny(**WAN22_TINY)
    params = _numpy_params(JW.init_wan_vae_params, jcfg, 6)
    jvae, tvae = JW.WanVAE(jcfg, params), TW.WanVAE(tcfg, "cpu")
    tvae.load_state_dict(wan_vae_params_from_numpy(params, tcfg))
    if way == "encode":
        x = _rng(7).uniform(-1, 1, (1, 9, 32, 48, 3)).astype(np.float32)
        (jm, _), (tm, _) = jvae.encode(jnp.asarray(x)), tvae.encode(torch.from_numpy(x))
        assert tuple(tm.shape) == jm.shape == (1, 3, 4, 6, 12)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=VAE_TOL, rtol=VAE_TOL)
    else:
        z = _rng(8).standard_normal((1, 3, 4, 6, 12)).astype(np.float32)
        want = np.asarray(jvae.decode(jnp.asarray(z)))
        got = tvae.decode(torch.from_numpy(z)).numpy()
        assert got.shape == want.shape == (1, 9, 32, 48, 3)
        np.testing.assert_allclose(got, want, atol=VAE_TOL, rtol=VAE_TOL)
    full = dataclasses.asdict(TW.WAN22_VAE)
    assert {k: full[k] for k in ("base", "z_channels", "patchify", "dim_mult")} == {
        "base": 160, "z_channels": 48, "patchify": 2, "dim_mult": (1, 2, 4, 4)}
    assert full == {k: v for k, v in dataclasses.asdict(JW.WAN22_VAE).items() if k in full}


# ------------------------------------------------------------------- ti2v
def _ti2v_pipes(with_vae=False, steps=6, model="wan2.2-ti2v-5B-i2v", **kw):
    base = dict(model=model, task="ti2v", tiny=True, size=(64, 32), frame_num=9,
                sample_steps=steps, sample_shift=5.0, guide_scale=5.0, dtype="float32", **kw)
    jcfg = jwan.WanConfig.tiny()
    params = _numpy_params(jwan.init_wan_params, jcfg, 10)
    jvae = tvae = None
    if with_vae:
        vcfg = JW.WanVAEConfig(**VAE_CFG)
        jvp = _numpy_params(JW.init_wan_vae_params, vcfg, 11)
        jvae = JW.WanVAE(vcfg, jvp)
        tvae = TW.WanVAE(TW.WanVAEConfig(**VAE_CFG), "cpu")
        tvae.load_state_dict(wan_vae_params_from_numpy(jvp, tvae.cfg))
    jp = jpipe.WanPipeline(jpipe.WanPipelineConfig(model_cfg_override=jcfg, **base),
                           params=params, vae=jvae)
    tcfg = WanPipelineConfig(model_cfg_override=twan.WanConfig.tiny(), **base)
    model_t = twan.WanModel(tcfg.model_config(), "cpu")
    model_t.load_state_dict(wan_params_from_numpy(params, tcfg.model_config()))
    return jp, WanPipeline(tcfg, "cpu", model=model_t, vae=tvae)


def _image(seed=12):
    return (_rng(seed).random((24, 40, 3)) * 255).astype(np.uint8)


@pytest.mark.parametrize("way", ["vae", "projection"])
def test_encode_ti2v_matches_jax(way, monkeypatch):
    jp, tp = _ti2v_pipes(with_vae=way == "vae")
    img = _image()
    got = tp.encode_ti2v(img)
    if way == "projection":
        # the JAX package draws its projection with its own generator: hand
        # it the port's draw
        draw = torch.randn((3, 16), generator=set_seed(twp.TI2V_PROJECTION_SEED)).numpy()
        monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype: jnp.asarray(draw))
    want = np.asarray(jp.encode_ti2v(img))
    assert tuple(got.shape) == want.shape == (1, 1, 4, 8, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=VAE_TOL, rtol=VAE_TOL)


def _generate_both(jp, tp, monkeypatch, **kw):
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (1,) + jp.latent_shape,
                                      jnp.float32))
    tp._initial_noise = lambda gen: torch.from_numpy(x0.copy())
    jkw = {k: (jnp.asarray(v.numpy()) if torch.is_tensor(v) else v) for k, v in kw.items()}
    with monkeypatch.context() as mp:      # the JAX pipeline draws its noise inline
        mp.setattr(jax.random, "normal", lambda key, shape, dtype: jnp.asarray(x0))
        want = jp.generate("a corgi surfs a wave", seed=0, **jkw)
    got = tp.generate("a corgi surfs a wave", seed=0, **kw)
    assert torch.isfinite(got.latents).all()
    np.testing.assert_allclose(got.latents.numpy(), np.asarray(want.latents),
                               atol=LATENT_TOL, rtol=LATENT_TOL)
    return got


@pytest.mark.parametrize("image", [True, False], ids=["image", "no image"])
def test_ti2v_pipeline_with_magcache_matches_jax(image, monkeypatch):
    model = "wan2.2-ti2v-5B-i2v" if image else "wan2.2-ti2v-5B-t2v"
    jp, tp = _ti2v_pipes(model=model, use_magcache=True)
    kw = {}
    if image:
        kw["image_latents"] = tp.encode_ti2v(_image())
    got = _generate_both(jp, tp, monkeypatch, **kw)
    np.testing.assert_array_equal(got.skips,
                                  compute_skip_schedule(tp._cache_cfg()).reshape(6, 2))
    assert got.skips.sum() > 0
    if image:       # latent frame 0 is the image's, after every step
        torch.testing.assert_close(got.latents[:, :1], kw["image_latents"], atol=0, rtol=0)
        assert "image_s" in got.timings
    else:
        assert "image_s" not in got.timings


def test_ti2v_lane_asymmetric_override_matches_jax(monkeypatch):
    # the half-batch trunk gathers e0's [B, 2, 6, D] rows
    jp, tp = _ti2v_pipes(use_magcache=True)
    mask = np.zeros((6, 2), bool)
    mask[2, 0] = mask[4, 1] = mask[3] = True
    lat = tp.encode_ti2v(_image(13))
    got = _generate_both(jp, tp, monkeypatch, image_latents=lat, skip_override=mask)
    np.testing.assert_array_equal(got.skips, mask)
    torch.testing.assert_close(got.latents[:, :1], lat, atol=0, rtol=0)
    with pytest.raises(ValueError, match="one image"):
        tp.generate("a", image=_image(), last_image=_image())


# --------------------------------------------------------- the A14B MoE
def _moe_pipes(task, steps=8, guide_scale=(3.0, 4.0), **kw):
    """The JAX pipeline and the port's on the same two experts' trees."""
    model = "wan2.2-t2v-A14B" if task == "t2v" else "wan2.2-i2v-A14B"
    cfg_kw = {} if task == "t2v" else I2V22
    base = dict(model=model, task=task, tiny=True, size=(64, 32), frame_num=9,
                sample_steps=steps, sample_shift=5.0, guide_scale=guide_scale,
                dtype="float32", **kw)
    jcfg = jwan.WanConfig.tiny(**cfg_kw)
    hi, lo = (_numpy_params(jwan.init_wan_params, jcfg, s) for s in (20, 21))
    jp = jpipe.WanPipeline(jpipe.WanPipelineConfig(model_cfg_override=jcfg, **base),
                           params=hi, params_low=lo)
    tcfg = WanPipelineConfig(model_cfg_override=twan.WanConfig.tiny(**cfg_kw), **base)
    experts = []
    for tree in (hi, lo):
        m = twan.WanModel(tcfg.model_config(), "cpu")
        m.load_state_dict(wan_params_from_numpy(tree, tcfg.model_config()))
        experts.append(m)
    return jp, WanPipeline(tcfg, "cpu", model=experts[0], model_low=experts[1])


def _count_trunks(tp):
    """Wraps each expert's trunk with a call counter."""
    calls = {"high": 0, "low": 0}

    def spy(core, name):
        def trunk(hidden, ctx):
            calls[name] += 1
            return core.trunk(hidden, ctx)
        return DiTCore(core.prepare, trunk, core.head)

    tp.core, tp.core_low = spy(tp.core, "high"), spy(tp.core_low, "low")
    return calls


@pytest.mark.parametrize("task", ["t2v", "i2v"])
def test_moe_pipeline_with_magcache_matches_jax(task, monkeypatch):
    jp, tp = _moe_pipes(task, use_magcache=True)
    kw = {}
    if task == "i2v":
        kw["image_latents"] = torch.from_numpy(
            _rng(14).standard_normal((1,) + tp.latent_shape[:3] + (20,)).astype(np.float32))
    calls = _count_trunks(tp)
    got = _generate_both(jp, tp, monkeypatch, **kw)
    cache_cfg = tp._cache_cfg()
    b = tp.boundary_step()
    assert cache_cfg.split_step == 2 * b and cache_cfg.mode == task and 0 < b < 8
    np.testing.assert_array_equal(got.skips, compute_skip_schedule(cache_cfg).reshape(8, 2))
    assert got.skips.sum() > 0
    # the high-noise expert ran exactly the computed steps before the switch
    runs = ~got.skips.all(1)
    assert calls == {"high": int(runs[:b].sum()), "low": int(runs[b:].sum())}


def test_moe_expert_switch_and_guidance_pair(monkeypatch):
    jp, tp = _moe_pipes("t2v", steps=6)
    calls = _count_trunks(tp)
    got = _generate_both(jp, tp, monkeypatch)
    b = tp.boundary_step()
    assert b == JFlow.create(6, shift=5.0).boundary_step(0.875)
    assert calls == {"high": b, "low": 6 - b} and not got.skips.any()
    # the low-noise phase runs at the low scale: the high one there moves it
    _, same = _moe_pipes("t2v", steps=6, guide_scale=4.0)
    same._initial_noise = tp._initial_noise
    other = same.generate("a corgi surfs a wave", seed=0)
    assert (other.latents - got.latents).abs().max() > 1e-5


def test_moe_refusals():
    base = dict(model="wan2.2-t2v-A14B", tiny=True, size=(64, 32), frame_num=9,
                sample_steps=4, dtype="float32")
    pipe = WanPipeline(WanPipelineConfig(use_magcache=True, **base), "cpu")
    with pytest.raises(ValueError, match="MoE"):
        pipe.skip_mask_for()
    with pytest.raises(ValueError, match="MoE"):
        pipe.generate("a", skip_override=np.zeros((4, 2), bool))
    rolling = WanPipeline(WanPipelineConfig(use_magcache=True, cache_policy="rolling", **base),
                          "cpu", model=pipe.model, model_low=pipe.model_low)
    with pytest.raises(ValueError, match="rolling"):
        rolling.generate("a")
    for model, task in (("wan2.2-t2v-A14B", "t2v"), ("wan2.2-ti2v-5B-t2v", "ti2v"),
                        ("wan2.1-vace-1.3B", "vace")):
        cfg = WanPipelineConfig(model=model, task=task, enable_teacache=True)
        with pytest.raises(ValueError, match="no published coefficients"):
            WanPipeline._teacache_lanes(types.SimpleNamespace(config=cfg))
    with pytest.raises(ValueError, match="UniPC"):
        WanPipeline(WanPipelineConfig(sample_solver="euler", **base), "cpu",
                    model=pipe.model, model_low=pipe.model_low).generate("a")
    with pytest.raises(NotImplementedError, match="MoE"):
        WanPipelineConfig(model="wan2.2-t2v-A14B", sp=2)
    with pytest.raises(ValueError, match="dense"):
        WanPipeline(WanPipelineConfig(tiny=True), "cpu", model_low=pipe.model)
    # calibration runs the high-noise expert alone at the high scale
    cal = WanPipeline(WanPipelineConfig(magcache_calibration=True, guide_scale=(3.0, 4.0),
                                        **base), "cpu", model=pipe.model,
                      model_low=pipe.model_low)
    calls = _count_trunks(cal)
    assert cal.generate("a").calibration is not None and calls == {"high": 4, "low": 0}


# ------------------------------------------------- schedules and configs
@pytest.mark.parametrize("model,task,steps,shift,elided", [
    ("wan2.2-t2v-A14B", "t2v", 40, 12.0, 28), ("wan2.2-i2v-A14B", "i2v", 40, 5.0, 21),
    ("wan2.2-ti2v-5B-t2v", "ti2v", 50, 5.0, 50), ("wan2.2-ti2v-5B-i2v", "ti2v", 50, 5.0, 48)])
def test_skip_schedules_bit_identical_to_jax(model, task, steps, shift, elided):
    """At the JAX CLI's defaults; the A14B schedules re-gate around the
    expert switch (boundary 26 and 15)."""
    kw = dict(model=model, task=task, sample_steps=steps, sample_shift=shift,
              use_magcache=True)
    jcfg = jpipe.WanPipelineConfig(**kw)
    jself = types.SimpleNamespace(config=jcfg)
    jcache = jpipe.WanPipeline._cache_cfg(jself, jpipe.WanPipeline._schedule(jself))
    pipe = WanPipeline.__new__(WanPipeline)
    pipe.config = WanPipelineConfig(**kw)
    cache = pipe._cache_cfg()
    assert (cache.split_step, cache.mode) == (jcache.split_step, jcache.mode)
    got = compute_skip_schedule(cache)
    np.testing.assert_array_equal(got, np.asarray(j_schedule(jcache)))
    assert int(got.sum()) == elided and got.size == 2 * steps
    if "A14B" in model:
        assert pipe.boundary_step() == {"t2v": 26, "i2v": 15}[task]


@pytest.mark.parametrize("shift", [1.0, 5.0, 12.0])
def test_boundary_step_matches_jax(shift):
    for n in (6, 40, 50):
        for boundary in (0.0, 0.5, 0.875, 0.9, 1.0):
            got = FlowMatchSchedule.create(n, shift=shift).boundary_step(boundary)
            assert got == JFlow.create(n, shift=shift).boundary_step(boundary)


def test_configs_build_the_published_trunks():
    ti2v = WanPipelineConfig(model="wan2.2-ti2v-5B-i2v", task="ti2v")
    cfg = ti2v.model_config()
    assert (cfg.dim, cfg.ffn_dim, cfg.heads, cfg.layers) == (3072, 14336, 24, 30)
    assert (cfg.in_channels, cfg.out_channels, cfg.head_dim) == (48, 48, 128)
    assert (ti2v.vae_stride, ti2v.latent_channels) == ((4, 16, 16), 48)
    assert WanPipelineConfig(model="wan2.2-ti2v-5B-t2v", task="ti2v", size=(1280, 704),
                             frame_num=121).latent_grid() == (31, 44, 80)
    for model, task, channels in (("wan2.2-t2v-A14B", "t2v", 16), ("wan2.2-i2v-A14B", "i2v", 36)):
        c = WanPipelineConfig(model=model, task=task)
        cfg = c.model_config()
        assert (cfg.dim, cfg.layers, cfg.heads, cfg.in_channels) == (5120, 40, 40, channels)
        assert not cfg.has_clip and c.moe_boundary == twp.MOE_BOUNDARIES[model]
        jc = jpipe.WanPipelineConfig(model=model, task=task)
        assert (jc.moe_boundary, jc.model_config().in_channels) == (c.moe_boundary, channels)
        n = sum(p.numel() for p in twan.WanModel(cfg, "meta").parameters())
        assert 14.28e9 < n < 14.30e9
    assert WanPipelineConfig(guide_scale=(3.0, 4.0)).guide_pair == (3.0, 4.0)
    assert WanPipelineConfig(guide_scale=5.0).guide_pair == (5.0, 5.0)
    n5 = sum(p.numel() for p in twan.WanModel(twan.WAN_5B, "meta").parameters())
    assert 4.99e9 < n5 < 5.01e9


# ----------------------------------------------------------------- the CLI
def test_cli_ti2v_and_a14b_tiny(tmp_path, monkeypatch, capsys):
    np.save(tmp_path / "i.npy", _rng(15).random((40, 52, 3)).astype(np.float32))
    seen = []
    generate = WanPipeline.generate

    def spy(self, *a, **kw):
        seen.append((self.config, sorted(kw)))
        return generate(self, *a, **kw)

    monkeypatch.setattr(WanPipeline, "generate", spy)
    out = str(tmp_path / "o")
    cli.main(["--task", "ti2v-5B", "--tiny", "--device", "cpu", "--sample_steps", "6",
              "--use_magcache", "--image", str(tmp_path / "i.npy"), "--save_file", out])
    cfg, kw = seen[-1]
    assert (cfg.model, cfg.task, cfg.sample_shift, cfg.guide_scale) == (
        "wan2.2-ti2v-5B-i2v", "ti2v", 5.0, 5.0) and "image" in kw
    assert np.load(out + "_latents.npy").shape == (1, 3, 4, 8, 16)
    cli.main(["--task", "ti2v-5B", "--tiny", "--device", "cpu", "--sample_steps", "2",
              "--save_file", out])
    assert seen[-1][0].model == "wan2.2-ti2v-5B-t2v"
    cli.main(["--task", "t2v-A14B", "--tiny", "--device", "cpu", "--sample_steps", "6",
              "--use_magcache", "--save_file", out])
    cfg, _ = seen[-1]
    assert (cfg.model, cfg.sample_shift, cfg.guide_pair, cfg.moe_boundary) == (
        "wan2.2-t2v-A14B", 12.0, (3.0, 4.0), 0.875)
    text = capsys.readouterr().out
    assert "experts: high-noise steps" in text and "mode=magcache" in text
    cli.main(["--task", "i2v-A14B", "--tiny", "--device", "cpu", "--sample_steps", "2",
              "--image", str(tmp_path / "i.npy"), "--save_file", out])
    cfg, kw = seen[-1]
    assert (cfg.model, cfg.task, cfg.guide_pair) == ("wan2.2-i2v-A14B", "i2v", (3.5, 3.5))
    assert np.load(out + "_latents.npy").shape == (1, 3, 4, 8, 16)
    # the JAX CLI's full-size defaults, without building the models
    made = []
    monkeypatch.setattr(twp, "WanPipeline", lambda c, d, plan=None, **kw: made.append(c) or c)
    for task, want in (("t2v-A14B", (40, 12.0, 81, (3.0, 4.0))),
                       ("i2v-A14B", (40, 5.0, 81, (3.5, 3.5))),
                       ("ti2v-5B", (50, 5.0, 121, (5.0, 5.0)))):
        cli._wan_pipeline(cli.build_parser().parse_args(["--task", task]),
                          torch.device("cpu"), None)
        c = made[-1]
        assert (c.sample_steps, c.sample_shift, c.frame_num, c.guide_pair) == want
        assert c.size == (832, 480)
    cli._wan_pipeline(cli.build_parser().parse_args(
        ["--task", "t2v-A14B", "--sample_guide_scale", "6.5"]), torch.device("cpu"), None)
    assert made[-1].guide_pair == (6.5, 6.5)
