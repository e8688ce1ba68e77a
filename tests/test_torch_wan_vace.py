"""Wan2.1 VACE in the port against the JAX package on the CPU, f32: the VACE
trunk (the hint stack, ``vace_scale``), its converter layout, the video and
mask resizes, the VACE context encode (source video and mask, none, R2V
references), the VACE pipeline with MagCache, with a lane-asymmetric
override and with an R2V reference, the VACE skip schedules, the CLI, and
the refusal under sequence parallelism.

The JAX side is pinned to small widths with ``WanConfig.tiny`` and
``model_cfg_override`` (two VACE blocks over a two-layer trunk), with
numpy-drawn trees.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.core.magcache import compute_skip_schedule as j_schedule
from magcache_tpu.core.presets import make_config as j_make_config
from magcache_tpu.models import vae_wan as JW
from magcache_tpu.models import wan as jwan
from magcache_tpu.pipelines import wan as jpipe
from magcache_tpu_torch.cli import generate as cli
from magcache_tpu_torch.core.magcache import compute_skip_schedule
from magcache_tpu_torch.models import vae_wan as TW
from magcache_tpu_torch.models import wan as twan
from magcache_tpu_torch.models.convert import wan_params_from_numpy, wan_vae_params_from_numpy
from magcache_tpu_torch.parallel.mesh import run_local_ranks
from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig
from magcache_tpu_torch.utils.misc import resize_nearest, resize_video_bicubic

# f32 on both sides; only GEMM/reduction summation order differs (the
# tolerance of tests/test_torch_wan.py for the t2v block)
TOL = 2e-4
# the VAEs' convs in f32 (tests/test_torch_vae_wan.py's)
VAE_TOL = 1e-4
# latents after the sampler, both sides f32
LATENT_TOL = 1e-4
# jax.image.resize's separable bicubic against the two passes: f32 rounding
RESIZE_TOL = 5e-6

VACE = dict(vace_layers=(0, 1))
# the tiny Wan-stride VAE (z 16, stride (4, 8, 8)) of the pipelines
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
    lat = (batch, f, 2 * h, 2 * w)
    return (rng.standard_normal(lat + (16,)).astype(np.float32),
            {"context": rng.standard_normal((batch, cfg.text_len, cfg.text_dim)
                                            ).astype(np.float32),
             "vace_context": rng.standard_normal(lat + (96,)).astype(np.float32)})


# ---------------------------------------------------------------- the trunk
@pytest.mark.parametrize("grid", [(2, 4, 4), (3, 8, 8)])
def test_vace_forward_matches_jax(grid):
    (jcore, params), tcore, _ = _models(VACE, grid, seed=1)
    x, cond = _inputs(twan.WanConfig.tiny(**VACE), grid, 2, seed=2)
    t = np.array([900.0, 250.0], np.float32)
    hj, cj = jax.jit(jcore.prepare)(params, jnp.asarray(x), jnp.asarray(t),
                                    {k: jnp.asarray(v) for k, v in cond.items()})
    ht, ct = tcore.prepare(torch.from_numpy(x), torch.from_numpy(t),
                           {k: torch.from_numpy(v) for k, v in cond.items()})
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=TOL, rtol=TOL)
    trunk_j = np.asarray(jax.jit(jcore.trunk)(params, hj, cj))
    # the port's trunk on JAX's embeddings isolates the blocks and hints
    feed = {k: (torch.from_numpy(np.array(v)) if k != "vace_scale" else float(v))
            for k, v in cj.items()}
    trunk_t = tcore.trunk(torch.from_numpy(np.array(hj)), feed)
    np.testing.assert_allclose(trunk_t.numpy(), trunk_j, atol=TOL, rtol=TOL)
    oj = jcore.head(params, jnp.asarray(trunk_j), cj)
    ot = tcore.head(tcore.trunk(ht, ct), ct)
    assert ot.shape == x.shape
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=TOL, rtol=TOL)


def test_vace_scale_zero_is_the_plain_trunk_and_half_matches_jax():
    grid = (2, 4, 4)
    (jcore, params), tcore, model = _models(VACE, grid, seed=3)
    x, cond = _inputs(twan.WanConfig.tiny(**VACE), grid, 1, seed=4)
    t = torch.full((1,), 400.0)
    h, ctx = tcore.prepare(torch.from_numpy(x), t, {k: torch.from_numpy(v)
                                                    for k, v in cond.items()})
    plain = twan.WanModel(twan.WanConfig.tiny(), "cpu")
    plain.load_state_dict({k: v for k, v in model.state_dict().items()
                           if not k.startswith("vace.")})
    want = twan.make_wan_core(plain, grid).trunk(h, ctx)
    torch.testing.assert_close(tcore.trunk(h, dict(ctx, vace_scale=0.0)), want,
                               atol=0, rtol=0)
    assert (tcore.trunk(h, ctx) - want).abs().max() > 1e-3     # the hints are on
    jc = {k: jnp.asarray(v) for k, v in cond.items()}
    hj, cj = jax.jit(jcore.prepare)(params, jnp.asarray(x), jnp.asarray(t.numpy()),
                                    dict(jc, vace_scale=0.5))
    got = tcore.trunk(h, dict(ctx, vace_scale=0.5))
    np.testing.assert_allclose(got.numpy(), np.asarray(jcore.trunk(params, hj, cj)),
                               atol=TOL, rtol=TOL)


def test_vace_converter_layout_and_dtypes():
    jp = jwan.init_wan_params(jax.random.PRNGKey(0), jwan.WanConfig.tiny(**VACE))
    tcfg = twan.WanConfig.tiny(dtype="bfloat16", **VACE)
    sd = twan.WanModel(tcfg, "cpu").state_dict()
    conv = wan_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    assert sd.keys() == conv.keys()
    for k, v in sd.items():
        assert v.dtype == conv[k].dtype and v.shape == conv[k].shape, k
    for k in ("vace.patch_embedding.weight", "vace.before_proj.bias",
              "vace.after_proj.1.weight", "vace.blocks.0.ffn1.weight"):
        assert sd[k].dtype == torch.bfloat16, k
    for k in ("vace.blocks.1.modulation", "vace.blocks.0.norm_q", "vace.blocks.0.norm3_b"):
        assert sd[k].dtype == torch.float32, k
    assert sd["vace.patch_embedding.weight"].shape == (tcfg.dim, 96 * 4)
    np.testing.assert_array_equal(conv["vace.after_proj.1.weight"].float().numpy(),
                                  np.asarray(jp["vace"]["after_proj"]["w"][1]).T.astype(
                                      jnp.bfloat16).astype(np.float32))


def test_vace_refused_under_sequence_parallelism():
    """No longer refused: the VACE stack runs on the rank's rows and matches
    the single rank (tests/test_torch_sp_wan_tasks.py covers the plans, R2V
    and the JAX mesh); a grid whose tokens do not divide still raises."""
    model = twan.WanModel(twan.WanConfig.tiny(**VACE), "cpu")
    x, cond = _inputs(model.cfg, (2, 4, 4), 2, seed=4)
    t = torch.tensor([900.0, 250.0])
    cond = {k: torch.from_numpy(v) for k, v in cond.items()}

    def forward(plan=None):
        core = twan.make_wan_core(model, (2, 4, 4), plan)
        hidden, c = core.prepare(torch.from_numpy(x), t, cond)
        return core.head(core.trunk(hidden, c), c)

    want = forward()
    for got in run_local_ranks(2, forward, device="cpu"):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="R2V reference frames included"):
        run_local_ranks(3, lambda plan: twan.make_wan_core(model, (2, 4, 4), plan,
                                                           sp_impl="ring"), device="cpu")
    assert WanPipelineConfig(model="wan2.1-vace-1.3B", task="vace", sp=2).sp == 2
    with pytest.raises(ValueError, match="outside"):
        twan.WanModel(twan.WanConfig.tiny(vace_layers=(2,)), "cpu")


# -------------------------------------------------------------- the resizes
@pytest.mark.parametrize("src,dst", [((12, 40, 52), (9, 32, 64)), ((5, 40, 52), (9, 16, 24)),
                                     ((9, 24, 40), (9, 32, 64))],
                         ids=["down-frames", "up-frames", "same-frames"])
def test_resize_video_bicubic_matches_jax(src, dst):
    v = _rng(5).random((1,) + src + (3,)).astype(np.float32)
    got = resize_video_bicubic(torch.from_numpy(v), dst).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(v), (1,) + dst + (3,), "bicubic"))
    np.testing.assert_allclose(got, want, atol=RESIZE_TOL, rtol=0)


@pytest.mark.parametrize("dst", [(9, 32, 64), (3, 48, 80)], ids=["down", "up"])
def test_resize_nearest_matches_jax_exactly(dst):
    m = (_rng(6).random((1, 12, 40, 52)) > 0.5).astype(np.float32)
    got = resize_nearest(torch.from_numpy(m), dst).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.image.resize(jnp.asarray(m), (1,) + dst,
                                                                   "nearest")))
    # PyTorch's default "nearest" picks other frames
    other = torch.nn.functional.interpolate(torch.from_numpy(m)[None], size=dst)[0].numpy()
    assert not np.array_equal(other, got)


# ---------------------------------------------------------------- the encode
def _pipes(steps=6, refs=0, **kw):
    """The JAX pipeline and the port's on the same DiT and Wan VAE weights
    at 64x32 x 9 frames (the VAE both encodes and decodes)."""
    base = dict(model="wan2.1-vace-1.3B", task="vace", tiny=True, size=(64, 32), frame_num=9,
                sample_steps=steps, sample_shift=16.0, guide_scale=5.0, dtype="float32",
                vace_ref_images=refs, **kw)
    vcfg = JW.WanVAEConfig(**VAE_CFG)
    jvp = _numpy_params(JW.init_wan_vae_params, vcfg, 21)
    jcfg = jwan.WanConfig.tiny(**VACE)
    params = _numpy_params(jwan.init_wan_params, jcfg, 20)
    jp = jpipe.WanPipeline(jpipe.WanPipelineConfig(model_cfg_override=jcfg, **base),
                           params=params, vae=JW.WanVAE(vcfg, jvp))
    tcfg = WanPipelineConfig(model_cfg_override=twan.WanConfig.tiny(**VACE), **base)
    model = twan.WanModel(tcfg.model_config(), "cpu")
    model.load_state_dict(wan_params_from_numpy(params, tcfg.model_config()))
    tvae = TW.WanVAE(TW.WanVAEConfig(**VAE_CFG), "cpu")
    tvae.load_state_dict(wan_vae_params_from_numpy(jvp, tvae.cfg))
    return jp, WanPipeline(tcfg, "cpu", model=model, vae=tvae)


def _sources(seed=7):
    rng = _rng(seed)
    return dict(src_video=rng.random((12, 40, 52, 3)).astype(np.float32),
                src_mask=(rng.random((12, 40, 52)) > 0.5).astype(np.float32))


def _refs(n, seed=8):
    rng = _rng(seed)
    return [(rng.random((24, 40, 3)) * 255).astype(np.uint8) for _ in range(n)]


@pytest.mark.parametrize("case", ["video and mask", "no source", "R2V"])
def test_encode_vace_matches_jax(case):
    refs = 1 if case == "R2V" else 0
    jp, tp = _pipes(refs=refs)
    kw = {} if case == "no source" else _sources()
    if refs:
        kw = dict(kw, src_ref_images=_refs(1))
    got, want = tp.encode_vace(**kw), np.asarray(jp.encode_vace(**kw))
    lf, lh, lw, _ = tp.latent_shape
    assert tuple(got.shape) == want.shape == (1, lf, lh, lw, 96)
    np.testing.assert_array_equal(got[..., 32:].numpy(), want[..., 32:])   # the masks
    np.testing.assert_allclose(got.numpy(), want, atol=VAE_TOL, rtol=VAE_TOL)
    if case == "no source":
        assert not got.any()
    if refs:
        assert got[:, :1, ..., 16:].abs().max() == 0 and got[:, :1, ..., :16].abs().max() > 0
    with pytest.raises(ValueError, match="reference images"):
        tp.encode_vace(src_ref_images=_refs(refs + 1))


# ------------------------------------------------------------ the pipelines
def _generate_both(jp, tp, monkeypatch, **kw):
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (1,) + jp.latent_shape,
                                      jnp.float32))
    tp._initial_noise = lambda gen: torch.from_numpy(x0.copy())
    with monkeypatch.context() as mp:      # the JAX pipeline draws its noise inline
        mp.setattr(jax.random, "normal", lambda key, shape, dtype: jnp.asarray(x0))
        want = jp.generate("a corgi surfs a wave", seed=0, **kw)
    got = tp.generate("a corgi surfs a wave", seed=0, **kw)
    assert torch.isfinite(got.latents).all()
    np.testing.assert_allclose(got.latents.numpy(), np.asarray(want.latents),
                               atol=LATENT_TOL, rtol=LATENT_TOL)
    np.testing.assert_allclose(got.video.numpy(), want.video, atol=VAE_TOL, rtol=VAE_TOL)
    return got


def test_vace_pipeline_with_magcache_matches_jax(monkeypatch):
    jp, tp = _pipes(use_magcache=True)
    got = _generate_both(jp, tp, monkeypatch, **_sources())
    want = compute_skip_schedule(tp._cache_cfg()).reshape(6, 2)
    np.testing.assert_array_equal(got.skips, want)
    assert got.skips.sum() > 0
    assert set(got.timings) == {"text_s", "image_s", "decode_s", "total_s"}
    assert tuple(got.video.shape) == (1, 9, 32, 64, 3)


def test_vace_pipeline_lane_asymmetric_override_matches_jax(monkeypatch):
    # steps 2 and 4 skip one lane each: the half-batch trunk gathers the
    # VACE context by row
    jp, tp = _pipes(use_magcache=True)
    mask = np.zeros((6, 2), bool)
    mask[2, 0] = mask[4, 1] = mask[3] = True
    got = _generate_both(jp, tp, monkeypatch, skip_override=mask, **_sources(9))
    np.testing.assert_array_equal(got.skips, mask)


def test_vace_r2v_pipeline_trims_the_reference_and_matches_jax(monkeypatch):
    jp, tp = _pipes(refs=1, use_magcache=True)
    assert tp.latent_shape[0] == 4                      # 3 video + 1 reference frame
    got = _generate_both(jp, tp, monkeypatch, src_ref_images=_refs(1), **_sources(10))
    assert tuple(got.latents.shape) == (1, 3, 4, 8, 16)
    with pytest.raises(ValueError, match="for the vace task"):
        WanPipeline(WanPipelineConfig(tiny=True, size=(64, 32), frame_num=9), "cpu"
                    ).generate("a", src_video=_sources()["src_video"])


# ------------------------------------------------- schedules, configs, CLI
@pytest.mark.parametrize("model,elided", [("wan2.1-vace-1.3B", 50), ("wan2.1-vace-14B", 64)])
def test_vace_skip_schedules_bit_identical_to_jax(model, elided):
    """At the JAX CLI's defaults (50 steps, shift 16)."""
    jcfg = jpipe.WanPipelineConfig(model=model, task="vace", sample_shift=16.0)
    jsched = jpipe.WanPipeline._schedule(types.SimpleNamespace(config=jcfg))
    want = np.asarray(j_schedule(jpipe.WanPipeline._cache_cfg(
        types.SimpleNamespace(config=dataclasses.replace(jcfg, use_magcache=True)), jsched)))
    pipe = WanPipeline.__new__(WanPipeline)
    pipe.config = WanPipelineConfig(model=model, task="vace", sample_shift=16.0,
                                    use_magcache=True)
    got = compute_skip_schedule(pipe._cache_cfg())
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(j_schedule(j_make_config(model, 50))))
    assert int(got.sum()) == elided and got.size == 100


def test_vace_configs_build_the_published_trunks():
    for model, base, blocks in (("wan2.1-vace-1.3B", (1536, 30, 12), 6),
                                ("wan2.1-vace-14B", (5120, 40, 40), 8)):
        cfg = WanPipelineConfig(model=model, task="vace").model_config()
        assert (cfg.dim, cfg.layers, cfg.heads) == base and cfg.model_type == "t2v"
        assert cfg.vace_layers == tuple(range(0, cfg.layers, 5)) and len(cfg.vace_layers) == blocks
        jcfg = jpipe.WanPipelineConfig(model=model, task="vace").model_config()
        assert (jcfg.dim, jcfg.layers, jcfg.vace_layers) == (cfg.dim, cfg.layers, cfg.vace_layers)
    m = twan.WanModel(WanPipelineConfig(model="wan2.1-vace-14B", task="vace").model_config(),
                      "meta")
    assert len(m.vace.blocks) == 8
    assert 17.3e9 < sum(p.numel() for p in m.parameters()) < 17.4e9


def test_cli_vace_tiny(tmp_path, capsys, monkeypatch):
    src = _sources(11)
    np.save(tmp_path / "v.npy", src["src_video"])
    np.save(tmp_path / "m.npy", src["src_mask"])
    np.save(tmp_path / "r.npy", _rng(12).random((40, 52, 3)).astype(np.float32))
    seen = []
    generate = WanPipeline.generate

    def spy(self, *a, **kw):
        seen.append((self.config, sorted(kw)))
        return generate(self, *a, **kw)

    monkeypatch.setattr(WanPipeline, "generate", spy)
    out = str(tmp_path / "vace")
    cli.main(["--task", "vace-1.3B", "--tiny", "--device", "cpu", "--sample_steps", "6",
              "--use_magcache", "--src_video", str(tmp_path / "v.npy"), "--src_mask",
              str(tmp_path / "m.npy"), "--save_file", out])
    lat = np.load(out + "_latents.npy")
    assert lat.shape == (1, 3, 4, 8, 16) and np.isfinite(lat).all()
    cfg, kw = seen[-1]
    assert (cfg.model, cfg.task, cfg.sample_shift) == ("wan2.1-vace-1.3B", "vace", 16.0)
    assert kw == ["seed", "src_mask", "src_video"]
    assert "skipped" in capsys.readouterr().out
    cli.main(["--task", "vace-14B", "--tiny", "--device", "cpu", "--sample_steps", "2",
              "--src_ref_images", f"{tmp_path / 'r.npy'},{tmp_path / 'r.npy'}",
              "--save_file", out])
    assert seen[-1][0].vace_ref_images == 2 and seen[-1][0].model == "wan2.1-vace-14B"
    assert np.load(out + "_latents.npy").shape == (1, 3, 4, 8, 16)
    with pytest.raises(SystemExit, match="does not apply"):
        cli.main(["--task", "t2v-1.3B", "--tiny", "--device", "cpu",
                  "--src_video", str(tmp_path / "v.npy")])
