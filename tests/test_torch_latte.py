"""The port's Latte-1 slice against the JAX package on the CPU: the DDIM-eps
schedule, ``sample_euler`` with ``x_coeffs``, the weight converter, the Latte
core on its packed route (K5r-K8's plain versions against the JAX core with
its Pallas kernels in interpret mode) and on both unpacked routes, the
pipeline (full compute, MagCache, calibration, skip masks) and the CLI.

Both sides get the same weights (``init_latte_params`` converted by
``latte_params_from_numpy``) and the same numpy inputs.
"""

import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.core import sampler as jsampler
from magcache_tpu.core.magcache import MagCacheConfig as JMagCacheConfig
from magcache_tpu.core.magcache import prepare_mag_ratios as j_prepare
from magcache_tpu.models import latte as J
from magcache_tpu.pipelines import latte as jpipe
from magcache_tpu.schedulers.ddim_eps import DDIMEpsSchedule as JDDIM
from magcache_tpu.utils.misc import set_seed as j_set_seed
from magcache_tpu_torch.cli import generate as cli
from magcache_tpu_torch.core.magcache import MagCacheConfig, prepare_mag_ratios
from magcache_tpu_torch.core.pab import LATTE_PAB
from magcache_tpu_torch.core.sampler import sample_euler
from magcache_tpu_torch.models import latte as T
from magcache_tpu_torch.models.convert import latte_params_from_numpy
from magcache_tpu_torch.pipelines import flux as tflux
from magcache_tpu_torch.pipelines import latte as tpipe
from magcache_tpu_torch.pipelines import open_sora as tos
from magcache_tpu_torch.pipelines import wan as twan
from magcache_tpu_torch.schedulers.ddim_eps import DDIMEpsSchedule

# f32 on both sides: GEMM and reduction order only
F32_TOL = 2e-5
# bf16: JAX rounds at other places around the unfused ops (bias adds, the
# patch embedding's product); rel L2 measured below 1e-2
BF16_REL_L2 = 2e-2

# head dim 72 as published; frames of S = 15 tokens, T = 4 frames
NARROW = dict(hidden=144, heads=2, depth=2, caption_dim=24, time_embed_dim=32)
GRID, CAP = (4, 3, 5), 5


def _np(a):
    return np.array(a, np.float32)


def _latents_close(got, want):
    """f32 on both sides; with random weights and guidance 7.5 the DDIM
    latents grow to a few hundred, so the summation-order error is held
    against the largest of them."""
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def _models(dtype, seed=0, **kw):
    cfg_kw = dict(NARROW, dtype=dtype, **kw)
    jcfg, tcfg = J.LatteConfig(**cfg_kw), T.LatteConfig(**cfg_kw)
    params = J.init_latte_params(jax.random.PRNGKey(seed), jcfg)
    model = T.LatteModel(tcfg, "cpu")
    model.load_state_dict(latte_params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu"))
    return jcfg, params, model


def _inputs(rows=2, seed=1):
    rng = np.random.default_rng(seed)
    t, h, w = GRID
    x = rng.standard_normal((rows, t, 2 * h, 2 * w, 4)).astype(np.float32)
    y = rng.standard_normal((rows, CAP, NARROW["caption_dim"])).astype(np.float32)
    return x, y, np.array([800.0, 800.0][:rows], np.float32)


# ---------------------------------------------------------------- DDIM
@pytest.mark.parametrize("steps,kw", [(50, {}), (20, {}), (7, dict(steps_offset=1)),
                                      (25, dict(set_alpha_to_one=False,
                                                beta_schedule="scaled_linear"))])
def test_ddim_eps_schedule_equals_jax(steps, kw):
    t, j = DDIMEpsSchedule.create(steps, **kw), JDDIM.create(steps, **kw)
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    np.testing.assert_array_equal(t.alphas_cumprod, j.alphas_cumprod)
    for got, want in zip(t.step_arrays(), j.step_arrays()):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    if steps == 50 and not kw:
        assert t.timesteps[0] == 980 and t.timesteps[-1] == 0


# ---------------------------------------------------------------- sampler
def _combine(g, c):
    return lambda chunks: chunks[1][..., :c] + g * (chunks[0][..., :c] - chunks[1][..., :c])


@pytest.mark.parametrize("mode", ["magcache", "calibrate", "override"])
def test_sample_euler_x_coeffs_matches_jax(mode):
    steps = 8
    jcfg, params, model = _models("float32", seed=2)
    jcore = J.make_latte_core(jcfg, GRID, CAP)
    tcore = T.make_latte_core(model, GRID, CAP, route="grouped")
    sch = DDIMEpsSchedule.create(steps)
    c_x, c_eps = sch.step_arrays()
    rng = np.random.default_rng(3)
    z = rng.standard_normal((1, 4, 6, 10, 4)).astype(np.float32)
    y = rng.standard_normal((2, CAP, NARROW["caption_dim"])).astype(np.float32)
    kw = dict(timesteps=sch.timesteps.astype(np.float32), dts=c_eps, x_coeffs=c_x,
              lanes=2)
    ratios = np.linspace(1.0, 0.97, steps)
    override = np.zeros((steps, 1), bool)
    override[[2, 3, 5]] = True
    if mode == "calibrate":
        kw.update(calibrate=True, calibrate_lanes=1)
        jkw = dict(kw)
    else:
        cfg = dict(num_steps=steps, mag_ratios=tuple(ratios), thresh=0.1,
                   max_consecutive_skips=2, retention_ratio=0.2)
        kw.update(cache_cfg=MagCacheConfig(**cfg), return_skips=True)
        jkw = dict(kw, cache_cfg=JMagCacheConfig(**cfg))
    if mode == "override":
        kw["skip_mask_override"] = override
        jkw["skip_mask_override"] = jnp.asarray(override)
    jout = jax.jit(lambda p, z_, c: jsampler.sample_euler(
        jcore, p, z_, c, combine_fn=_combine(7.5, 4), **jkw))(
            params, jnp.asarray(z), {"y": jnp.asarray(y)})
    tout = sample_euler(tcore, torch.from_numpy(z), {"y": torch.from_numpy(y)},
                        combine_fn=_combine(7.5, 4), **kw)
    _latents_close(tout[0].numpy(), _np(jout[0]))
    if mode == "calibrate":
        assert tout[1].shape == (steps - 1, 1, 3)
        np.testing.assert_allclose(tout[1], np.asarray(jout[1]), atol=1e-4, rtol=1e-4)
    else:
        np.testing.assert_array_equal(tout[1], np.asarray(jout[1]))
        assert tout[1].any()


# ---------------------------------------------------------------- model
def test_converter_carries_every_parameter_with_jax_dtypes():
    jp = J.init_latte_params(jax.random.PRNGKey(0), J.LatteConfig(**NARROW, dtype="bfloat16"))
    tcfg = T.LatteConfig(**NARROW, dtype="bfloat16")
    sd = T.LatteModel(tcfg, "cpu").state_dict()
    conv = latte_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    assert sd.keys() == conv.keys()
    for k, v in sd.items():
        assert v.dtype == conv[k].dtype and v.shape == conv[k].shape, k
    for k in ("patch_embed.weight", "spatial.0.qkv.weight", "temporal.1.ff2.bias",
              "spatial.1.cross_kv.weight"):
        assert sd[k].dtype == torch.bfloat16, k
    for k in ("caption.in.weight", "time.out.bias", "adaln_single.weight",
              "temporal.0.scale_shift", "final_mod", "final_out.weight"):
        assert sd[k].dtype == torch.float32, k
    assert not any(k.startswith("temporal.0.cross") for k in sd)
    np.testing.assert_array_equal(conv["spatial.1.ff1.weight"].float().numpy(),
                                  _np(jp["spatial"]["ff1"]["w"][1]).T)


def test_latte_1_is_the_published_size():
    m = T.LatteModel(T.LATTE_1, "meta")
    n = sum(p.numel() for p in m.parameters())
    assert 1.05e9 < n < 1.06e9
    assert (T.LATTE_1.head_dim, T.LATTE_1.c_out, T.LATTE_1.depth) == (72, 8, 28)


@pytest.mark.parametrize("route,dtype", [("packed", "float32"), ("packed", "bfloat16"),
                                         ("grouped", "float32"), ("grouped", "bfloat16"),
                                         ("vpu", "float32")])
def test_latte_core_matches_jax(route, dtype, monkeypatch):
    # packed: the JAX core's packed path with K5-K8 in interpret mode;
    # unpacked: its unpacked path (XLA attention on the CPU)
    monkeypatch.setenv("MAGCACHE_STDIT3_PACKED", "interpret" if route == "packed" else "0")
    jcfg, params, model = _models(dtype, out_channels=8)
    jcore = J.make_latte_core(jcfg, GRID, CAP)
    tcore = T.make_latte_core(model, GRID, CAP, route=route)
    x, y, t = _inputs()
    hj, cj = jax.jit(jcore.prepare)(params, jnp.asarray(x), jnp.asarray(t),
                                    {"y": jnp.asarray(y)})
    trj = jax.jit(jcore.trunk)(params, hj, cj)
    oj = jax.jit(jcore.head)(params, trj, cj)
    ht, ct = tcore.prepare(torch.from_numpy(x), torch.from_numpy(t),
                           {"y": torch.from_numpy(y)})
    assert ht.dtype == model.cfg.torch_dtype and ht.shape == (2, 60, 144)
    for key in ("t6", "te", "y"):
        np.testing.assert_allclose(ct[key].float().numpy(), _np(cj[key]),
                                   atol=F32_TOL, rtol=F32_TOL)
    # the port's trunk on JAX's embeddings isolates the blocks
    feed = {k: torch.from_numpy(_np(v)).to(ct[k].dtype) for k, v in cj.items()}
    trt = tcore.trunk(torch.from_numpy(_np(hj)).to(ht.dtype), feed).float().numpy()
    ot = tcore.head(tcore.trunk(ht, ct), ct).numpy()
    assert ot.shape == x.shape and np.isfinite(ot).all()
    for got, want in ((_np(ht.float()), _np(hj)), (trt, _np(trj)), (ot, _np(oj))):
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
        else:
            assert np.linalg.norm(got - want) / np.linalg.norm(want) < BF16_REL_L2


def test_random_init_follows_jax():
    m = T.LatteModel(T.LatteConfig(**NARROW), "cpu").init(torch.Generator().manual_seed(0))
    assert not m.spatial[0].qkv.bias.any()
    std = float(m.temporal[1].ff2.weight.detach().std())
    assert abs(std - (4 * 144) ** -0.5) < 0.1 * (4 * 144) ** -0.5
    assert abs(float(m.final_mod.detach().std()) - 144 ** -0.5) < 0.2 * 144 ** -0.5


def test_unported_latte_paths_raise():
    _, _, model = _models("float32")
    x, y, t = _inputs()
    # PAB runs on every route (tests/test_torch_pab_routes.py holds it to JAX)
    for route in ("grouped", "vpu"):
        core = T.make_latte_core(model, GRID, CAP, route=route, pab=LATTE_PAB,
                                 timesteps=np.ones(2))
        h, ctx = core.prepare(torch.from_numpy(x), torch.from_numpy(t),
                              {"y": torch.from_numpy(y)})
        out, _ = core.trunk(h, ctx, core.init_state(h, ctx), 0)
        assert out.shape == h.shape and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="timesteps"):
        T.make_latte_core(model, GRID, CAP, pab=LATTE_PAB)
    with pytest.raises(ValueError, match="route"):
        T.make_latte_core(model, GRID, CAP, route="0")
    out = tpipe.LattePipeline(tpipe.LattePipelineConfig(
        tiny=True, num_frames=4, height=64, width=64, num_sampling_steps=2,
        caption_len=6, enable_pab=True, route="vpu"), "cpu").generate("a cat", seed=1)
    assert out.latents.shape == (1, 4, 8, 8, 4) and torch.isfinite(out.latents).all()
    # frames of 2,304 tokens (> 2,048) run the unfused packed block
    # (tests/test_torch_latte_large.py holds it to JAX)
    core = T.make_latte_core(model, (2, 48, 48), CAP)
    xl = np.random.default_rng(2).standard_normal((2, 2, 96, 96, 4)).astype(np.float32)
    h, ctx = core.prepare(torch.from_numpy(xl), torch.from_numpy(t), {"y": torch.from_numpy(y)})
    out = core.head(core.trunk(h, ctx), ctx)
    assert out.shape == xl.shape and torch.isfinite(out).all()
    T.make_latte_core(model, (2, 32, 64), CAP)           # 2,048 tokens: the fused block


# ---------------------------------------------------------------- pipeline
def _pipeline_pair(route="packed", **kw):
    base = dict(tiny=True, num_frames=4, height=64, width=64, num_sampling_steps=10,
                caption_len=6, dtype="float32")
    base.update(kw)
    j = jpipe.LattePipeline(jpipe.LattePipelineConfig(**base))
    tcfg = tpipe.LattePipelineConfig(route=route, **base)
    model = T.LatteModel(tcfg.model_config(), "cpu")
    model.load_state_dict(latte_params_from_numpy(
        jax.tree.map(np.asarray, j.params), tcfg.model_config(), "cpu"))
    return j, tpipe.LattePipeline(tcfg, "cpu", model=model)


RATIOS = tuple(np.linspace(1.0, 0.96, 9))


@pytest.mark.parametrize("route,kw", [
    ("packed", dict(use_magcache=True, magcache_ratios=RATIOS)),
    ("grouped", dict(use_magcache=True, magcache_ratios=RATIOS, magcache_K=2)),
    ("vpu", dict()),
    ("packed", dict(magcache_calibration=True))])
def test_pipeline_latents_match_jax(route, kw, monkeypatch):
    monkeypatch.setenv("MAGCACHE_STDIT3_PACKED", "interpret" if route == "packed" else "0")
    jp, tp = _pipeline_pair(route, **kw)
    z = _np(jax.random.normal(j_set_seed(5), (1,) + jp.latent_shape, jnp.float32))
    monkeypatch.setattr(tp, "_initial_noise", lambda gen: torch.from_numpy(z))
    assert tp.latent_shape == jp.latent_shape == (4, 8, 8, 4) and tp.grid == jp.grid
    want = jp.generate("a red boat at dawn", seed=5)
    got = tp.generate("a red boat at dawn", seed=5)
    _latents_close(got.latents.numpy(), _np(want.latents))
    if "magcache_calibration" in kw:
        assert got.skips is None
        for name, vals in got.calibration.items():
            assert len(vals) == 9
            np.testing.assert_allclose(vals, want.calibration[name], atol=2e-5)
    else:
        np.testing.assert_array_equal(got.skips, jp.skip_mask_for(
            use_magcache=bool(kw.get("use_magcache"))))
        assert got.skips.any() == bool(kw.get("use_magcache"))


def test_skip_mask_for_and_override_follow_jax(monkeypatch):
    monkeypatch.setenv("MAGCACHE_STDIT3_PACKED", "0")
    jp, tp = _pipeline_pair("grouped", num_sampling_steps=20, magcache_ratios=RATIOS)
    for e, k, r in ((None, None, None), (0.06, 2, 0.1), (0.3, 4, 0.3)):
        np.testing.assert_array_equal(tp.skip_mask_for(e, k, r), jp.skip_mask_for(e, k, r))
    np.testing.assert_array_equal(tp.skip_mask_for(use_magcache=False),
                                  np.zeros((20, 1), bool))
    np.testing.assert_array_equal(
        prepare_mag_ratios(np.asarray(RATIOS), 20, lanes=1),
        np.asarray(j_prepare(np.asarray(RATIOS), 20, lanes=1)))
    mask = tp.skip_mask_for(0.3, 4, 0.2)
    assert mask.any()
    z = _np(jax.random.normal(j_set_seed(1), (1,) + jp.latent_shape, jnp.float32))
    monkeypatch.setattr(tp, "_initial_noise", lambda gen: torch.from_numpy(z))
    got = tp.generate("a cat", seed=1, skip_override=mask)
    want = jp.generate("a cat", seed=1, skip_override=mask)
    np.testing.assert_array_equal(got.skips, mask)
    _latents_close(got.latents.numpy(), _np(want.latents))


def test_clean_caption_is_applied_twice(monkeypatch):
    from magcache_tpu.pipelines.open_sora_cond import clean_caption as jclean

    _, tp = _pipeline_pair("grouped", num_sampling_steps=2, clean_caption=True)
    seen = []

    class Encoded(Exception):
        pass

    def encoder(prompts, device=None):
        seen.extend(prompts)
        raise Encoded

    monkeypatch.setattr(tp, "text_encoder", encoder)
    prompt = "A <b>Cat</b> https://x.io &amp; ID ab12345"
    with pytest.raises(Encoded):
        tp.generate(prompt, "Blurry!")
    assert seen == [jclean(jclean(prompt)), jclean(jclean("Blurry!"))]


def test_pipelines_run_on_the_card_unless_asked():
    for cls in (twan.WanPipeline, tos.OpenSoraPipeline, tflux.FluxPipeline,
                tpipe.LattePipeline):
        assert inspect.signature(cls.__init__).parameters["device"].default == "cuda"
    assert cli.build_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):   # no CUDA build
            tpipe.LattePipeline(tpipe.LattePipelineConfig(tiny=True, num_sampling_steps=2))


def test_cli_latte_tiny_route(tmp_path, capsys):
    cal = str(tmp_path / "cal")
    cli.main(["--task", "latte", "--tiny", "--device", "cpu", "--dtype", "float32",
              "--magcache_calibration", "--sample_steps", "10", "--save_file", cal])
    ratios = json.load(open(cal + "_mag_ratio.json"))
    assert len(ratios) == 9 and all(np.isfinite(ratios))
    out = str(tmp_path / "gen")
    cli.main(["--task", "latte", "--tiny", "--device", "cpu", "--use_magcache",
              "--mag_ratios_json", cal + "_mag_ratio.json", "--route", "vpu",
              "--clean_caption", "--save_file", out])
    lat = np.load(out + "_latents.npy")
    assert lat.shape == (1, 4, 8, 8, 4) and np.isfinite(lat).all()
    text = capsys.readouterr().out
    assert "of 50 forwards (cond + uncond as one joint batch per step)" in text
