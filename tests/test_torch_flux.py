"""The port's FLUX.1 slice against the JAX package on the CPU: the weight
converter, the model's prepare/trunk/head (t2i and Kontext) against
``make_flux_core``, the reference's timestep fault, ``sample_euler`` with the
flux-dev schedule and calibration, the pipeline and the CLI route.

Both sides get the same weights (``init_flux_params`` converted by
``flux_params_from_numpy``) and the same numpy inputs. The JAX model embeds
``t * 1000`` of the timestep it is given and the JAX pipeline hands it the
scheduler's ``sigma * 1000``, so its time MLP sees ``sigma * 1e6``; the port
embeds the scheduler's timestep as it is (``sigma * 1000``, as the published
FLUX transformer sees it). To compare like with like, the JAX side is fed
``t / 1000`` throughout.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.core import sampler as jsampler
from magcache_tpu.core.magcache import compute_skip_schedule as j_schedule
from magcache_tpu.core.presets import make_config as j_make_config
from magcache_tpu.models import flux as J
from magcache_tpu.pipelines import flux as jpipe
from magcache_tpu.utils.misc import set_seed as j_set_seed
from magcache_tpu_torch.cli import generate as cli
from magcache_tpu_torch.core.magcache import compute_skip_schedule
from magcache_tpu_torch.core.presets import make_config
from magcache_tpu_torch.core.sampler import sample_euler
from magcache_tpu_torch.models import flux as T
from magcache_tpu_torch.models.convert import flux_params_from_numpy
from magcache_tpu_torch.pipelines import flux as tpipe
from magcache_tpu_torch.schedulers.flow_match import FlowMatchSchedule

# f32 on both sides: GEMM and reduction order only
F32_TOL = 2e-5
# bf16: JAX rounds the linears' bias adds and the gelu at other points
BF16_REL_L2 = 5e-2
TXT, GH, GW = 8, 4, 4


def _models(dtype, seed=0):
    jcfg, tcfg = J.FluxConfig.tiny(dtype=dtype), T.FluxConfig.tiny(dtype=dtype)
    params = J.init_flux_params(jax.random.PRNGKey(seed), jcfg)
    model = T.FluxModel(tcfg, "cpu")
    model.load_state_dict(flux_params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu"))
    return jcfg, params, model


def _np(a):
    return np.array(a, np.float32)


def _cond(rows=2, seed=1, kontext=False):
    rng = np.random.default_rng(seed)
    cfg = T.FluxConfig.tiny()
    c = {"txt": rng.standard_normal((rows, TXT, cfg.text_dim)),
         "vec": rng.standard_normal((rows, cfg.vec_dim)),
         "guidance": np.full((rows,), 3.5)}
    if kontext:
        c["kontext"] = rng.standard_normal((rows, GH * GW, cfg.in_channels))
    return {k: v.astype(np.float32) for k, v in c.items()}


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# ---------------------------------------------------------------- model
def test_converter_carries_every_parameter_with_jax_dtypes():
    jp = J.init_flux_params(jax.random.PRNGKey(0), J.FluxConfig.tiny(dtype="bfloat16"))
    tcfg = T.FluxConfig.tiny(dtype="bfloat16")
    sd = T.FluxModel(tcfg, "cpu").state_dict()
    conv = flux_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    assert sd.keys() == conv.keys()
    for k, v in sd.items():
        assert v.dtype == conv[k].dtype and v.shape == conv[k].shape, k
    for k in ("img_in.weight", "txt_in.bias", "double_blocks.1.img_mod.weight",
              "double_blocks.0.txt_qkv.weight", "single_blocks.1.lin1.weight"):
        assert sd[k].dtype == torch.bfloat16, k
    for k in ("time_in.in.weight", "vector_in.out.bias", "guidance_in.in.weight",
              "final_mod.weight", "final_out.weight", "double_blocks.0.img_qk_scale",
              "single_blocks.1.qk_scale"):
        assert sd[k].dtype == torch.float32, k
    np.testing.assert_array_equal(conv["single_blocks.1.lin2.weight"].float().numpy(),
                                  _np(jp["single"]["lin2"]["w"][1]).T)
    np.testing.assert_array_equal(conv["double_blocks.1.txt_qk_scale"].numpy(),
                                  _np(jp["double"]["txt_qk_scale"][1]))


@pytest.mark.parametrize("kontext", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flux_forward_matches_jax(dtype, kontext):
    jcfg, params, model = _models(dtype)
    jcore = J.make_flux_core(jcfg, TXT, GH, GW, kontext=kontext)
    tcore = T.make_flux_core(model, TXT, GH, GW, kontext=kontext)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, GH * GW, jcfg.in_channels)).astype(np.float32)
    t = np.array([1000.0, 500.0], np.float32)
    cond = _cond(kontext=kontext)
    # the JAX model multiplies by 1000 what the port embeds as it is
    hj, cj = jax.jit(jcore.prepare)(params, jnp.asarray(x), jnp.asarray(t / 1000),
                                    {k: jnp.asarray(v) for k, v in cond.items()})
    trj = jax.jit(jcore.trunk)(params, hj, cj)
    oj = jax.jit(jcore.head)(params, trj, cj)
    tcond = {k: torch.from_numpy(v) for k, v in cond.items()}
    ht, ct = tcore.prepare(torch.from_numpy(x), torch.from_numpy(t), tcond)
    n_img = GH * GW * (2 if kontext else 1)
    assert ht.dtype == model.cfg.torch_dtype and ht.shape == (2, n_img, 128)
    np.testing.assert_allclose(ct["vec"].numpy(), _np(cj["vec"]), atol=F32_TOL,
                               rtol=F32_TOL)
    # the port's trunk on JAX's embeddings isolates the blocks
    feed = {k: torch.from_numpy(_np(v)).to(ct[k].dtype) for k, v in cj.items()}
    trt = tcore.trunk(torch.from_numpy(_np(hj)).to(ht.dtype), feed).float().numpy()
    ot = tcore.head(tcore.trunk(ht, ct), ct).numpy()
    assert trt.shape == (2, n_img, 128)
    assert ot.shape == (2, GH * GW, jcfg.in_channels) and np.isfinite(ot).all()
    for got, want in ((ht.float().numpy(), _np(hj)), (trt, _np(trj)), (ot, _np(oj))):
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
        else:
            assert _rel(got, want) < BF16_REL_L2


def test_timestep_fault_of_the_reference_is_not_inherited():
    # JAX's pipeline hands the model sigma*1000 and the model embeds t*1000:
    # its time MLP sees sigma*1e6. The port's vec equals JAX's fed t/1000
    # (the published model's sigma*1000) and differs from JAX's fed t.
    jcfg, params, model = _models("float32")
    jcore = J.make_flux_core(jcfg, TXT, GH, GW)
    tcore = T.make_flux_core(model, TXT, GH, GW)
    sch = FlowMatchSchedule.create(28, mu=FlowMatchSchedule.flux_mu(GH * GW),
                                   linspace_endpoint=True)
    t = sch.timesteps[[0, 9]]
    x = np.zeros((2, GH * GW, jcfg.in_channels), np.float32)
    cond = _cond()
    jc = {k: jnp.asarray(v) for k, v in cond.items()}
    _, ct = tcore.prepare(torch.from_numpy(x), torch.from_numpy(t),
                          {k: torch.from_numpy(v) for k, v in cond.items()})
    vec = ct["vec"].numpy()
    fixed = _np(jcore.prepare(params, jnp.asarray(x), jnp.asarray(t / 1000), jc)[1]["vec"])
    faulty = _np(jcore.prepare(params, jnp.asarray(x), jnp.asarray(t), jc)[1]["vec"])
    # t / 1000 * 1000 may be one f32 ulp off t (6e-5 at 1000) -> 1e-4
    np.testing.assert_allclose(vec, fixed, atol=1e-4, rtol=1e-4)
    assert _rel(vec, faulty) > 0.1


def test_random_init_and_unported_paths():
    cfg = T.FluxConfig.tiny()
    m = T.FluxModel(cfg, "cpu").init(torch.Generator().manual_seed(0))
    assert not m.single_blocks[0].lin1.bias.any()
    assert (m.double_blocks[1].img_qk_scale == 1).all()
    std = float(m.single_blocks[0].lin2.weight.detach().std())
    d_in = cfg.hidden + cfg.mlp_dim
    assert abs(std - d_in ** -0.5) < 0.1 * d_in ** -0.5
    core = T.make_flux_core(m, TXT, GH, GW)
    x, t = torch.zeros(1, GH * GW, cfg.in_channels), torch.ones(1)
    cond = {k: torch.from_numpy(v[:1]) for k, v in _cond().items()}
    # FramePack's embedded tokens now join the image stream ahead of x's
    pre = torch.randn(1, 3, cfg.hidden)
    h, _ = core.prepare(x, t, dict(cond, img_pre_tokens=[pre]))
    assert h.shape == (1, 3 + GH * GW, cfg.hidden) and torch.equal(h[:, :3], pre)
    # without a pooled vector (Qwen-Image) vec is the time embedding alone
    _, ctx = core.prepare(x, t, {"txt": cond["txt"]})
    np.testing.assert_array_equal(
        ctx["vec"].numpy(),
        m.time_in(T.timestep_embedding(t, cfg.time_embed_dim)).detach().numpy())
    with pytest.raises(ValueError, match="axes_dims"):
        T.flux_rope_tables(T.FluxConfig.tiny(axes_dims=(8, 8, 8)), 4, 2, 2)


# ---------------------------------------------------------------- sampler
@pytest.mark.parametrize("mode", ["magcache", "calibrate"])
def test_sample_euler_matches_jax(mode):
    steps = 28 if mode == "magcache" else 8
    jcfg, params, model = _models("float32", seed=2)
    jcore = J.make_flux_core(jcfg, TXT, GH, GW)
    tcore = T.make_flux_core(model, TXT, GH, GW)
    sch = FlowMatchSchedule.create(steps, mu=FlowMatchSchedule.flux_mu(GH * GW),
                                   linspace_endpoint=True)
    dts = np.diff(sch.sigmas)
    x = np.random.default_rng(3).standard_normal(
        (1, GH * GW, jcfg.in_channels)).astype(np.float32)
    cond = _cond(rows=1)
    jc = {k: jnp.asarray(v) for k, v in cond.items()}
    tc = {k: torch.from_numpy(v) for k, v in cond.items()}
    jts = sch.timesteps / 1000      # what JAX's model must get (module doc)
    if mode == "calibrate":
        jx, jstats = jax.jit(lambda p, x_, c: jsampler.calibrate_euler(
            jcore, p, x_, c, timesteps=jts, dts=dts, lanes=1))(params, jnp.asarray(x), jc)
        tx, tstats = sample_euler(tcore, torch.from_numpy(x), tc,
                                  timesteps=sch.timesteps, dts=dts, calibrate=True)
        assert tstats.shape == (steps - 1, 1, 3)
        np.testing.assert_allclose(tstats, np.asarray(jstats), atol=1e-4, rtol=1e-4)
    else:
        jx, jskips = jax.jit(lambda p, x_, c: jsampler.sample_euler(
            jcore, p, x_, c, timesteps=jts, dts=dts,
            cache_cfg=j_make_config("flux-dev", steps), return_skips=True))(
                params, jnp.asarray(x), jc)
        cache_cfg = make_config("flux-dev", steps)
        tx, tskips = sample_euler(tcore, torch.from_numpy(x), tc,
                                  timesteps=sch.timesteps, dts=dts,
                                  cache_cfg=cache_cfg, return_skips=True)
        want = compute_skip_schedule(cache_cfg).reshape(steps, 1)
        np.testing.assert_array_equal(tskips, want)
        np.testing.assert_array_equal(tskips, np.asarray(jskips))
        assert int(tskips.sum()) == 19
    np.testing.assert_allclose(tx.numpy(), _np(jx), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("model_key,skipped", [("flux-dev", 19),
                                               ("flux-kontext-dev", 14)])
def test_flux_skip_schedules_bit_equal_to_jax(model_key, skipped):
    for kw in ({}, dict(thresh=0.12, K=3, retention_ratio=0.2)):
        got = compute_skip_schedule(make_config(model_key, 28, **kw))
        np.testing.assert_array_equal(got, np.asarray(j_schedule(
            j_make_config(model_key, 28, **kw))))
        if not kw:
            assert int(got.sum()) == skipped


# ---------------------------------------------------------------- pipeline
def _pipeline_pair(monkeypatch, **kw):
    base = dict(tiny=True, height=64, width=64, num_inference_steps=10, txt_len=TXT,
                dtype="float32")
    base.update(kw)
    j = jpipe.FluxPipeline(jpipe.FluxPipelineConfig(**base))
    tcfg = tpipe.FluxPipelineConfig(**base)
    model = T.FluxModel(tcfg.model_config(), "cpu")
    model.load_state_dict(flux_params_from_numpy(
        jax.tree.map(np.asarray, j.params), tcfg.model_config(), "cpu"))
    t = tpipe.FluxPipeline(tcfg, "cpu", model=model)
    # JAX's pipeline fed t / 1000 (module doc); both start from JAX's noise
    sch = j._schedule()
    fixed = dataclasses.replace(sch, timesteps=(sch.timesteps / 1000).astype(np.float32))
    monkeypatch.setattr(j, "_schedule", lambda: fixed)
    z = _np(jax.random.normal(j_set_seed(5), (1, GH * GW, 16), jnp.float32))
    monkeypatch.setattr(t, "_initial_noise", lambda seed: torch.from_numpy(z))
    np.testing.assert_array_equal(t.schedule.sigmas, sch.sigmas)
    return j, t


@pytest.mark.parametrize("kw", [
    dict(model="flux-dev", use_magcache=True, magcache_thresh=0.5, magcache_K=2),
    dict(model="flux-kontext-dev", use_magcache=True, magcache_thresh=0.3),
    dict(model="flux-dev", use_magcache=True,
         mag_ratios_override=tuple(np.linspace(1.0, 0.9, 9))),
    dict(model="flux-dev", magcache_calibration=True)])
def test_pipeline_latents_match_jax(kw, monkeypatch):
    jp, tp = _pipeline_pair(monkeypatch, **kw)
    gen = {}
    if "kontext" in kw["model"]:
        cl = np.random.default_rng(6).standard_normal((1, GH * GW, 16)).astype(np.float32)
        gen = dict(cond_latents=cl)
    jp.record_skips = True
    want = jp.generate("a red fox in snow", seed=5,
                       **{k: jnp.asarray(v) for k, v in gen.items()})
    got = tp.generate("a red fox in snow", seed=5,
                      **{k: torch.from_numpy(v) for k, v in gen.items()})
    assert got.latents.shape == (1, GH * GW, 16)
    np.testing.assert_allclose(got.latents.numpy(), _np(want.latents),
                               atol=1e-4, rtol=1e-4)
    if kw.get("magcache_calibration"):
        assert got.skips is None
        for name, vals in got.calibration.items():
            np.testing.assert_allclose(vals, want.calibration[name], atol=2e-5)
    else:
        np.testing.assert_array_equal(got.skips, np.asarray(want.skips))
        np.testing.assert_array_equal(
            got.skips, compute_skip_schedule(tp._cache_cfg()).reshape(10, 1))
        assert got.skips.any()


def test_skip_mask_for_and_skip_override_match_jax(monkeypatch):
    jp, tp = _pipeline_pair(monkeypatch, num_inference_steps=28)
    for kw in (dict(), dict(thresh=0.12, K=3, retention_ratio=0.2),
               dict(use_magcache=False)):
        np.testing.assert_array_equal(tp.skip_mask_for(**kw), jp.skip_mask_for(**kw))
    mask = tp.skip_mask_for(thresh=0.12, K=3)
    assert mask.shape == (28, 1) and mask.any()
    want = jp.generate("a fox", seed=5, skip_override=mask)
    got = tp.generate("a fox", seed=5, skip_override=mask)
    np.testing.assert_array_equal(got.skips, mask)
    np.testing.assert_allclose(got.latents.numpy(), _np(want.latents),
                               atol=1e-4, rtol=1e-4)


def test_pipeline_unported_paths_raise():
    for kw, exc in ((dict(lora_path="x.safetensors"), ValueError),
                    (dict(dp=2), ValueError), (dict(tp=0), ValueError),
                    (dict(model="flux-schnell"), ValueError)):
        with pytest.raises(exc):
            tpipe.FluxPipelineConfig(tiny=True, **kw)
    with pytest.raises(ValueError, match="batch is 1"):
        tpipe.FluxPipelineConfig(tiny=True, dp=2)
    # sp and tp run on a plan of their grid (tests/test_torch_tp_flux.py)
    with pytest.raises(ValueError, match="needs a plan of that grid"):
        tpipe.FluxPipeline(tpipe.FluxPipelineConfig(tiny=True, tp=2), "cpu")
    # a checkpoint directory is loaded (tests/test_torch_lora.py loads real ones)
    with pytest.raises(FileNotFoundError, match="/nonexistent"):
        tpipe.FluxPipeline(tpipe.FluxPipelineConfig(tiny=True, ckpt_dir="/nonexistent"), "cpu")
    cfg = tpipe.FluxPipelineConfig(tiny=True, height=64, width=64,
                                   num_inference_steps=2, txt_len=TXT,
                                   magcache_calibration=True)
    with pytest.raises(ValueError, match="skip_override"):
        tpipe.FluxPipeline(cfg, "cpu").generate("a", skip_override=np.zeros((2, 1), bool))


# ---------------------------------------------------------------- CLI
def test_cli_flux_tiny_routes(tmp_path, capsys):
    out = str(tmp_path / "fd")
    cli.main(["--task", "flux-dev", "--tiny", "--device", "cpu", "--use_magcache",
              "--save_file", out])
    lat = np.load(out + "_latents.npy")
    assert lat.shape == (1, 16, 16) and np.isfinite(lat).all()
    text = capsys.readouterr().out
    assert "skipped 19 of 28 forwards" in text
    assert ("skipped steps [3, 4, 6, 7, 8, 10, 12, 13, 14, 15, 16, 18, 19, 20, "
            "21, 22, 24, 25, 27]") in text
    cal = str(tmp_path / "cal")
    cli.main(["--task", "flux-kontext-dev", "--tiny", "--device", "cpu",
              "--magcache_calibration", "--sample_steps", "8", "--save_file", cal])
    ratios = json.load(open(cal + "_mag_ratio.json"))
    assert len(ratios) == 7 and all(np.isfinite(ratios))
    cli.main(["--task", "flux-kontext-dev", "--tiny", "--device", "cpu",
              "--use_magcache", "--save_file", str(tmp_path / "fk")])
    assert "skipped 14 of 28 forwards" in capsys.readouterr().out
    # --image conditions Kontext as the JAX CLI does without --vae_ckpt (the
    # image resized and channel-tiled onto the latent grid); FLUX.1-dev is t2i
    img = str(tmp_path / "in.npy")
    np.save(img, np.random.default_rng(3).uniform(size=(24, 40, 3)).astype(np.float32))
    runs = {}
    for name, extra in (("plain", []), ("image", ["--image", img])):
        cli.main(["--task", "flux-kontext-dev", "--tiny", "--device", "cpu", "--sample_steps",
                  "4", "--save_file", str(tmp_path / name)] + extra)
        runs[name] = np.load(str(tmp_path / name) + "_latents.npy")
    assert runs["image"].shape == (1, 16, 16) and np.isfinite(runs["image"]).all()
    assert np.abs(runs["image"] - runs["plain"]).max() > 1e-4
    with pytest.raises(SystemExit, match="only flux-kontext-dev"):
        cli.main(["--task", "flux-dev", "--tiny", "--device", "cpu", "--image", img])
