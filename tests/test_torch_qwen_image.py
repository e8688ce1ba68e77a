"""The port's Qwen-Image slice against the JAX package on the CPU: the
weight converter (FLUX's tree with zero-length single stacks, and
``txt_norm``), the core's prepare/trunk/head for text-to-image and Edit (a
reference on its own rope block, the head on the noise tokens), the
double-blocks-only trunk, the reference's timestep fault (shown, not
inherited), the pipeline at full compute, with MagCache, in calibration and
with ``skip_override`` (two lanes, true CFG), the skip schedules, the CLI's
tiny runs and the published size.

Both sides get the same weights (``init_qwen_image_params`` with its biases
and gains perturbed, converted by ``qwen_image_params_from_numpy``) and the
same numpy inputs; the pipelines start from JAX's noise. The JAX pipeline
hands its FLUX core the scheduler's ``sigma * 1000``, which the core
multiplies by 1000 again; the port embeds ``sigma * 1000``. To compare like
with like the JAX side is fed ``t / 1000`` throughout.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.core.magcache import compute_skip_schedule as j_schedule
from magcache_tpu.cli import generate as jcli
from magcache_tpu.core.presets import make_config as j_make_config
from magcache_tpu.models import flux as JF
from magcache_tpu.models import vae_wan as JW
from magcache_tpu.models import qwen_image as J
from magcache_tpu.pipelines import qwen_image as jpipe
from magcache_tpu.utils.misc import set_seed as j_set_seed
from magcache_tpu_torch.cli import generate as cli
from magcache_tpu_torch.core.magcache import compute_skip_schedule
from magcache_tpu_torch.core.presets import make_config
from magcache_tpu_torch.models import qwen_image as T
from magcache_tpu_torch.models import vae_wan as TW
from magcache_tpu_torch.models.convert import (qwen_image_params_from_numpy,
                                               wan_vae_params_from_numpy)
from magcache_tpu_torch.pipelines import qwen_image as tpipe
from magcache_tpu_torch.schedulers.flow_match import FlowMatchSchedule

# f32 on both sides: GEMM and reduction order, and t / 1000 * 1000 one f32
# ulp off t in the timestep features
F32_TOL = 1e-4
# bf16: JAX rounds the linears' bias adds and the gelu at other points
BF16_REL_L2 = 5e-2
TXT, GH, GW = 8, 4, 4
STEPS = 10


def _np(a):
    return np.array(a, np.float32)


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _tree(dtype="float32", seed=0):
    params = J.init_qwen_image_params(jax.random.PRNGKey(seed), J.QwenImageConfig.tiny(
        dtype=dtype))
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed + 40)
    # the JAX init zeroes biases and sets unit gains: give them values
    for leaf in tree["double"].values():
        if isinstance(leaf, dict):
            leaf["b"] = (rng.standard_normal(leaf["b"].shape) * 0.05).astype(leaf["b"].dtype)
    tree["txt_norm"] = (1.0 + 0.1 * rng.standard_normal(tree["txt_norm"].shape)).astype(
        np.float32)
    return tree


def _models(dtype="float32", seed=0):
    tree = _tree(dtype, seed)
    tcfg = T.QwenImageConfig.tiny(dtype=dtype)
    model = T.QwenImageModel(tcfg, "cpu")
    model.load_state_dict(qwen_image_params_from_numpy(tree, tcfg, "cpu"))
    return J.QwenImageConfig.tiny(dtype=dtype), jax.tree.map(jnp.asarray, tree), model


def _cond(rows=2, refs=0, seed=1):
    rng = np.random.default_rng(seed)
    c = {"txt": rng.standard_normal((rows, TXT, 24)).astype(np.float32)}
    if refs:
        c["ref"] = rng.standard_normal((rows, refs * GH * GW, 16)).astype(np.float32)
    return c


# ---------------------------------------------------------------- model
def test_converter_carries_every_parameter():
    tree = _tree("bfloat16")
    tcfg = T.QwenImageConfig.tiny(dtype="bfloat16")
    sd = T.QwenImageModel(tcfg, "cpu").state_dict()
    conv = qwen_image_params_from_numpy(tree, tcfg, "cpu")
    assert sd.keys() == conv.keys()
    assert tree["single"]["lin1"]["w"].shape[0] == 0
    assert not any(k.startswith("mmdit.single_blocks") for k in sd)
    assert "mmdit.guidance_in.in.weight" not in sd and "mmdit.vector_in.in.weight" in sd
    for k, v in sd.items():
        assert v.dtype == conv[k].dtype and v.shape == conv[k].shape, k
    assert sd["mmdit.double_blocks.1.img_mlp1.weight"].dtype == torch.bfloat16
    assert sd["txt_norm"].dtype == torch.float32
    np.testing.assert_array_equal(conv["txt_norm"].numpy(), tree["txt_norm"])


@pytest.mark.parametrize("refs", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_core_matches_jax(dtype, refs):
    jcfg, params, model = _models(dtype)
    jcore = J.make_qwen_image_core(jcfg, TXT, GH, GW, ref_images=refs)
    tcore = T.make_qwen_image_core(model, TXT, GH, GW, ref_images=refs)
    x = np.random.default_rng(2).standard_normal((2, GH * GW, 16)).astype(np.float32)
    t = np.array([1000.0, 400.0], np.float32)
    cond = _cond(refs=refs)
    hj, cj = jax.jit(jcore.prepare)(params, jnp.asarray(x), jnp.asarray(t / 1000),
                                    {k: jnp.asarray(v) for k, v in cond.items()})
    trj = jax.jit(jcore.trunk)(params, hj, cj)
    oj = jax.jit(jcore.head)(params, trj, cj)
    ht, ct = tcore.prepare(torch.from_numpy(x), torch.from_numpy(t),
                           {k: torch.from_numpy(v) for k, v in cond.items()})
    n_img = GH * GW * (1 + refs)
    assert ht.shape == (2, n_img, 96) and ht.dtype == model.cfg.to_flux().torch_dtype
    feed = {k: torch.from_numpy(_np(v)).to(ct[k].dtype) for k, v in cj.items()}
    trt = tcore.trunk(torch.from_numpy(_np(hj)).to(ht.dtype), feed).float().numpy()
    ot = tcore.head(tcore.trunk(ht, ct), ct).numpy()
    assert ot.shape == (2, GH * GW, 16) and np.isfinite(ot).all()
    for got, want in ((ct["txt"].float().numpy(), _np(cj["txt"])), (ct["vec"].numpy(),
                      _np(cj["vec"])), (ht.float().numpy(), _np(hj)), (trt, _np(trj)),
                      (ot, _np(oj))):
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
        else:
            assert _rel(got, want) < BF16_REL_L2


def test_edit_rope_and_head_keep_the_noise_tokens():
    _, _, model = _models()
    cfg = model.mmdit.cfg
    cos, sin = T.qwen_image_rope_tables(cfg, TXT, GH, GW, 2)
    n = GH * GW
    assert cos.shape == (TXT + 3 * n, cfg.head_dim // 2)
    # reference k on its own index-axis id k
    k1 = T.flux_img_rope_block(cfg, GH, GW, 1)
    np.testing.assert_array_equal(cos[TXT + n:TXT + 2 * n], k1[0])
    assert not np.array_equal(cos[TXT + 2 * n:], k1[0])
    core = T.make_qwen_image_core(model, TXT, GH, GW, ref_images=1)
    cond = {k: torch.from_numpy(v) for k, v in _cond(refs=1).items()}
    h, ctx = core.prepare(torch.zeros(2, n, 16), torch.full((2,), 500.0), cond)
    out = core.head(h, ctx)
    # LayerNorm and the linear act per token: the head on the noise tokens
    # alone (the port) equals the head over all tokens cut after it (JAX)
    plain = T.make_qwen_image_core(model, TXT, GH, GW)
    assert out.shape == (2, n, 16)
    np.testing.assert_allclose(out.numpy(), plain.head(h, ctx)[:, :n].numpy(), atol=1e-6)


def test_trunk_without_single_blocks_returns_the_double_stack():
    """``depth_single = 0``: the image stream after the last double block is
    the trunk's output itself, no text concat and split around an empty
    single stack."""
    _, _, model = _models()
    core = T.make_qwen_image_core(model, TXT, GH, GW)
    h, ctx = core.prepare(torch.randn(2, GH * GW, 16), torch.full((2,), 700.0),
                          {k: torch.from_numpy(v) for k, v in _cond().items()})
    seen = []
    last = model.mmdit.double_blocks[-1]
    hook = last.register_forward_hook(lambda m, args, out: seen.append(out[0]))
    try:
        out = core.trunk(h, ctx)
    finally:
        hook.remove()
    assert out is seen[0] and out.shape == h.shape


def test_timestep_fault_of_the_reference_is_not_inherited():
    # JAX's pipeline hands its core sigma*1000 and the FLUX core embeds t*1000:
    # its time MLP sees sigma*1e6. The port's vec equals JAX's fed t/1000 (the
    # published model's sigma*1000) and differs from JAX's fed t.
    jcfg, params, model = _models()
    jcore = J.make_qwen_image_core(jcfg, TXT, GH, GW)
    tcore = T.make_qwen_image_core(model, TXT, GH, GW)
    sch = FlowMatchSchedule.create(50, mu=FlowMatchSchedule.flux_mu(GH * GW),
                                   linspace_endpoint=True)
    t = sch.timesteps[[0, 20]]
    x = np.zeros((2, GH * GW, 16), np.float32)
    cond = _cond()
    jc = {k: jnp.asarray(v) for k, v in cond.items()}
    _, ct = tcore.prepare(torch.from_numpy(x), torch.from_numpy(t),
                          {k: torch.from_numpy(v) for k, v in cond.items()})
    vec = ct["vec"].numpy()
    fixed = _np(jcore.prepare(params, jnp.asarray(x), jnp.asarray(t / 1000), jc)[1]["vec"])
    faulty = _np(jcore.prepare(params, jnp.asarray(x), jnp.asarray(t), jc)[1]["vec"])
    np.testing.assert_allclose(vec, fixed, atol=F32_TOL, rtol=F32_TOL)
    assert _rel(vec, faulty) > 0.1


def test_random_init_and_published_size():
    m = T.QwenImageModel(T.QwenImageConfig.tiny(), "cpu").init(torch.Generator().manual_seed(0))
    assert (m.txt_norm == 1).all() and not m.mmdit.double_blocks[0].img_qkv.bias.any()
    big = T.QwenImageModel(T.QWEN_IMAGE, "meta")
    n = sum(p.numel() for p in big.parameters())
    # 60 double blocks of 36 h^2 at h = 3,072, and the embedders: 20.4 B
    assert 20.40e9 < n < 20.45e9
    assert len(big.mmdit.single_blocks) == 0 and big.cfg.head_dim == 128
    assert dataclasses.asdict(T.QWEN_IMAGE) == {
        k: v for k, v in dataclasses.asdict(J.QwenImageConfig()).items() if k != "remat"}


# ---------------------------------------------------------------- pipeline
def _pipeline_pair(monkeypatch, **kw):
    base = dict(tiny=True, height=64, width=64, sample_steps=STEPS, txt_len=TXT,
                dtype="float32")
    base.update(kw)
    tree = _tree()
    j = jpipe.QwenImagePipeline(jpipe.QwenImagePipelineConfig(**base),
                                params=jax.tree.map(jnp.asarray, tree))
    tcfg = tpipe.QwenImagePipelineConfig(**base)
    model = T.QwenImageModel(tcfg.model_config(), "cpu")
    model.load_state_dict(qwen_image_params_from_numpy(tree, tcfg.model_config(), "cpu"))
    t = tpipe.QwenImagePipeline(tcfg, "cpu", model=model)
    # JAX's pipeline fed t / 1000 (module doc); both start from JAX's noise
    sch = j._schedule()
    fixed = dataclasses.replace(sch, timesteps=(sch.timesteps / 1000).astype(np.float32))
    monkeypatch.setattr(j, "_schedule", lambda: fixed)
    z = _np(jax.random.normal(j_set_seed(5), (1, GH * GW, 16), jnp.float32))
    monkeypatch.setattr(t, "_initial_noise", lambda seed: torch.from_numpy(z))
    np.testing.assert_array_equal(t.schedule.sigmas, sch.sigmas)
    return j, t


@pytest.mark.parametrize("kw", [
    dict(model="qwen-image"),
    dict(model="qwen-image", use_magcache=True, magcache_thresh=0.3),
    dict(model="qwen-image-edit", use_magcache=True, magcache_thresh=0.3),
    dict(model="qwen-image", use_magcache=True,
         mag_ratios_override=tuple(np.linspace(1.0, 0.9, 18))),
    dict(model="qwen-image-edit", magcache_calibration=True)])
def test_pipeline_latents_match_jax(kw, monkeypatch):
    jp, tp = _pipeline_pair(monkeypatch, **kw)
    gen = {}
    if "edit" in kw["model"]:
        gen = dict(ref_latents=np.random.default_rng(6).standard_normal(
            (1, GH * GW, 16)).astype(np.float32))
    want = jp.generate("a red fox in snow", seed=5,
                       **{k: jnp.asarray(v) for k, v in gen.items()})
    got = tp.generate("a red fox in snow", seed=5,
                      **{k: torch.from_numpy(v) for k, v in gen.items()})
    assert got.latents.shape == (1, GH * GW, 16) and got.timings["text_s"] >= 0
    np.testing.assert_allclose(got.latents.numpy(), _np(want.latents), atol=F32_TOL,
                               rtol=F32_TOL)
    if kw.get("magcache_calibration"):
        assert got.skips is None
        assert len(got.calibration["norm_ratio"]) == 2 * (STEPS - 1)
        for name, vals in got.calibration.items():
            np.testing.assert_allclose(vals, want.calibration[name], atol=2e-5)
    else:
        use = kw.get("use_magcache", False)
        np.testing.assert_array_equal(got.skips, jp.skip_mask_for(use_magcache=use))
        np.testing.assert_array_equal(got.skips, tp.skip_mask_for(use_magcache=use))
        assert got.skips.shape == (STEPS, 2) and got.skips.any() == use


def test_edit_without_reference_matches_jax_zeros(monkeypatch):
    jp, tp = _pipeline_pair(monkeypatch, model="qwen-image-edit", sample_steps=3)
    np.testing.assert_allclose(tp.generate("a fox", seed=5).latents.numpy(),
                               _np(jp.generate("a fox", seed=5).latents), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("with_vae", [False, True])
def test_reference_encode_matches_the_jax_cli(with_vae):
    """Edit's reference latents: the JAX CLI's ``_image_to_grid_latent`` (a
    Wan VAE's one-frame encode, or the nearest resize and channel tile),
    packed 2x2."""
    jvae = tvae = None
    if with_vae:
        params = JW.init_wan_vae_params(jax.random.PRNGKey(3), JW.WanVAEConfig.tiny())
        jvae = JW.WanVAE(JW.WanVAEConfig.tiny(), params)
        tvae = TW.WanVAE(TW.WanVAEConfig.tiny(), "cpu")
        tvae.load_state_dict(wan_vae_params_from_numpy(jax.tree.map(np.asarray, params),
                                                       tvae.cfg))
    pipe = tpipe.QwenImagePipeline(tpipe.QwenImagePipelineConfig(
        model="qwen-image-edit", tiny=True, height=64, width=64, txt_len=TXT,
        dtype="float32"), "cpu", vae=tvae)
    img = np.random.default_rng(8).uniform(size=(16, 12, 3)).astype(np.float32)
    lat = jcli._image_to_grid_latent(types.SimpleNamespace(vae=jvae), img, 2 * GH, 2 * GW, 4)
    want = _np(JF.pack_latents(jnp.asarray(lat, jnp.float32)[None]))
    got = pipe.encode_image(img)
    assert got.shape == (1, GH * GW, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_skip_mask_for_and_skip_override_match_jax(monkeypatch):
    jp, tp = _pipeline_pair(monkeypatch, sample_steps=STEPS)
    for kw in (dict(), dict(thresh=0.3, K=3, retention_ratio=0.2), dict(use_magcache=False)):
        np.testing.assert_array_equal(tp.skip_mask_for(**kw), jp.skip_mask_for(**kw))
    mask = tp.skip_mask_for(thresh=0.3, K=3)
    # a lane-asymmetric step too: the uncond lane computes where cond skips
    mask[np.flatnonzero(mask.all(1))[:1], 1] = False
    assert mask.shape == (STEPS, 2) and (mask.sum(1) == 1).any()
    want = jp.generate("a fox", seed=5, skip_override=mask)
    got = tp.generate("a fox", seed=5, skip_override=mask)
    np.testing.assert_array_equal(got.skips, mask)
    np.testing.assert_allclose(got.latents.numpy(), _np(want.latents), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("model_key", ["qwen-image", "qwen-image-edit"])
def test_skip_schedules_bit_equal_to_jax(model_key):
    for steps in (50, 20):
        for kw in ({}, dict(thresh=0.12, K=3, retention_ratio=0.2)):
            got = compute_skip_schedule(make_config(model_key, steps, **kw))
            np.testing.assert_array_equal(got, np.asarray(j_schedule(
                j_make_config(model_key, steps, **kw))))
            assert got.shape == (2 * steps,)


def test_pipeline_refusals():
    with pytest.raises(ValueError, match="Qwen-Image model"):
        tpipe.QwenImagePipelineConfig(model="qwen-image-2")
    cfg = tpipe.QwenImagePipelineConfig(tiny=True, height=64, width=64, sample_steps=2,
                                        txt_len=TXT, magcache_calibration=True)
    with pytest.raises(ValueError, match="skip_override"):
        tpipe.QwenImagePipeline(cfg, "cpu").generate("a", skip_override=np.zeros((2, 2), bool))


# ---------------------------------------------------------------- CLI
def test_cli_qwen_tiny_runs(tmp_path, capsys, monkeypatch):
    prompts = []
    orig = tpipe.QwenImagePipeline.generate

    def spy(self, prompt, **kw):
        prompts.append((self.config.model, prompt, sorted(kw)))
        return orig(self, prompt, **kw)

    monkeypatch.setattr(tpipe.QwenImagePipeline, "generate", spy)
    img = str(tmp_path / "in.npy")
    np.save(img, np.random.default_rng(3).uniform(size=(24, 40, 3)).astype(np.float32))
    runs = {}
    for name, extra in (("t2i", []), ("edit", ["--image", img]),
                        ("edit-task", ["--task", "qwen-image-edit"])):
        out = str(tmp_path / name)
        cli.main(["--task", "qwen-image", "--tiny", "--device", "cpu", "--use_magcache",
                  "--save_file", out] + extra)
        runs[name] = np.load(out + "_latents.npy")
        assert runs[name].shape == (1, 16, 16) and np.isfinite(runs[name]).all()
        text = capsys.readouterr().out
        assert "lane-forwards (cond + uncond per step)" in text and "of 100" in text
    assert [p[0] for p in prompts] == ["qwen-image", "qwen-image-edit", "qwen-image-edit"]
    # the "positive magic" suffix for text-to-image only
    assert prompts[0][1].endswith(", Ultra HD, 4K, cinematic composition.")
    assert not prompts[1][1].endswith("composition.") and prompts[1][2] == ["ref_latents",
                                                                          "seed"]
    assert prompts[2][2] == ["seed"]
    assert not np.array_equal(runs["edit"], runs["edit-task"])
    cal = str(tmp_path / "cal")
    cli.main(["--task", "qwen-image", "--tiny", "--device", "cpu", "--magcache_calibration",
              "--sample_steps", "6", "--save_file", cal])
    ratios = np.array(json.load(open(cal + "_mag_ratio.json")))
    assert ratios.shape == (10,) and np.isfinite(ratios).all()
    cli.main(["--task", "qwen-image", "--tiny", "--device", "cpu", "--use_magcache",
              "--sample_steps", "6", "--mag_ratios_json", cal + "_mag_ratio.json",
              "--save_file", str(tmp_path / "own")])
    assert "of 12 lane-forwards" in capsys.readouterr().out


def test_cli_qwen_needs_the_card_unless_told(monkeypatch):
    with pytest.raises(SystemExit, match="--device cpu"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        cli.main(["--task", "qwen-image", "--tiny"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--task", "qwen-image-edit"])
    with pytest.raises(SystemExit, match="does not apply"):
        cli.main(["--task", "qwen-image", "--device", "cpu", "--tiny", "--enable_pab"])
