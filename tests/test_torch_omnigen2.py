"""The port's OmniGen2 slice against the JAX package on the CPU: the weight
converter (every leaf with its dtype), the core's prepare/trunk/head for
text-to-image and edit with one and two references (f32 and bf16), the GQA
head order, the softmax scale across the head-dim pad, the rounding points,
the rope tables and the TeaCache signal; the pipeline's latents under full
compute, MagCache, dpm++, TeaCache and calibration in both modes; the skip
schedules of the five ``omnigen2-*`` arrays; the config's refusals; the
reference encode and the CLI's tiny runs; the published size.

Both sides get the same weights (``init_omnigen2_params`` with its biases
and gains perturbed, converted by ``omnigen2_params_from_numpy``) and the
same numpy inputs; the pipelines start from JAX's noise. The JAX side is
pinned to the tiny widths and to two shapes: the core at a 12 x 12 token
grid (K1's plain path above 128 tokens, the refiners' too), the pipelines
at 32 x 32 pixels (a 2 x 2 grid).
"""

import dataclasses
import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.cli import generate as jcli
from magcache_tpu.core.magcache import compute_skip_schedule as j_schedule
from magcache_tpu.core.presets import make_config as j_make_config
from magcache_tpu.models import omnigen2 as J
from magcache_tpu.pipelines import omnigen2 as jpipe
from magcache_tpu.utils.misc import set_seed as j_set_seed
from magcache_tpu_torch.cli import generate as cli
from magcache_tpu_torch.core.magcache import compute_skip_schedule
from magcache_tpu_torch.core.presets import make_config
from magcache_tpu_torch.models import omnigen2 as T
from magcache_tpu_torch.models.convert import omnigen2_params_from_numpy
from magcache_tpu_torch.ops.attention import QKNORM_FIXED_MAX, attention, flash_attention_bshd_plain
from magcache_tpu_torch.pipelines import omnigen2 as tpipe

# f32 on both sides: GEMM and reduction order
F32_TOL = 1e-4
# bf16: JAX rounds the linears' bias adds and the silu at other points
BF16_REL_L2 = 5e-2
TXT, GRID = 6, (12, 12)
STEPS = 8
GAINS = ("q_norm", "k_norm", "norm1", "norm2", "ffn_norm1", "ffn_norm2")


def _np(a):
    return np.array(a, np.float32)


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _tree(dtype="float32", seed=0):
    params = J.init_omnigen2_params(jax.random.PRNGKey(seed), J.OmniGen2Config.tiny(dtype=dtype))
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed + 40)

    def perturb(node):
        for k, v in node.items():
            if isinstance(v, dict):
                perturb(v)
            elif k == "b":
                node[k] = (rng.standard_normal(v.shape) * 0.05).astype(v.dtype)
            elif k in GAINS or k == "cap_norm":
                node[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(v.dtype)

    perturb(tree)   # the JAX init zeroes biases and sets unit gains
    return tree


def _model(tree, dtype="float32"):
    cfg = T.OmniGen2Config.tiny(dtype=dtype)
    model = T.OmniGen2Model(cfg, "cpu")
    model.load_state_dict(omnigen2_params_from_numpy(tree, cfg, "cpu"))
    return model


def _cond(rows=2, refs=0, grid=GRID, seed=1):
    rng = np.random.default_rng(seed)
    c = {"txt": rng.standard_normal((rows, TXT, 24)).astype(np.float32)}
    if refs:
        c["ref"] = rng.standard_normal((rows, refs, 2 * grid[0], 2 * grid[1], 16)).astype(
            np.float32)
    return c


# ---------------------------------------------------------------- model
def test_converter_carries_every_leaf_with_its_dtype():
    tree = _tree("bfloat16")
    cfg = T.OmniGen2Config.tiny(dtype="bfloat16")
    sd = T.OmniGen2Model(cfg, "cpu").state_dict()
    conv = omnigen2_params_from_numpy(tree, cfg, "cpu")
    assert sd.keys() == conv.keys()
    # one state-dict entry per JAX leaf, depth stacks counted block by block
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    n = sum(leaf.shape[0] if any(getattr(k, "key", None) in (
        "context_refiner", "noise_refiner", "ref_refiner", "layers") for k in path) else 1
            for path, leaf in leaves)
    assert n == len(conv)
    for k, v in sd.items():
        assert v.dtype == conv[k].dtype and v.shape == conv[k].shape, k
        f32 = (k.split(".")[0] in ("t_embed", "cap_norm", "norm_out_mod", "final_out")
               or ".mod." in k or k.split(".")[-1] in GAINS)
        assert v.dtype == (torch.float32 if f32 else torch.bfloat16), k
    for k in ("cap_proj.weight", "x_embed.bias", "ref_embed.weight", "layers.1.kv.weight",
              "noise_refiner.0.w2.weight", "context_refiner.0.q.weight"):
        assert conv[k].dtype == torch.bfloat16, k
    assert "mod.weight" not in "".join(k for k in conv if k.startswith("context_refiner"))
    np.testing.assert_array_equal(conv["layers.1.k_norm"].numpy(), tree["layers"]["k_norm"][1])
    np.testing.assert_array_equal(conv["layers.0.mod.weight"].numpy(),
                                  tree["layers"]["mod"]["w"][0].T)
    np.testing.assert_array_equal(conv["final_out.bias"].numpy(), tree["final_out"]["b"])


@pytest.mark.parametrize("refs", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_core_matches_jax(dtype, refs):
    tree = _tree(dtype)
    params, model = jax.tree.map(jnp.asarray, tree), _model(tree, dtype)
    jcore = J.make_omnigen2_core(J.OmniGen2Config.tiny(dtype=dtype), TXT, GRID, refs)
    tcore = T.make_omnigen2_core(model, TXT, GRID, refs)
    x = np.random.default_rng(2).standard_normal((2, 24, 24, 16)).astype(np.float32)
    t = np.array([1000.0, 400.0], np.float32)
    cond = _cond(refs=refs)
    hj, cj = jax.jit(jcore.prepare)(params, jnp.asarray(x), jnp.asarray(t),
                                    {k: jnp.asarray(v) for k, v in cond.items()})
    trj = jax.jit(jcore.trunk)(params, hj, cj)
    oj = jax.jit(jcore.head)(params, trj, cj)
    ht, ct = tcore.prepare(torch.from_numpy(x), torch.from_numpy(t),
                           {k: torch.from_numpy(v) for k, v in cond.items()})
    n_tok = TXT + (refs + 1) * math.prod(GRID)
    assert ht.shape == (2, n_tok, 96) and ht.dtype == model.cfg.torch_dtype
    trt = tcore.trunk(torch.from_numpy(_np(hj)).to(ht.dtype), {"temb": ct["temb"]})
    ot = tcore.head(tcore.trunk(ht, ct), ct).numpy()
    assert ot.shape == (2, 24, 24, 16) and ot.dtype == np.float32 and np.isfinite(ot).all()
    for got, want in ((ct["temb"].numpy(), _np(cj["temb"])), (ht.float().numpy(), _np(hj)),
                      (trt.float().numpy(), _np(trj)), (ot, _np(oj))):
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
        else:
            assert _rel(got, want) < BF16_REL_L2


def test_gqa_order_is_jnp_repeat_not_tiled(monkeypatch):
    """4 query heads over 2 kv heads: kv head j serves query heads 2j, 2j+1.
    The tiled order (``.repeat``) gives another model."""
    k = torch.arange(2.0).reshape(1, 1, 2, 1).expand(1, 3, 2, 5)
    got = T.repeat_kv(k, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.repeat(jnp.asarray(k.numpy()),
                                                                      2, axis=2)))
    assert got[0, 0, :, 0].tolist() == [0, 0, 1, 1]
    tree = _tree()
    params, model = jax.tree.map(jnp.asarray, tree), _model(tree)
    jcore = J.make_omnigen2_core(J.OmniGen2Config.tiny(), TXT, GRID, 0)
    tcore = T.make_omnigen2_core(model, TXT, GRID, 0)
    x = np.random.default_rng(2).standard_normal((1, 24, 24, 16)).astype(np.float32)
    hj, cj = jax.jit(jcore.prepare)(params, jnp.asarray(x), jnp.full((1,), 700.0),
                                    {"txt": jnp.asarray(_cond(rows=1)["txt"])})
    want = _np(jax.jit(jcore.trunk)(params, hj, cj))
    h, ctx = torch.from_numpy(_np(hj)), {"temb": torch.from_numpy(_np(cj["temb"]))}
    np.testing.assert_allclose(tcore.trunk(h, ctx).numpy(), want, atol=F32_TOL, rtol=F32_TOL)
    monkeypatch.setattr(T, "repeat_kv", lambda t, rep: t.repeat(1, 1, rep, 1))
    assert _rel(tcore.trunk(h, ctx).numpy(), want) > 1e-3


def test_softmax_scale_is_the_true_head_dim(monkeypatch):
    """The model hands ``attention()`` head dim 120-like q/k/v (here 24)
    unpadded with no scale, so the scale is 1/sqrt(d); the card's zero pad to
    128 is exact with that scale and not with 1/sqrt(128)."""
    seen = []

    def spy(q, k, v, **kw):
        seen.append((q.shape[-1], k.shape, kw))
        return attention(q, k, v, **kw)

    monkeypatch.setattr(T, "attention", spy)
    model = _model(_tree())
    core = T.make_omnigen2_core(model, TXT, GRID, 1)
    cond = {k: torch.from_numpy(v) for k, v in _cond(rows=1, refs=1).items()}
    h, ctx = core.prepare(torch.zeros(1, 24, 24, 16), torch.full((1,), 500.0), cond)
    core.trunk(h, ctx)
    assert {s[0] for s in seen} == {model.cfg.head_dim}
    assert {s[1][2] for s in seen} == {model.cfg.heads}           # kv repeated to 4 heads
    assert all(s[2] == {"fixed_max": QKNORM_FIXED_MAX} for s in seen)
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((1, 160, 3, 120), generator=g) for _ in range(3))
    want = attention(q, k, v, fixed_max=16.0)
    pad = [torch.nn.functional.pad(t, (0, 8)) for t in (q, k, v)]
    exact = flash_attention_bshd_plain(*pad, scale=120 ** -0.5, fixed_max=16.0)[..., :120]
    np.testing.assert_allclose(exact.numpy(), want.numpy(), atol=1e-6)
    wrong = flash_attention_bshd_plain(*pad, fixed_max=16.0)[..., :120]
    assert _rel(wrong.numpy(), want.numpy()) > 1e-3


def test_rounding_points_are_jax_bit_for_bit():
    """bf16: ``norm(x) * (1 + s)`` and ``tanh(g) * branch`` are taken in f32
    and rounded once, as the JAX block rounds them."""
    rng = np.random.default_rng(4)
    n = jnp.asarray(rng.standard_normal((2, 7, 96)), jnp.bfloat16)
    s = jnp.asarray(rng.standard_normal((2, 1, 96)) * 0.7, jnp.float32)
    tn, ts = torch.from_numpy(_np(n)).bfloat16(), torch.from_numpy(_np(s))
    want_scaled = (n.astype(jnp.float32) * (1 + s)).astype(n.dtype)
    want_gated = (jnp.tanh(s) * n.astype(jnp.float32)).astype(n.dtype)
    np.testing.assert_array_equal(T._scaled(tn, ts).float().numpy(), _np(want_scaled))
    np.testing.assert_array_equal(T._gated(tn, ts).float().numpy(), _np(want_gated))
    assert T._scaled(tn, None) is tn and T._gated(tn, None) is tn


@pytest.mark.parametrize("refs", [0, 2])
def test_rope_tables_match_jax(refs):
    cfg = T.OmniGen2Config.tiny()
    for txt, grid in ((TXT, GRID), (128, (64, 64))):
        got = T.omnigen2_rope_tables(T.OMNIGEN2 if txt == 128 else cfg, txt, grid, refs)
        want = J._rope_tables(J.OmniGen2Config() if txt == 128 else J.OmniGen2Config.tiny(),
                              txt, grid, refs)
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape == (txt + (refs + 1) * math.prod(grid),
                                                         (60 if txt == 128 else 12))
            np.testing.assert_array_equal(g, w)
    # text rows rotate on the sequence axis only; image k takes id txt + k
    cos, sin = T.omnigen2_rope_tables(cfg, TXT, (2, 2), 1)
    assert (cos[:TXT, 4:] == 1).all() and (sin[:TXT, 4:] == 0).all()
    inv = 10000.0 ** (-np.arange(0, 8, 2) / 8)
    for k in (0, 1):                         # the reference, then the noise
        rows = slice(TXT + 4 * k, TXT + 4 * (k + 1))
        np.testing.assert_allclose(cos[rows, :4], np.cos((TXT + k) * inv)[None].repeat(4, 0),
                                   rtol=1e-6)


def test_teacache_signal_and_head_match_jax():
    tree = _tree()
    params, model = jax.tree.map(jnp.asarray, tree), _model(tree)
    jcore = J.make_omnigen2_core(J.OmniGen2Config.tiny(), TXT, GRID, 1)
    tcore = T.make_omnigen2_core(model, TXT, GRID, 1)
    cond = _cond(refs=1)
    x = np.random.default_rng(5).standard_normal((2, 24, 24, 16)).astype(np.float32)
    hj, cj = jax.jit(jcore.prepare)(params, jnp.asarray(x), jnp.asarray([900.0, 200.0]),
                                    {k: jnp.asarray(v) for k, v in cond.items()})
    want = _np(J.make_teacache_signal(J.OmniGen2Config.tiny())(params, hj, cj))
    h, ctx = torch.from_numpy(_np(hj)), {"temb": torch.from_numpy(_np(cj["temb"]))}
    got = T.make_teacache_signal(model)(h, ctx)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)
    # the head reads the noise tokens only (the last grid's worth)
    h2 = h.clone()
    h2[:, :-math.prod(GRID)] = 7.0
    np.testing.assert_array_equal(tcore.head(h2, ctx).numpy(), tcore.head(h, ctx).numpy())


def test_random_init_and_published_size():
    m = T.OmniGen2Model(T.OmniGen2Config.tiny(), "cpu").init(torch.Generator().manual_seed(0))
    assert (m.layers[0].norm1 == 1).all() and not m.x_embed.bias.any()
    big = T.OmniGen2Model(T.OMNIGEN2, "meta")
    n = sum(p.numel() for p in big.parameters())
    assert 3.011e9 < n < 3.013e9
    assert (T.OMNIGEN2.head_dim, T.OMNIGEN2.ffn_dim, len(big.layers)) == (120, 6912, 32)
    assert dataclasses.asdict(T.OMNIGEN2) == {
        k: v for k, v in dataclasses.asdict(J.OmniGen2Config()).items() if k != "remat"}


# ---------------------------------------------------------------- pipeline
def _pipeline_pair(monkeypatch, **kw):
    base = dict(tiny=True, height=32, width=32, num_inference_steps=STEPS, txt_len=TXT,
                dtype="float32")
    base.update(kw)
    tree = _tree()
    j = jpipe.OmniGen2Pipeline(jpipe.OmniGen2PipelineConfig(**base),
                               params=jax.tree.map(jnp.asarray, tree))
    t = tpipe.OmniGen2Pipeline(tpipe.OmniGen2PipelineConfig(**base), "cpu",
                               model=_model(tree))
    z = _np(jax.random.normal(j_set_seed(5), (1, 4, 4, 16), jnp.float32))
    monkeypatch.setattr(t, "_initial_noise", lambda seed: torch.from_numpy(z))
    assert t.grid == j.grid == (2, 2)
    return j, t


def _generate_pair(jp, tp, **gen):
    refs = {}
    if tp.n_refs:
        refs = dict(ref_latents=np.random.default_rng(6).standard_normal(
            (1, tp.n_refs, 4, 4, 16)).astype(np.float32))
    want = jp.generate("a red fox in snow", seed=5, **gen,
                       **{k: jnp.asarray(v) for k, v in refs.items()})
    got = tp.generate("a red fox in snow", seed=5, **gen,
                      **{k: torch.from_numpy(v) for k, v in refs.items()})
    return got, want


@pytest.mark.parametrize("kw", [
    dict(mode="t2i"),
    dict(mode="t2i", use_magcache=True, magcache_thresh=0.3),
    dict(mode="t2i", scheduler="dpmsolver++", use_magcache=True, magcache_thresh=0.3,
         cfg_range=(0.2, 0.7)),
    dict(mode="t2i", enable_teacache=True, teacache_thresh=0.3),
    dict(mode="edit"),
    dict(mode="edit", use_magcache=True, magcache_thresh=0.3),
    dict(mode="edit", scheduler="dpmsolver++", cfg_range=(0.0, 0.5)),
    dict(mode="edit", scheduler="dpmsolver++", use_magcache=True, magcache_thresh=0.3),
    dict(mode="edit", enable_teacache=True, teacache_thresh=0.3),
    dict(mode="edit", ref_images=2, use_magcache=True, magcache_thresh=0.3,
         image_guidance_scale=1.5)])
def test_pipeline_latents_match_jax(kw, monkeypatch):
    jp, tp = _pipeline_pair(monkeypatch, **kw)
    got, want = _generate_pair(jp, tp)
    assert got.latents.shape == (1, 4, 4, 16) and got.timings["text_s"] >= 0
    np.testing.assert_allclose(got.latents.numpy(), _np(want.latents), atol=F32_TOL,
                               rtol=F32_TOL)
    lanes = 2 if kw["mode"] == "t2i" else 3
    assert got.skips.shape == (STEPS, lanes) and got.calibration is None
    if not kw.get("enable_teacache"):
        np.testing.assert_array_equal(got.skips, tp.skip_schedule())
        assert got.skips.any() == kw.get("use_magcache", False)
    else:    # first and last steps forced on every lane
        assert not got.skips[[0, -1]].any() and got.skips.any()
    if kw["mode"] == "edit" and kw.get("use_magcache"):
        # a step where cond and ref disagree: the with-refs core's half batch
        assert (got.skips[:, 0] != got.skips[:, 2]).any() or kw.get("ref_images") == 2


@pytest.mark.parametrize("mode", ["t2i", "edit"])
def test_calibration_matches_jax(mode, monkeypatch):
    jp, tp = _pipeline_pair(monkeypatch, mode=mode, magcache_calibration=True,
                            use_magcache=True)
    got, want = _generate_pair(jp, tp)
    lanes = 2 if mode == "t2i" else 3
    assert got.skips is None and len(got.calibration["norm_ratio"]) == lanes * (STEPS - 1)
    np.testing.assert_allclose(got.latents.numpy(), _np(want.latents), atol=F32_TOL,
                               rtol=F32_TOL)
    for name, vals in got.calibration.items():
        assert np.isfinite(vals).all()
        np.testing.assert_allclose(vals, want.calibration[name], atol=2e-5)


def test_default_negative_prompt_and_zero_references(monkeypatch):
    jp, tp = _pipeline_pair(monkeypatch, mode="edit", num_inference_steps=3)
    assert tpipe.OMNIGEN2_DEFAULT_NEGATIVE == jpipe.OMNIGEN2_DEFAULT_NEGATIVE
    seen = []
    orig = tp.text_encoder

    def spy(prompts, device=None):
        seen.append(list(prompts))
        return orig(prompts, device=device)

    tp.text_encoder = spy
    np.testing.assert_allclose(tp.generate("a fox", seed=5).latents.numpy(),
                               _np(jp.generate("a fox", seed=5).latents), atol=F32_TOL,
                               rtol=F32_TOL)
    assert seen == [["a fox", jpipe.OMNIGEN2_DEFAULT_NEGATIVE, "<ref-image-only>"]]
    with pytest.raises(ValueError, match="ref_latents"):
        tp.generate("a fox", ref_latents=torch.zeros(1, 2, 4, 4, 16))


@pytest.mark.parametrize("mode", ["t2i", "edit"])
def test_skip_schedules_bit_equal_to_jax(mode):
    for steps in (50, 20, 28):
        for kw in ({}, dict(thresh=0.12, K=2, retention_ratio=0.1)):
            got = compute_skip_schedule(tpipe.make_omnigen2_cache_config(mode, steps, **kw))
            want = np.asarray(j_schedule(jpipe.make_omnigen2_cache_config(mode, steps, **kw)))
            np.testing.assert_array_equal(got, want)
            assert got.shape == (len(tpipe.BRANCHES[mode]) * steps,)
    for branch in tpipe.BRANCHES[mode]:      # each array on its own, one lane
        key = f"omnigen2-{branch}"
        for steps in (50, 20):
            np.testing.assert_array_equal(compute_skip_schedule(make_config(key, steps)),
                                          np.asarray(j_schedule(j_make_config(key, steps))))
    # the published schedule at 50 steps: 56 of 100 (t2i), 85 of 150 (edit)
    total = compute_skip_schedule(tpipe.make_omnigen2_cache_config(mode, 50)).sum()
    assert total == {"t2i": 56, "edit": 85}[mode]


def test_config_refusals():
    base = dict(tiny=True, height=32, width=32, txt_len=TXT)
    for kw, match in ((dict(enable_taylorseer=True, use_magcache=True), "mutually exclusive"),
                      (dict(enable_teacache=True, use_magcache=True), "mutually exclusive"),
                      (dict(enable_teacache=True, enable_taylorseer=True),
                       "mutually exclusive"),
                      (dict(mode="i2i"), "mode"), (dict(scheduler="unipc"), "scheduler"),
                      (dict(mode="edit", ref_images=0), "ref_images")):
        with pytest.raises(ValueError, match=match):
            tpipe.OmniGen2PipelineConfig(**base, **kw).validate()
        with pytest.raises(ValueError, match=match):
            tpipe.OmniGen2Pipeline(tpipe.OmniGen2PipelineConfig(**base, **kw), "cpu")
    for kw in (dict(ckpt_dir="x"), dict(lora_path="y.safetensors")):
        with pytest.raises(NotImplementedError, match="not ported"):
            tpipe.OmniGen2PipelineConfig(**base, **kw).validate()
    # calibration runs full compute whatever the cache switches say (as JAX)
    tpipe.OmniGen2PipelineConfig(**base, magcache_calibration=True, use_magcache=True).validate()


@pytest.mark.parametrize("switch", ["enable_teacache", "enable_taylorseer"])
def test_comparators_under_dpm_warn_and_run_euler(switch, capsys):
    model = _model(_tree())
    outs = []
    for scheduler in ("dpmsolver++", "euler"):
        cfg = tpipe.OmniGen2PipelineConfig(mode="t2i", tiny=True, height=32, width=32,
                                           num_inference_steps=4, txt_len=TXT, dtype="float32",
                                           scheduler=scheduler, **{switch: True})
        outs.append(tpipe.OmniGen2Pipeline(cfg, "cpu", model=model).generate("a", seed=1))
        warned = "WARNING: dpmsolver++ is wired" in capsys.readouterr().out
        assert warned == (scheduler == "dpmsolver++")
    np.testing.assert_array_equal(outs[0].latents.numpy(), outs[1].latents.numpy())


# ---------------------------------------------------------------- CLI
def test_reference_encode_matches_the_jax_cli():
    pipe = tpipe.OmniGen2Pipeline(tpipe.OmniGen2PipelineConfig(
        tiny=True, height=64, width=48, txt_len=TXT, ref_images=2, dtype="float32"), "cpu")
    rng = np.random.default_rng(8)
    imgs = [rng.uniform(size=(16, 12, 3)).astype(np.float32),
            rng.uniform(size=(30, 40, 3)).astype(np.float32)]
    ns = types.SimpleNamespace(grid=pipe.grid, model_cfg=J.OmniGen2Config.tiny(), vae=None)
    want = _np(jcli._omnigen2_ref_latents(ns, imgs))
    got = pipe.encode_images(imgs)
    assert got.shape == (1, 2, 8, 6, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cli_omnigen2_tiny_runs(tmp_path, capsys, monkeypatch):
    calls = []
    orig = tpipe.OmniGen2Pipeline.generate

    def spy(self, prompt, **kw):
        calls.append((self.config, prompt, {k: getattr(v, "shape", v) for k, v in kw.items()}))
        return orig(self, prompt, **kw)

    monkeypatch.setattr(tpipe.OmniGen2Pipeline, "generate", spy)
    img = str(tmp_path / "in.npy")
    np.save(img, np.random.default_rng(3).uniform(size=(24, 40, 3)).astype(np.float32))
    runs = (("t2i", ["--use_magcache"], "skipped 56 of 100 lane-forwards (cond + uncond"),
            ("edit", ["--input_image_path", img, img, "--use_magcache", "--instruction",
                      "make it snow", "--negative_prompt", "blur"],
             "skipped 85 of 150 lane-forwards (cond, uncond, ref"),
            ("taylor", ["--image", img, "--enable_taylorseer", "--enable_teacache",
                        "--use_magcache", "--num_inference_step", "20"],
             "skipped 39 of 60 lane-forwards"))
    for name, extra, text in runs:
        out = str(tmp_path / name)
        cli.main(["--task", "omnigen2", "--tiny", "--device", "cpu", "--output_image_path",
                  out] + extra)
        lat = np.load(out + "_latents.npy")
        assert lat.shape == (1, 4, 4, 16) and np.isfinite(lat).all()
        printed = capsys.readouterr().out
        assert text in printed, printed
    (c0, p0, k0), (c1, p1, k1), (c2, _, _) = calls
    assert (c0.mode, c0.height, c0.txt_len, c0.num_inference_steps) == ("t2i", 32, 6, 50)
    assert k0 == {"seed": 0} and c0.use_magcache
    assert (c1.mode, c1.ref_images, p1) == ("edit", 2, "make it snow")
    assert k1 == {"seed": 0, "ref_latents": (1, 2, 4, 4, 16), "negative_prompt": "blur"}
    # priority: TaylorSeer over TeaCache over MagCache, with warnings
    assert c2.enable_taylorseer and not c2.enable_teacache and not c2.use_magcache
    assert "enable_teacache will be ignored" in printed and "--use_magcache is ignored" in printed
    cal = str(tmp_path / "cal")
    cli.main(["--task", "omnigen2", "--tiny", "--device", "cpu", "--magcache_calibration",
              "--sample_steps", "6", "--image", img, "--scheduler", "dpmsolver++",
              "--text_guidance_scale", "4", "--cfg_range_end", "0.5", "--save_file", cal])
    ratios = np.array(json.load(open(cal + "_mag_ratio.json")))
    assert ratios.shape == (15,) and np.isfinite(ratios).all()
    c3 = calls[-1][0]
    assert (c3.scheduler, c3.text_guidance_scale, c3.cfg_range) == ("dpmsolver++", 4.0,
                                                                    (0.0, 0.5))


def test_cli_omnigen2_checks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["--task", "omnigen2", "--tiny"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--task", "omnigen2"])
    for flag in (["--enable_taylorseer"], ["--scheduler", "euler"], ["--height", "64"],
                 ["--input_image_path", "x.npy"]):
        with pytest.raises(SystemExit, match="does not apply"):
            cli.main(["--task", "flux-dev", "--tiny", "--device", "cpu"] + flag)
    with pytest.raises(SystemExit, match="does not apply"):
        cli.main(["--task", "omnigen2", "--tiny", "--device", "cpu", "--mag_ratios_json", "r"])
    with pytest.raises(SystemExit, match="no task of its family"):
        cli.main(["--task", "omnigen2-x", "--device", "cpu"])
