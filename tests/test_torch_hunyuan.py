"""The port's HunyuanVideo / FramePack DiT against the JAX package on the CPU:
the weight converter, the 3-D and FramePack rope tables (exactly), the
patchify round trips, the token refiner, the FLUX core's new surface
(``rope_tables``, ``img_pre_tokens``, ``first_block_modulated``), one core
forward in the flat-history and pyramid modes, a MagCache run, the
reference's timestep fault (shown, not inherited) and the published sizes.

Both sides get the same weights (``init_hunyuan_params`` converted by
``hunyuan_params_from_numpy``) and the same numpy inputs. The JAX core
embeds ``t`` unscaled in the refiner but ``t * 1000`` in the FLUX core; the
port embeds the sampler's ``t`` (``sigma * 1000``) in both. To compare like
with like the JAX side gets ``t / 1000`` and a refiner patched to undo that
scaling (``_fixed_jax``): the JAX refiner at ``t``, the JAX MMDiT at ``t``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.core import sampler as jsampler
from magcache_tpu.core.presets import make_config as j_make_config
from magcache_tpu.models import flux as JF
from magcache_tpu.models import hunyuan as J
from magcache_tpu_torch.core.magcache import compute_skip_schedule
from magcache_tpu_torch.core.presets import make_config
from magcache_tpu_torch.core.sampler import sample_euler
from magcache_tpu_torch.models import hunyuan as T
from magcache_tpu_torch.models.convert import hunyuan_params_from_numpy
from magcache_tpu_torch.models.flux import first_block_modulated
from magcache_tpu_torch.schedulers.flow_match import FlowMatchSchedule

# f32 on both sides: GEMM and reduction order, and t / 1000 * 1000 one f32
# ulp off t in the refiner's timestep features
F32_TOL = 1e-4
# bf16 MMDiT: JAX rounds the linears' bias adds and the gelu at other points
BF16_REL_L2 = 5e-2
TXT = 8
GRID = (3, 4, 4)                 # flat: 3 latent frames of 4 x 4 tokens
FP_GRID = (2, 4, 4)              # pyramid: a 64 x 64 canvas


def _np(a):
    return np.array(a, np.float32)


def _rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _models(dtype="float32", framepack=False, seed=0):
    jcfg = J.HunyuanConfig.tiny(dtype=dtype, framepack=framepack)
    tcfg = T.HunyuanConfig.tiny(dtype=dtype, framepack=framepack)
    params = J.init_hunyuan_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, params)
    # the JAX init zeroes biases and sets unit gains: give them values
    rng = np.random.default_rng(seed + 50)
    for blk in ("double", "single"):
        for name, leaf in tree[blk].items():
            if isinstance(leaf, dict):
                leaf["b"] = (rng.standard_normal(leaf["b"].shape) * 0.05).astype(leaf["b"].dtype)
    for name in ("norm1_w", "norm2_w", "norm1_b", "norm2_b"):
        base = 1.0 if name.endswith("_w") else 0.0
        leaf = tree["refiner"]["blocks"][name]
        tree["refiner"]["blocks"][name] = base + 0.1 * rng.standard_normal(leaf.shape).astype(np.float32)
    params = jax.tree.map(jnp.asarray, tree)
    model = T.HunyuanModel(tcfg, "cpu")
    model.load_state_dict(hunyuan_params_from_numpy(tree, tcfg, "cpu"))
    return jcfg, params, model


def _fixed_jax(monkeypatch):
    """The JAX refiner embeds 1000 x its t: fed t / 1000 with the FLUX core,
    the composition sees the sampler's t everywhere."""
    orig = J._refine_text
    monkeypatch.setattr(J, "_refine_text",
                        lambda cfg, params, txt, t: orig(cfg, params, txt, t * 1000.0))


def _cond(cfg, rows=1, seed=1, history=0, pyramid=False, grid=GRID):
    rng = np.random.default_rng(seed)
    _, gh, gw = grid
    hw = (2 * gh, 2 * gw, cfg.in_channels)
    c = {"txt": rng.standard_normal((rows, TXT, cfg.text_dim)),
         "vec": rng.standard_normal((rows, cfg.vec_dim)),
         "guidance": np.full((rows,), 6.0)}
    if history:
        c["history"] = rng.standard_normal((rows, history) + hw)
    if pyramid:
        c.update(clean=rng.standard_normal((rows, 2) + hw),
                 clean_2x=rng.standard_normal((rows, 2) + hw),
                 clean_4x=rng.standard_normal((rows, 16) + hw))
    return {k: v.astype(np.float32) for k, v in c.items()}


def _x(cfg, grid, rows=1, seed=2):
    gt, gh, gw = grid
    return np.random.default_rng(seed).standard_normal(
        (rows, gt, 2 * gh, 2 * gw, cfg.in_channels)).astype(np.float32)


# ---------------------------------------------------------------- model
@pytest.mark.parametrize("framepack", [False, True])
def test_converter_carries_every_parameter_with_jax_dtypes(framepack):
    jcfg, params, _ = _models("bfloat16", framepack)
    tcfg = T.HunyuanConfig.tiny(dtype="bfloat16", framepack=framepack)
    sd = T.HunyuanModel(tcfg, "cpu").state_dict()
    tree = jax.tree.map(np.asarray, params)
    conv = hunyuan_params_from_numpy(tree, tcfg, "cpu")
    assert sd.keys() == conv.keys()
    for k, v in sd.items():
        assert v.dtype == conv[k].dtype and v.shape == conv[k].shape, k
    assert sd["mmdit.single_blocks.1.lin1.weight"].dtype == torch.bfloat16
    for k in ("refiner.proj_in.weight", "refiner.blocks.0.qkv.weight",
              "refiner.t_embed.in.weight", "refiner.blocks.0.norm2_b"):
        assert sd[k].dtype == torch.float32, k
    np.testing.assert_array_equal(conv["refiner.blocks.0.mlp2.weight"].numpy(),
                                  tree["refiner"]["blocks"]["mlp2"]["w"][0].T)
    if framepack:
        np.testing.assert_array_equal(conv["clean_proj_4x.weight"].numpy(),
                                      tree["clean_proj_4x"]["w"].T)
        assert sd["clean_proj_4x.weight"].shape == (96, 8 * 4 * 8 * 8)
    with pytest.raises(ValueError, match="clean-latent"):
        hunyuan_params_from_numpy(tree, dataclasses.replace(tcfg, framepack=not framepack))


@pytest.mark.parametrize("grid,history", [((3, 4, 4), 0), ((2, 3, 5), 2), ((1, 8, 8), 0)])
def test_hunyuan_rope_tables_equal_jax(grid, history):
    jcfg, tcfg = J.HunyuanConfig.tiny(), T.HunyuanConfig.tiny()
    full = (grid[0] + history,) + grid[1:]
    for got, want in zip(T.hunyuan_rope_tables(tcfg, TXT, full),
                         J.hunyuan_rope_tables(jcfg, TXT, full)):
        np.testing.assert_array_equal(got, want)
    pub = T.hunyuan_rope_tables(T.HUNYUAN_VIDEO, 4, (2, 3, 3))
    want = J.hunyuan_rope_tables(J.HunyuanConfig(), 4, (2, 3, 3))
    np.testing.assert_array_equal(pub[0], want[0])
    assert pub[0].shape == (4 + 18, 64)


@pytest.mark.parametrize("order", ["padded", "f1"])
@pytest.mark.parametrize("pad", [0, 1, 2, 3])
def test_framepack_rope_tables_equal_jax(order, pad):
    for jcfg, tcfg, grid in ((J.HunyuanConfig.tiny(), T.HunyuanConfig.tiny(), FP_GRID),
                             (J.HunyuanConfig(), T.HUNYUAN_VIDEO, (9, 32, 48))):
        got = T.framepack_rope_tables(tcfg, TXT, grid, pad, order=order)
        want = J.framepack_rope_tables(jcfg, TXT, grid, pad, order=order)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    gt, gh, gw = grid
    # clean 2 frames, 2x one frame at half, 4x four frames at a quarter
    assert got[0].shape[0] == TXT + (2 + gt) * gh * gw + gh * gw // 4 + 4 * gh * gw // 16
    with pytest.raises(ValueError, match="order"):
        T.framepack_rope_tables(tcfg, TXT, grid, pad, order="reversed")


def test_patchify_round_trips_and_equals_jax():
    cfg = T.HunyuanConfig.tiny()
    lat = _x(cfg, GRID, rows=2)
    p = T.patchify_video(cfg, torch.from_numpy(lat))
    assert p.shape == (2, 48, cfg.in_channels * 4)
    np.testing.assert_array_equal(p.numpy(), _np(J.patchify_video(J.HunyuanConfig.tiny(),
                                                                  jnp.asarray(lat))))
    np.testing.assert_array_equal(T.unpatchify_video(cfg, p, GRID).numpy(), lat)
    big = np.random.default_rng(3).standard_normal((1, 16, 8, 8, 8)).astype(np.float32)
    for k in ((2, 4, 4), (4, 8, 8)):
        np.testing.assert_array_equal(T.patchify_k(torch.from_numpy(big), *k).numpy(),
                                      _np(J._patchify_k(jnp.asarray(big), *k)))


def test_refiner_matches_jax():
    jcfg, params, model = _models()
    rng = np.random.default_rng(4)
    txt = rng.standard_normal((2, TXT, jcfg.text_dim)).astype(np.float32)
    txt[1, 5:] = 0.0                         # an encoder's zeroed padding
    t = np.array([975.0, 312.5], np.float32)
    want = _np(J._refine_text(jcfg, params, jnp.asarray(txt), jnp.asarray(t)))
    got = T.refine_text(model, torch.from_numpy(txt), torch.from_numpy(t)).numpy()
    assert got.shape == (2, TXT, 96) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_flux_core_rope_tables_pre_tokens_and_tea_signal():
    """The FLUX core's new surface against the JAX ``make_flux_core``: given
    3-D tables, embedded tokens ahead of the image stream, and the first
    block's modulated input (TeaCache's signal)."""
    jcfg, params, model = _models()
    fcfg = jcfg.to_flux()
    grid = (2, 2, 2)
    rope = J.hunyuan_rope_tables(jcfg, TXT, (3, 2, 2))    # 4 pre tokens + 8
    jcore = JF.make_flux_core(fcfg, TXT, 2, 2, rope_tables=rope)
    from magcache_tpu_torch.models.flux import make_flux_core

    tcore = make_flux_core(model.mmdit, TXT, 2, 2, rope_tables=rope, grid_t=2)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 8, fcfg.in_channels)).astype(np.float32)
    pre = rng.standard_normal((1, 4, 96)).astype(np.float32)
    cond = {"txt": rng.standard_normal((1, TXT, 96)).astype(np.float32),
            "vec": rng.standard_normal((1, 16)).astype(np.float32),
            "guidance": np.full((1,), 6.0, np.float32)}
    t = np.array([700.0], np.float32)
    jc = dict({k: jnp.asarray(v) for k, v in cond.items()}, img_pre_tokens=[jnp.asarray(pre)])
    hj, cj = jcore.prepare(params, jnp.asarray(x), jnp.asarray(t / 1000), jc)
    oj = jcore.head(params, jcore.trunk(params, hj, cj), cj)
    tc = dict({k: torch.from_numpy(v) for k, v in cond.items()},
              img_pre_tokens=[torch.from_numpy(pre)])
    ht, ct = tcore.prepare(torch.from_numpy(x), torch.from_numpy(t), tc)
    assert ht.shape == (1, 12, 96)
    np.testing.assert_array_equal(ht[:, :4].numpy(), _np(hj[:, :4]))
    ot = tcore.head(tcore.trunk(ht, ct), ct)
    np.testing.assert_allclose(ot.numpy(), _np(oj), atol=F32_TOL, rtol=F32_TOL)
    with torch.inference_mode():      # as the sampler calls it
        sig = first_block_modulated(model.mmdit, ht, ct)
    np.testing.assert_allclose(sig.numpy(), _np(JF.first_block_modulated(params, hj, cj)),
                               atol=F32_TOL, rtol=F32_TOL)
    assert grid[0] * grid[1] * grid[2] == 8


@pytest.mark.parametrize("mode,dtype", [("flat", "float32"), ("history", "float32"),
                                        ("padded", "float32"), ("f1", "float32"),
                                        ("flat", "bfloat16"), ("padded", "bfloat16")])
def test_core_forward_matches_jax(mode, dtype, monkeypatch):
    _fixed_jax(monkeypatch)
    pyramid = mode in ("padded", "f1")
    grid = FP_GRID if pyramid else GRID
    jcfg, params, model = _models(dtype, framepack=pyramid)
    kw = (dict(framepack_pad=2, framepack_order=mode) if pyramid
          else dict(history_frames=2 if mode == "history" else 0))
    jcore = J.make_hunyuan_core(jcfg, TXT, grid, **kw)
    tcore = T.make_hunyuan_core(model, TXT, grid, **kw)
    cond = _cond(jcfg, rows=2, history=kw.get("history_frames", 0), pyramid=pyramid, grid=grid)
    x = _x(jcfg, grid, rows=2)
    t = np.array([1000.0, 437.5], np.float32)
    jc = {k: jnp.asarray(v) for k, v in cond.items()}
    hj, cj = jcore.prepare(params, jnp.asarray(x), jnp.asarray(t / 1000), jc)
    trj = jcore.trunk(params, hj, cj)
    oj = jcore.head(params, trj, cj)
    tc = {k: torch.from_numpy(v) for k, v in cond.items()}
    ht, ct = tcore.prepare(torch.from_numpy(x), torch.from_numpy(t), tc)
    gt, gh, gw = grid
    n_img = {"flat": 48, "history": 80, "padded": 32 + 4 + 4 + 32, "f1": 72}[mode]
    assert ht.shape == (2, n_img, 96) and ht.dtype == model.cfg.torch_dtype
    trt = tcore.trunk(ht, ct)
    ot = tcore.head(trt, ct).numpy()
    assert ot.shape == x.shape
    for got, want in ((ct["txt"].float().numpy(), _np(cj["txt"])), (ht.float().numpy(), _np(hj)),
                      (trt.float().numpy(), _np(trj)), (ot, _np(oj))):
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
        else:
            assert _rel(got, want) < BF16_REL_L2


def test_timestep_fault_of_the_reference_is_not_inherited():
    """JAX's pipeline hands the core sigma * 1000: its refiner embeds that
    (the intended scale), its FLUX core 1000 x that. The port's refiner
    equals JAX's at t and its vec equals the JAX FLUX core's fed t / 1000;
    each differs from the other reading."""
    jcfg, params, model = _models()
    jcore = J.make_hunyuan_core(jcfg, TXT, GRID)
    tcore = T.make_hunyuan_core(model, TXT, GRID)
    sch = FlowMatchSchedule.create(50, shift=7.0)
    t = sch.timesteps[[0, 20]]
    cond = _cond(jcfg, rows=2)
    x = _x(jcfg, GRID, rows=2)
    jc = {k: jnp.asarray(v) for k, v in cond.items()}
    _, ct = tcore.prepare(torch.from_numpy(x), torch.from_numpy(t),
                          {k: torch.from_numpy(v) for k, v in cond.items()})
    faulty = jcore.prepare(params, jnp.asarray(x), jnp.asarray(t), jc)[1]
    vec, txt = ct["vec"].numpy(), ct["txt"].numpy()
    assert _rel(vec, _np(faulty["vec"])) > 0.1
    # the refiner at t is JAX's as it is (the txt_in of the same refined text)
    np.testing.assert_allclose(txt, _np(faulty["txt"]), atol=F32_TOL, rtol=F32_TOL)
    wrong = T.refine_text(model, torch.from_numpy(cond["txt"]), torch.from_numpy(t / 1000))
    right = T.refine_text(model, torch.from_numpy(cond["txt"]), torch.from_numpy(t))
    assert _rel(wrong.numpy(), right.numpy()) > 1e-2
    fixed = jcore.prepare(params, jnp.asarray(x), jnp.asarray(t / 1000), jc)[1]
    np.testing.assert_allclose(vec, _np(fixed["vec"]), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("mode", ["magcache", "calibrate"])
def test_sample_euler_over_the_core_matches_jax(mode, monkeypatch):
    _fixed_jax(monkeypatch)
    jcfg, params, model = _models(seed=3)
    jcore = J.make_hunyuan_core(jcfg, TXT, GRID)
    tcore = T.make_hunyuan_core(model, TXT, GRID)
    steps = 8
    sch = FlowMatchSchedule.create(steps, shift=7.0)
    dts = np.diff(sch.sigmas)
    x = _x(jcfg, GRID, seed=6)
    cond = _cond(jcfg, seed=7)
    jc = {k: jnp.asarray(v) for k, v in cond.items()}
    tc = {k: torch.from_numpy(v) for k, v in cond.items()}
    jts = sch.timesteps / 1000
    if mode == "calibrate":
        # the cross-section carry: a seeded predecessor, all steps' stats
        prev = np.random.default_rng(8).standard_normal((1, 48, 96)).astype(np.float32)
        jx, jstats, jres = jsampler.calibrate_euler(
            jcore, params, jnp.asarray(x), jc, timesteps=jts, dts=dts, lanes=1,
            prev_residual=jnp.asarray(prev), return_residual=True)
        tx, tstats, tres = sample_euler(tcore, torch.from_numpy(x), tc, timesteps=sch.timesteps,
                                        dts=dts, calibrate=True,
                                        prev_residual=torch.from_numpy(prev),
                                        return_residual=True)
        assert tstats.shape == (steps, 1, 3)
        np.testing.assert_allclose(tstats, np.asarray(jstats), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(tres.numpy(), _np(jres), atol=1e-4, rtol=1e-4)
        with pytest.raises(ValueError, match="calibrate"):
            sample_euler(tcore, torch.from_numpy(x), tc, timesteps=sch.timesteps, dts=dts,
                         return_residual=True)
    else:
        jx, jskips = jsampler.sample_euler(
            jcore, params, jnp.asarray(x), jc, timesteps=jts, dts=dts,
            cache_cfg=j_make_config("hunyuanvideo-544p", steps), return_skips=True)
        cache_cfg = make_config("hunyuanvideo-544p", steps)
        tx, tskips = sample_euler(tcore, torch.from_numpy(x), tc, timesteps=sch.timesteps,
                                  dts=dts, cache_cfg=cache_cfg, return_skips=True)
        np.testing.assert_array_equal(tskips, np.asarray(jskips))
        np.testing.assert_array_equal(tskips[:, 0], compute_skip_schedule(cache_cfg))
        assert int(tskips.sum()) == 5
    np.testing.assert_allclose(tx.numpy(), _np(jx), atol=1e-4, rtol=1e-4)


def test_random_init_and_published_sizes():
    cfg = T.HunyuanConfig.tiny(framepack=True)
    m = T.HunyuanModel(cfg, "cpu").init(torch.Generator().manual_seed(0))
    assert not m.refiner.blocks[0].qkv.bias.any()
    assert (m.refiner.blocks[0].norm1_w == 1).all() and not m.clean_proj.bias.any()
    std = float(m.clean_proj_4x.weight.detach().std())
    assert abs(std - (8 * 256) ** -0.5) < 0.1 * (8 * 256) ** -0.5
    with pytest.raises(ValueError, match="framepack"):
        T.make_hunyuan_core(T.HunyuanModel(T.HunyuanConfig.tiny(), "cpu"), TXT, FP_GRID,
                            framepack_pad=0)
    # the published width: 12.8 B parameters, the clean projections 1.8 M
    # more (counted on the meta device, nothing allocated)
    pub = T.HunyuanModel(T.HUNYUAN_VIDEO, "meta")
    n = sum(p.numel() for p in pub.parameters())
    assert 12.7e9 < n < 12.9e9
    assert pub.mmdit.cfg.head_dim == 128 and sum(pub.cfg.axes_dims) == 128
    fp = T.HunyuanModel(dataclasses.replace(T.HUNYUAN_VIDEO, framepack=True), "meta")
    assert sum(p.numel() for p in fp.parameters()) - n == 3072 * (64 + 512 + 4096 + 3)
