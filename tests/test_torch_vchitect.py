"""The port's Vchitect-XL slice against the JAX package on the CPU: the
weight converter, ``pos_embed_sd3``, the core (prepare, plain trunk, PAB
trunk with each flag on and off, head) on a grid where every attention takes
the einsum path and on one where the spatial and cross attentions take K1's
plain version, the pipeline (MagCache, calibration, PAB) and the CLI.

Both sides get the same weights (seeded numpy values in the tree of
``init_vchitect_params``, the reference's zero-initialised ``ot``, ``oc``
and ``add_out_t`` random too, so that the temporal and cross paths show,
converted by ``vchitect_params_from_numpy``) and the same numpy inputs.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.core import pab as jpab
from magcache_tpu.core.magcache import compute_skip_schedule as j_skip_schedule
from magcache_tpu.models import vchitect as J
from magcache_tpu.pipelines import vchitect as jpipe
from magcache_tpu.utils.misc import set_seed as j_set_seed
from magcache_tpu_torch.cli import generate as cli
from magcache_tpu_torch.core import pab as tpab
from magcache_tpu_torch.models import vchitect as T
from magcache_tpu_torch.models.convert import vchitect_params_from_numpy
from magcache_tpu_torch.ops import attention as A
from magcache_tpu_torch.pipelines import vchitect as tpipe
from tests.test_torch_latte import _latents_close
from tests.test_torch_vae_osp import numpy_params

# f32 on both sides: GEMM and reduction order only, as rel L2
F32_REL_L2 = 1e-4
# bf16: JAX rounds at other places around the unfused ops (and takes 1.1 in
# bf16 where PyTorch multiplies by it in f32)
BF16_REL_L2 = 2e-2

# 3 blocks (two joint, the context-pre-only last); a position table wide
# enough for 12 x 12 patches
NARROW = dict(depth=3, pos_embed_max_size=16)
# (grid, txt_len): S+L = 11, every attention on the einsum path; S+L = 150,
# the spatial and cross attentions on K1's plain version (above 128 tokens)
GRIDS = {"einsum": ((2, 2, 3), 5), "k1_plain": ((2, 12, 12), 6)}
# every kind reuses and computes within 6 steps, in differing combinations
SMALL_PAB = dict(spatial_broadcast=True, spatial_threshold=(0, 1000), spatial_range=2,
                 temporal_broadcast=True, temporal_threshold=(0, 1000), temporal_range=3,
                 cross_broadcast=True, cross_threshold=(0, 1000), cross_range=4)


def _np(a):
    return np.array(a, np.float32)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _tree(jcfg, seed=0):
    """Seeded f32 numpy values in ``init_vchitect_params``'s tree, ``ot``,
    ``oc`` and ``add_out_t`` included."""
    return numpy_params(J.init_vchitect_params, jcfg, seed,
                        fan_in=lambda shape: shape[-2])


def _models(dtype="float32", seed=0):
    kw = dict(NARROW, dtype=dtype)
    jcfg, tcfg = J.VchitectConfig.tiny(**kw), T.VchitectConfig.tiny(**kw)
    tree = _tree(jcfg, seed)
    params = jax.tree.map(lambda a: jnp.asarray(a, jcfg.jdtype), tree)
    for name in ("time_in", "pooled_in", "norm_out_mod", "proj_out"):   # f32 in JAX
        params[name] = jax.tree.map(jnp.asarray, tree[name])
    model = T.VchitectModel(tcfg, "cpu")
    model.load_state_dict(vchitect_params_from_numpy(tree, tcfg, "cpu"))
    return jcfg, params, model


def _inputs(grid, txt_len, cfg, rows=2, seed=1):
    rng = np.random.default_rng(seed)
    t, h, w = grid
    x = rng.standard_normal((rows, t, 2 * h, 2 * w, 16)).astype(np.float32)
    txt = rng.standard_normal((rows, txt_len, cfg.text_dim)).astype(np.float32)
    vec = rng.standard_normal((rows, cfg.vec_dim)).astype(np.float32)
    return x, {"txt": txt, "vec": vec}, np.array([700.0, 300.0][:rows], np.float32)


def _jcond(cond):
    return {k: jnp.asarray(v) for k, v in cond.items()}


def _tcond(cond):
    return {k: torch.from_numpy(v) for k, v in cond.items()}


# ---------------------------------------------------------------- model
def test_converter_carries_every_parameter_with_jax_dtypes():
    cfg = T.VchitectConfig.tiny(**NARROW, dtype="bfloat16")
    jcfg = J.VchitectConfig.tiny(**NARROW, dtype="bfloat16")
    tree = _tree(jcfg)
    shapes = jax.eval_shape(lambda k: J.init_vchitect_params(k, jcfg), jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: a.dtype, shapes)["blocks"]["ot"]["w"] == jnp.bfloat16
    sd = T.VchitectModel(cfg, "cpu").state_dict()
    conv = vchitect_params_from_numpy(tree, cfg, "cpu")
    assert sd.keys() == conv.keys()
    for k, v in sd.items():
        assert v.dtype == conv[k].dtype and v.shape == conv[k].shape, k
    for k in ("patch_embed.weight", "context_in.bias", "blocks.0.mod_x.weight",
              "blocks.1.add_out_t.weight", "last.mod_c2.bias", "last.ff2.weight"):
        assert sd[k].dtype == torch.bfloat16, k
    for k in ("time_in.in.weight", "pooled_in.out.bias", "norm_out_mod.weight",
              "proj_out.bias"):
        assert sd[k].dtype == torch.float32, k
    torch.testing.assert_close(conv["blocks.1.ffc1.weight"],
                               torch.from_numpy(tree["blocks"]["ffc1"]["w"][1].T).bfloat16(),
                               rtol=0, atol=0)
    # the random init keeps the reference's zero projections
    m = T.VchitectModel(cfg, "cpu").init(torch.Generator().manual_seed(0))
    for blk in (*m.blocks, m.last):
        assert not blk.ot.weight.any() and not blk.oc.weight.any()
    assert not m.blocks[0].add_out_t.weight.any() and m.blocks[0].add_out.weight.any()


def test_vchitect_xl_is_the_jax_geometry():
    cfg, j = T.VCHITECT_XL, J.VchitectConfig()
    for f in dataclasses.fields(j):
        assert getattr(cfg, f.name) == getattr(j, f.name), f.name
    assert cfg.head_dim == 64
    n = sum(p.numel() for p in T.VchitectModel(cfg, "meta").parameters())
    assert 2.40e9 < n < 2.45e9
    for args in ((1536, 30, 48, 96, 64), (64, 3, 5, 8, 8), (64, 12, 12, 16, 8)):
        np.testing.assert_array_equal(T.pos_embed_sd3(*args), J.pos_embed_sd3(*args))
    with pytest.raises(ValueError, match="position table"):
        T.pos_embed_sd3(64, 9, 4, 8, 8)


@pytest.mark.parametrize("dtype,grid_name", [("float32", "einsum"), ("float32", "k1_plain"),
                                             ("bfloat16", "einsum")])
def test_core_matches_jax(dtype, grid_name, monkeypatch):
    grid, txt_len = GRIDS[grid_name]
    jcfg, params, model = _models(dtype)
    k1_calls = []
    real = A.flash_attention_bshd_plain
    monkeypatch.setattr(A, "flash_attention_bshd_plain",
                        lambda *a, **kw: k1_calls.append(a[0].shape) or real(*a, **kw))
    jcore = J.make_vchitect_core(jcfg, grid, txt_len)
    tcore = T.make_vchitect_core(model, grid, txt_len)
    x, cond, t = _inputs(grid, txt_len, jcfg)
    hj, cj = jax.jit(jcore.prepare)(params, jnp.asarray(x), jnp.asarray(t), _jcond(cond))
    trj = jax.jit(jcore.trunk)(params, hj, cj)
    oj = jax.jit(jcore.head)(params, trj, cj)
    ht, ct = tcore.prepare(torch.from_numpy(x), torch.from_numpy(t), _tcond(cond))
    assert ht.dtype == model.cfg.torch_dtype and ct["vec"].dtype == torch.float32
    assert ct["txt"].shape == (2, grid[0], txt_len, 64)
    feed = {k: torch.from_numpy(_np(v)).to(ct[k].dtype) for k, v in cj.items()}
    trt = tcore.trunk(torch.from_numpy(_np(hj)).to(ht.dtype), feed).float().numpy()
    head = tcore.head(torch.from_numpy(_np(trj)).to(ht.dtype), feed).numpy()
    ot = tcore.head(tcore.trunk(ht, ct), ct).numpy()
    assert ot.shape == x.shape and np.isfinite(ot).all()
    # the spatial and cross attentions of the 3 blocks reach K1 (its plain
    # version on the CPU) above 128 tokens, 2 trunk runs here; the temporal
    # one over 2 frames never does
    t_len, s_len = grid[0], grid[1] * grid[2]
    want_calls = 2 * 3 * [(2 * t_len, s_len + txt_len, 4, 16),
                          (2, t_len * (s_len + txt_len), 4, 16)]
    assert sorted(k1_calls) == (sorted(want_calls) if grid_name == "k1_plain" else [])
    tol = F32_REL_L2 if dtype == "float32" else BF16_REL_L2
    for what, got, want in (("prepare", _np(ht.float()), _np(hj)),
                            ("context", _np(ct["txt"].float()), _np(cj["txt"])),
                            ("vec", _np(ct["vec"]), _np(cj["vec"])),
                            ("trunk", trt, _np(trj)), ("head", head, _np(oj)),
                            ("forward", ot, _np(oj))):
        assert _rel(got, want) < tol, what
    # the temporal and cross paths carry weight: zeroing ot changes the trunk
    with torch.no_grad():
        for blk in (*model.blocks, model.last):
            blk.ot.weight.zero_()
    assert _rel(tcore.trunk(torch.from_numpy(_np(hj)).to(ht.dtype), feed).float().numpy(),
                trt) > 10 * tol


@pytest.mark.parametrize("grid_name", ["einsum", "k1_plain"])
def test_pab_trunk_matches_jax_step_by_step(grid_name):
    """Six steps of the PAB trunk with every reuse combination the masks
    make, each step on its own hidden input, against JAX's ``trunk_pab``."""
    grid, txt_len = GRIDS[grid_name]
    jcfg, params, model = _models(seed=3)
    ts = np.linspace(900.0, 100.0, 6).astype(np.float32)
    tp, jp = tpab.PABConfig(**SMALL_PAB), jpab.PABConfig(**SMALL_PAB)
    masks = tpab.broadcast_masks(tp, ts)
    for key in ("spatial", "temporal", "cross"):
        np.testing.assert_array_equal(masks[key], jpab.broadcast_masks(jp, ts)[key])
        assert masks[key].any() and not masks[key].all()
    assert len({tuple(masks[k][i] for k in ("spatial", "temporal", "cross"))
                for i in range(6)}) >= 4
    jcore = J.make_vchitect_core(jcfg, grid, txt_len, pab=jp, timesteps=ts)
    tcore = T.make_vchitect_core(model, grid, txt_len, pab=tp, timesteps=ts)
    x, cond, t = _inputs(grid, txt_len, jcfg, seed=5)
    hj, cj = jax.jit(jcore.prepare)(params, jnp.asarray(x), jnp.asarray(t), _jcond(cond))
    ht, ct = tcore.prepare(torch.from_numpy(x), torch.from_numpy(t), _tcond(cond))
    jstate = jcore.init_state(params, hj, cj)
    tstate = tcore.init_state(ht, ct)
    s_len = grid[1] * grid[2]
    assert sorted(tstate) == ["cross", "spatial", "temporal"]
    assert tstate["spatial"].shape == (3, 2, grid[0], s_len + txt_len, 64)
    jtrunk = jax.jit(J.make_vchitect_core(jcfg, grid, txt_len).trunk)
    jtrunk_pab = jax.jit(jcore.trunk)
    rng = np.random.default_rng(7)
    for i in range(6):
        h = (_np(hj) + 0.3 * rng.standard_normal(hj.shape)).astype(np.float32)
        want, jstate = jtrunk_pab(params, jnp.asarray(h), cj, jstate, i)
        got, tstate = tcore.trunk(torch.from_numpy(h), ct, tstate, i)
        assert _rel(got.numpy(), _np(want)) < F32_REL_L2, i
        reused = [k for k in ("spatial", "temporal", "cross") if masks[k][i]]
        if not reused:      # a full-compute step equals the plain trunk
            assert _rel(got.numpy(), _np(jtrunk(params, jnp.asarray(h), cj))) < F32_REL_L2
    # full compute (step -1) is the plain trunk
    plain = T.make_vchitect_core(model, grid, txt_len)
    np.testing.assert_allclose(tcore.trunk(ht, ct, tstate, -1)[0].numpy(),
                               plain.trunk(ht, ct).numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="timesteps"):
        T.make_vchitect_core(model, grid, txt_len, pab=tp)


# ---------------------------------------------------------------- pipeline
BASE = dict(tiny=True, num_frames=4, height=32, width=32, txt_len=6, num_inference_steps=6,
            dtype="float32")
RATIOS = tuple(np.linspace(1.0, 0.9, 10))


@pytest.mark.parametrize("kw", [dict(use_magcache=True, magcache_ratios=RATIOS),
                                dict(magcache_calibration=True), dict(enable_pab=True)])
def test_pipeline_matches_jax(kw, monkeypatch):
    tcfg = tpipe.VchitectPipelineConfig(**BASE, **kw)
    tree = _tree(J.VchitectConfig.tiny(), seed=11)
    jp = jpipe.VchitectPipeline(jpipe.VchitectPipelineConfig(**BASE, **kw),
                                params=jax.tree.map(jnp.asarray, tree))
    model = T.VchitectModel(tcfg.model_config(), "cpu")
    model.load_state_dict(vchitect_params_from_numpy(tree, tcfg.model_config(), "cpu"))
    tp = tpipe.VchitectPipeline(tcfg, "cpu", model=model)
    assert tp.latent_shape == jp.latent_shape == (4, 4, 4, 16) and tp.grid == jp.grid
    z = _np(jax.random.normal(j_set_seed(5), (1,) + jp.latent_shape, jnp.float32))
    monkeypatch.setattr(tp, "_initial_noise", lambda gen: torch.from_numpy(z))
    want = jp.generate("a red boat at dawn", seed=5)
    got = tp.generate("a red boat at dawn", seed=5)
    _latents_close(got.latents.numpy(), _np(want.latents))
    if "magcache_calibration" in kw:
        assert got.skips is None
        for name, vals in got.calibration.items():
            assert len(vals) == 10
            np.testing.assert_allclose(vals, want.calibration[name], atol=2e-5)
        return
    want_skips = (j_skip_schedule(jp._cache_cfg()).reshape(6, 2) if kw.get("use_magcache")
                  else np.zeros((6, 1), bool))
    np.testing.assert_array_equal(got.skips, want_skips)
    np.testing.assert_array_equal(got.skips, tp.skip_mask_for())
    assert got.skips.any() == bool(kw.get("use_magcache"))
    if kw.get("enable_pab"):
        jmasks = jpab.broadcast_masks(jpab.PABConfig(
            spatial_broadcast=True, spatial_threshold=(100, 800), spatial_range=2,
            temporal_broadcast=True, temporal_threshold=(100, 800), temporal_range=4),
            tp.schedule.timesteps)
        tmasks = tpab.broadcast_masks(tcfg.pab(), tp.schedule.timesteps)
        for key in jmasks:
            np.testing.assert_array_equal(tmasks[key], jmasks[key])
        assert tmasks["spatial"].any() and tmasks["temporal"].any()
        assert not tmasks["cross"].any()


# ---------------------------------------------------------------- CLI
def test_cli_vchitect_tiny(tmp_path, capsys):
    cal = str(tmp_path / "cal")
    cli.main(["--task", "vchitect", "--tiny", "--device", "cpu", "--dtype", "float32",
              "--magcache_calibration", "--sample_steps", "8", "--save_file", cal])
    ratios = json.load(open(cal + "_mag_ratio.json"))
    assert len(ratios) == 14 and all(np.isfinite(ratios))
    for flags, mode in ((["--use_magcache", "--mag_ratios_json", cal + "_mag_ratio.json"],
                         "magcache"), (["--enable_pab"], "full+pab")):
        out = str(tmp_path / mode)
        cli.main(["--task", "vchitect", "--tiny", "--device", "cpu", "--sample_steps", "8",
                  "--save_file", out] + flags)
        lat = np.load(out + "_latents.npy")
        assert lat.shape == (1, 4, 4, 4, 16) and np.isfinite(lat).all()
        text = capsys.readouterr().out
        assert f"mode={mode}" in text and "lane-forwards (cond + uncond per step)" in text
