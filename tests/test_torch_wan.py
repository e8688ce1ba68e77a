"""The port's Wan model and sampler against the JAX package, in f32.

Both sides get the same weights (``init_wan_params`` converted by
``wan_params_from_numpy``) and the same numpy inputs. The JAX side runs on
the CPU with its XLA attention; the port's attention takes its einsum path up
to 128 tokens and K1's plain version above, so both grids are covered.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.models import wan as jwan
from magcache_tpu_torch.models import wan as twan
from magcache_tpu_torch.models.convert import wan_params_from_numpy
from magcache_tpu_torch.models.text import MockTextEncoder as TMock
from magcache_tpu_torch.parallel.mesh import run_local_ranks

# f32 on both sides; only GEMM/reduction summation order differs (the
# tolerance tests/test_parity_torch.py uses for the same block)
TOL = 2e-4


def _models(cfg_kw, grid, seed=0):
    jcfg = jwan.WanConfig.tiny(**cfg_kw)
    params = jwan.init_wan_params(jax.random.PRNGKey(seed), jcfg)
    tcfg = twan.WanConfig.tiny(**cfg_kw)
    model = twan.WanModel(tcfg, "cpu")
    model.load_state_dict(wan_params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu"))
    return (jwan.make_wan_core(jcfg, grid), params), twan.make_wan_core(model, grid)


def _inputs(cfg, grid, batch, seed=1):
    rng = np.random.default_rng(seed)
    f, h, w = grid
    x = rng.standard_normal((batch, f, 2 * h, 2 * w, cfg.in_channels)).astype(np.float32)
    ctx = rng.standard_normal((batch, cfg.text_len, cfg.text_dim)).astype(np.float32)
    return x, ctx


@pytest.mark.parametrize("grid", [(2, 4, 4), (3, 8, 8)])
def test_forward_matches_jax(grid):
    (jcore, params), tcore = _models({}, grid)
    cfg = twan.WanConfig.tiny()
    x, ctx = _inputs(cfg, grid, 2)
    t = np.array([900.0, 250.0], np.float32)
    prepare, trunk, head = (jax.jit(f) for f in (jcore.prepare, jcore.trunk,
                                                  jcore.head))
    hj, cj = prepare(params, jnp.asarray(x), jnp.asarray(t),
                     {"context": jnp.asarray(ctx)})
    ht, ct = tcore.prepare(torch.from_numpy(x), torch.from_numpy(t),
                           {"context": torch.from_numpy(ctx)})
    for key in ("e", "e0", "context"):
        np.testing.assert_allclose(ct[key].numpy(), np.asarray(cj[key]),
                                   atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=TOL, rtol=TOL)
    oj = head(params, trunk(params, hj, cj), cj)
    # feed JAX's embeddings to the port's trunk: isolates the blocks
    feed = {k: torch.from_numpy(np.array(v)) for k, v in cj.items()}
    trunk_t = tcore.trunk(torch.from_numpy(np.array(hj)), feed)
    np.testing.assert_allclose(trunk_t.numpy(), np.asarray(trunk(params, hj, cj)),
                               atol=TOL, rtol=TOL)
    ot = tcore.head(tcore.trunk(ht, ct), ct)
    assert ot.shape == x.shape
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=TOL, rtol=TOL)


def test_block_matches_jax_block():
    cfg_kw = dict(layers=1)
    grid = (2, 4, 4)
    (jcore, params), _ = _models(cfg_kw, grid, seed=3)
    x, ctx = _inputs(twan.WanConfig.tiny(**cfg_kw), grid, 1, seed=4)
    hj, cj = jax.jit(jcore.prepare)(params, jnp.asarray(x), jnp.full((1,), 500.0),
                                    {"context": jnp.asarray(ctx)})
    jcfg = jwan.WanConfig.tiny(**cfg_kw)
    cos, sin = jwan.wan_rope_tables(jcfg, grid)
    bp = jax.tree.map(lambda a: a[0], params["blocks"])
    block = jax.jit(lambda p, carry: jwan._wan_block(
        jcfg, (jnp.asarray(cos), jnp.asarray(sin)), None, grid[1] * grid[2], p, carry))
    want, _, _ = block(bp, (hj, cj["e0"], cj["context"]))
    tcfg = twan.WanConfig.tiny(**cfg_kw)
    blk = twan.WanBlock(tcfg, "cpu")
    sd = wan_params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    blk.load_state_dict({k[len("blocks.0."):]: v for k, v in sd.items()
                         if k.startswith("blocks.0.")})
    with torch.no_grad():
        got = blk(torch.from_numpy(np.array(hj)), torch.from_numpy(np.array(cj["e0"])),
                  torch.from_numpy(np.array(cj["context"])),
                  torch.from_numpy(cos), torch.from_numpy(sin))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_patchify_roundtrip_and_rope_tables():
    cfg = twan.WanConfig.tiny()
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 3, 8, 6, 16)).astype(np.float32)
    pj = np.asarray(jwan.patchify(jwan.WanConfig.tiny(), jnp.asarray(lat)))
    pt = twan.patchify(cfg, torch.from_numpy(lat)).numpy()
    np.testing.assert_array_equal(pt, pj)
    up = rng.standard_normal((2, 3 * 4 * 3, cfg.patch_out)).astype(np.float32)
    np.testing.assert_array_equal(
        twan.unpatchify(cfg, torch.from_numpy(up), (3, 4, 3)).numpy(),
        np.asarray(jwan.unpatchify(jwan.WanConfig.tiny(), jnp.asarray(up), (3, 4, 3))))
    for a, b in zip(twan.wan_rope_tables(twan.WAN_1_3B, (2, 3, 4)),
                    jwan.wan_rope_tables(jwan.WAN_1_3B, (2, 3, 4))):
        np.testing.assert_array_equal(a, b)


def test_bf16_dtype_placement_matches_jax_init():
    # bf16 config: patch embedding and block linears bf16, the rest f32
    jp = jwan.init_wan_params(jax.random.PRNGKey(0),
                              jwan.WanConfig.tiny(dtype="bfloat16"))
    tcfg = twan.WanConfig.tiny(dtype="bfloat16")
    sd = twan.WanModel(tcfg, "cpu").state_dict()
    conv = wan_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    assert sd.keys() == conv.keys()
    for k, v in sd.items():
        assert v.dtype == conv[k].dtype and v.shape == conv[k].shape, k
    assert sd["blocks.0.q.weight"].dtype == torch.bfloat16
    assert sd["patch_embedding.weight"].dtype == torch.bfloat16
    for k in ("head.out.weight", "time_projection.weight", "blocks.1.modulation",
              "text_embedding.in.weight", "blocks.0.norm3_b"):
        assert sd[k].dtype == torch.float32, k


def test_unported_wan_variants_raise():
    with pytest.raises(NotImplementedError):
        twan.WanModel(twan.WanConfig.tiny(model_type="ti2v"), "cpu")
    # VACE runs under sequence parallelism too (tests/test_torch_sp_wan_tasks.py)
    vace = twan.WanModel(twan.WanConfig.tiny(vace_layers=(0,)), "cpu")
    cores = run_local_ranks(2, lambda plan: twan.make_wan_core(vace, (2, 4, 4), plan),
                            device="cpu")
    assert len(cores) == 2
    assert TMock(4, 8)(["x"]).shape == (1, 4, 8)
