"""STDiT3's routes against the JAX package on the CPU: the unpacked
composition ("grouped" and "vpu": K3, ``tiny_temporal_attention``,
``attention()``, K7 through their plain versions) and ``qk_norm=False`` on
all three routes, each held against the JAX core's unpacked composition
(its default off the TPU), with plain inputs, masked frames (``x_mask``) and
frames above 2,048 tokens; the pipeline and the CLI with ``route``.

Both sides get the same weights (``init_stdit3_params`` converted by
``stdit3_params_from_numpy``) and the same numpy inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.models import stdit3 as J
from magcache_tpu.pipelines import open_sora as jpipe
from magcache_tpu.utils.misc import set_seed as j_set_seed
from magcache_tpu_torch.cli import generate as cli
from magcache_tpu_torch.core.magcache import compute_skip_schedule
from magcache_tpu_torch.models import stdit3 as T
from magcache_tpu_torch.models.convert import stdit3_params_from_numpy
from magcache_tpu_torch.pipelines import open_sora as tpipe

# f32 on both sides: GEMM and reduction order only (measured <= 4e-6 at
# |out| < 6)
F32_TOL = 1e-4
# bf16: the two sides round at other places (JAX's unpacked rms_norm and
# attention in bf16 against the plain kernels' f32 islands)
BF16_REL_L2 = 2e-2

# head dim 72 as published
NARROW = dict(hidden=144, heads=2, depth=2, caption_dim=24, freq_dim=32,
              caption_max_len=5)
CAP = 5
SMALL, LARGE = (3, 3, 5), (2, 46, 46)      # LARGE: frames of 2,116 tokens
UNPACKED = ("grouped", "vpu")


def _np(a):
    return np.array(a, np.float32)


def _forward_pair(route, grid, *, qk_norm=True, masked=False, dtype="float32",
                  depth=2, seed=0):
    """The JAX core (unpacked) and the port's core on ``route`` over the
    same weights and inputs; returns both heads' outputs as numpy."""
    cfg_kw = dict(NARROW, depth=depth, qk_norm=qk_norm, dtype=dtype)
    jcfg, tcfg = J.STDiT3Config(**cfg_kw), T.STDiT3Config(**cfg_kw)
    params = J.init_stdit3_params(jax.random.PRNGKey(seed), jcfg)
    model = T.STDiT3Model(tcfg, "cpu")
    model.load_state_dict(stdit3_params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu"))
    jcore = J.make_stdit3_core(jcfg, grid, CAP)
    tcore = T.make_stdit3_core(model, grid, route=route)
    rng = np.random.default_rng(seed + 1)
    t_len, h, w = grid
    x = rng.standard_normal((2, t_len, 2 * h, 2 * w, 4)).astype(np.float32)
    y = rng.standard_normal((2, CAP, NARROW["caption_dim"])).astype(np.float32)
    t = np.array([700.0, 700.0], np.float32)
    jc, tc = {"y": jnp.asarray(y)}, {"y": torch.from_numpy(y)}
    if masked:
        x_mask = np.ones((2, t_len), bool)
        x_mask[0, 0] = x_mask[1, -1] = False
        jc["x_mask"], tc["x_mask"] = jnp.asarray(x_mask), torch.from_numpy(x_mask)
    hj, cj = jax.jit(jcore.prepare)(params, jnp.asarray(x), jnp.asarray(t), jc)
    oj = jax.jit(lambda p, h_, c: jcore.head(p, jcore.trunk(p, h_, c), c))(params, hj, cj)
    ht, ct = tcore.prepare(torch.from_numpy(x), torch.from_numpy(t), tc)
    ot = tcore.head(tcore.trunk(ht, ct), ct)
    return ot.float().numpy(), _np(oj)


def _check(got, want, dtype="float32"):
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < BF16_REL_L2


@pytest.mark.parametrize("case", ["plain", "x_mask", "large_frames"])
@pytest.mark.parametrize("route", UNPACKED)
def test_unpacked_routes_match_jax_unpacked(route, case):
    grid = LARGE if case == "large_frames" else SMALL
    got, want = _forward_pair(route, grid, masked=case == "x_mask",
                              depth=1 if case == "large_frames" else 2)
    _check(got, want)


@pytest.mark.parametrize("route", UNPACKED)
def test_unpacked_routes_bf16_track_jax(route):
    got, want = _forward_pair(route, SMALL, dtype="bfloat16")
    _check(got, want, "bfloat16")


@pytest.mark.parametrize("case", ["plain", "x_mask", "large_frames"])
@pytest.mark.parametrize("route", T.ROUTES)
def test_without_qk_norm_every_route_matches_jax_unpacked(route, case):
    # the row max everywhere: packed K5r ("tma" spatial, "stream" temporal
    # with RoPE and no norm) and K1 above 2,048 tokens; unpacked K1 running
    # max and the tiny attention without gains
    grid = LARGE if case == "large_frames" else SMALL
    got, want = _forward_pair(route, grid, qk_norm=False, masked=case == "x_mask",
                              depth=1 if case == "large_frames" else 2)
    _check(got, want)


def test_without_qk_norm_blocks_carry_no_gains():
    cfg = T.STDiT3Config(**NARROW, qk_norm=False)
    model = T.STDiT3Model(cfg, "cpu")
    assert not any("norm" in k for k in model.state_dict())
    assert model.spatial[0]._attn_kw() == dict(scale=1.0 / np.sqrt(72), true_d=72)
    with pytest.raises(ValueError, match="route"):
        T.make_stdit3_core(model, SMALL, route="tiled")


@pytest.mark.parametrize("route", UNPACKED)
def test_pipeline_route_latents_match_jax(route):
    base = dict(tiny=True, num_frames=8, height=32, width=32, num_sampling_steps=6,
                caption_len=6, dtype="float32", use_magcache=True)
    j = jpipe.OpenSoraPipeline(jpipe.OpenSoraPipelineConfig(**base))
    tcfg = tpipe.OpenSoraPipelineConfig(**base, route=route)
    model = T.STDiT3Model(tcfg.model_config(), "cpu")
    model.load_state_dict(stdit3_params_from_numpy(
        jax.tree.map(np.asarray, j.params), tcfg.model_config(), "cpu"))
    tp = tpipe.OpenSoraPipeline(tcfg, "cpu", model=model)
    _, zkey, _ = jax.random.split(j_set_seed(5), 3)
    z = _np(jax.random.normal(zkey, (1,) + j.latent_shape, jnp.float32))
    tp._initial_noise = lambda seed: torch.from_numpy(z)
    want = j.generate("a red boat at dawn", seed=5)
    got = tp.generate("a red boat at dawn", seed=5)
    np.testing.assert_allclose(got.latents.numpy(), _np(want.latents), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got.skips,
                                  compute_skip_schedule(tp._cache_cfg()).reshape(6, 1))


@pytest.mark.parametrize("route", UNPACKED)
def test_cli_open_sora_tiny_routes(route, tmp_path, capsys):
    ref = str(tmp_path / "ref.npy")
    np.save(ref, np.random.default_rng(0).standard_normal((1, 4, 4, 4)).astype("f4"))
    for extra in ([], ["--ms", "0,0,0,0,1,0", "--refs", ref, "--loop", "2",
                       "--condition_frame_length", "1", "--align", "1"]):
        out = str(tmp_path / f"gen{len(extra)}")
        cli.main(["--task", "open-sora", "--tiny", "--device", "cpu", "--use_magcache",
                  "--route", route, "--save_file", out] + extra)
        lat = np.load(out + "_latents.npy")
        assert np.isfinite(lat).all() and lat.shape[-1] == 4
    assert "skipped" in capsys.readouterr().out
