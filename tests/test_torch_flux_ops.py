"""The port's FLUX pieces against the JAX package on the CPU: K2 in head scope
(the plain version against the Pallas kernel in interpret mode, as
``tests/test_ops.py`` runs it), strided q/k slices, the FLUX ``mu`` schedule,
the mock pooled encoder, the rope tables, the modulation and the K3 ``mod``
sites against the JAX composition, and latent packing.

Same seeded numpy inputs on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.models import flux as J
from magcache_tpu.models.text import MockPooledEncoder as JPooled
from magcache_tpu.ops import fused_prologue as jfp
from magcache_tpu.ops import norms as jnorms
from magcache_tpu.ops import rope as jrope
from magcache_tpu.schedulers.flow_match import FlowMatchSchedule as JFlow
from magcache_tpu_torch.models import flux as T
from magcache_tpu_torch.models.text import MockPooledEncoder
from magcache_tpu_torch.ops import fused_prologue as tfp
from magcache_tpu_torch.schedulers.flow_match import FlowMatchSchedule


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch CPU tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------- K2h
# bf16: both sides round the normed value at the same point; a tie may round
# differently after a differently ordered f32 sum -> the token-scope test's
# 2e-2. f32: no rounding point, summation order only -> 1e-5.
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("heads,gain_per_head", [(2, False), (3, True),
                                                 (4, False), (4, True)])
def test_k2_head_scope_plain_matches_pallas_interpret(dtype, tol, heads,
                                                      gain_per_head):
    rng = np.random.default_rng(heads)
    b, s, d = 2, 131, 128
    xj, xt = _both(rng.standard_normal((b, s, heads * d)) * 2, dtype)
    g = (1.0 + 0.2 * rng.standard_normal(heads * d if gain_per_head else d)
         ).astype(np.float32)
    cos, sin = jrope.rope_freqs_1d(np.arange(s), d)
    want = jfp.rms_norm_rope(xj, jnp.asarray(g), jnp.asarray(cos), jnp.asarray(sin),
                             heads, eps=1e-6, norm_scope="head", interpret=True,
                             block_s=128)
    got = tfp.rms_norm_rope(xt, torch.from_numpy(g), torch.from_numpy(cos),
                            torch.from_numpy(sin), heads, eps=1e-6,
                            norm_scope="head")
    assert got.dtype == xt.dtype and got.shape == (b, s, heads, d)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0)


@pytest.mark.parametrize("extra", [0, 512])
def test_k2_head_scope_reads_strided_slices_like_contiguous_ones(extra):
    # q and k as column slices of a fused [B, S, 3*H*D (+ mlp)] projection,
    # as FLUX's double (extra 0) and single blocks (extra = the mlp width)
    # hand them over: the same result as a contiguous copy, bit for bit
    rng = np.random.default_rng(7)
    b, s, heads, d = 2, 40, 3, 128
    hd = heads * d
    _, fused = _both(rng.standard_normal((b, s, 3 * hd + extra)), "bfloat16")
    g = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32))
    cos, sin = (torch.from_numpy(a) for a in jrope.rope_freqs_1d(np.arange(s), d))
    for i in (0, 1):
        part = fused[..., i * hd:(i + 1) * hd]
        assert not part.is_contiguous()
        got = tfp.rms_norm_rope(part, g, cos, sin, heads, eps=1e-6, norm_scope="head")
        want = tfp.rms_norm_rope(part.contiguous(), g, cos, sin, heads, eps=1e-6,
                                 norm_scope="head")
        assert got.is_contiguous()
        torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_k2_wrapper_refuses_without_fallback():
    # a tensor neither on the CPU nor on a card is refused in both scopes,
    # never routed to the plain version; an unknown scope is refused
    x = torch.empty(1, 256, 256, device="meta", dtype=torch.bfloat16)
    g = torch.empty(128, device="meta")
    for scope in ("token", "head"):
        with pytest.raises(ValueError):
            tfp.rms_norm_rope(x, g, g, g, 2, norm_scope=scope)
    with pytest.raises(ValueError, match="norm_scope"):
        tfp.rms_norm_rope(torch.zeros(1, 4, 256), torch.ones(128), torch.ones(4, 64),
                          torch.zeros(4, 64), 2, norm_scope="channel")


# ---------------------------------------------------------------- schedule
@pytest.mark.parametrize("steps,seq", [(28, 4096), (28, 16), (50, 1024), (4, 8704)])
def test_flux_mu_schedule_bit_equal_to_jax(steps, seq):
    assert FlowMatchSchedule.flux_mu(seq) == JFlow.flux_mu(seq)
    kw = dict(mu=FlowMatchSchedule.flux_mu(seq), linspace_endpoint=True)
    t, j = FlowMatchSchedule.create(steps, **kw), JFlow.create(steps, **kw)
    np.testing.assert_array_equal(t.sigmas, j.sigmas)
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    assert t.timesteps.dtype == np.float32 and t.sigmas[-1] == 0.0


# ---------------------------------------------------------------- encoders
def test_mock_pooled_encoder_bit_equal_to_jax():
    prompts = ["a red fox in snow", "", "Ünïcödé"]
    got = MockPooledEncoder(16)(prompts)
    want = np.asarray(JPooled(16)(prompts))
    assert got.dtype == torch.float32 and got.shape == (3, 16)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- rope
@pytest.mark.parametrize("kontext", [False, True])
@pytest.mark.parametrize("cfg_kw", [{}, dict(axes_dims=(16, 56, 56), hidden=3072,
                                             heads=24)])
def test_flux_rope_tables_bit_equal_to_jax(kontext, cfg_kw):
    tcfg, jcfg = T.FluxConfig.tiny(**cfg_kw), J.FluxConfig.tiny(**cfg_kw)
    got = T.flux_rope_tables(tcfg, 8, 4, 6, kontext=kontext)
    want = J.flux_rope_tables(jcfg, 8, 4, 6, kontext=kontext)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (8 + 24 * (2 if kontext else 1), tcfg.head_dim // 2)
    np.testing.assert_array_equal(
        T.flux_img_rope_block(tcfg, 3, 5, 1)[1], J.flux_img_rope_block(jcfg, 3, 5, 1)[1])


# ---------------------------------------------------------------- mod / K3 sites
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mod_matches_jax(dtype):
    # the f32 vec is cast to the weight dtype before the silu; the chunks
    # come back f32. bf16: the linear's bias add rounds at another point
    # than in JAX -> one bf16 ulp of |out| < 4
    rng = np.random.default_rng(3)
    d, n = 64, 6
    w = rng.standard_normal((d, n * d)) / 8
    bias = 0.1 * rng.standard_normal(n * d)
    vec = rng.standard_normal((2, d)).astype(np.float32)
    jp = {"w": jnp.asarray(w, jnp.float32).astype(dtype),
          "b": jnp.asarray(bias, jnp.float32).astype(dtype)}
    layer = torch.nn.Linear(d, n * d, dtype=getattr(torch, dtype))
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w.T.copy()))
        layer.bias.copy_(torch.from_numpy(bias))
    got = T._mod(torch.from_numpy(vec), layer, n)
    want = J._mod(jnp.asarray(vec), jp, n)
    assert len(got) == n
    tol = 1e-5 if dtype == "float32" else 3e-2
    for g, wnt in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (2, 1, d)
        np.testing.assert_allclose(_np(g), _np(wnt), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_k3_mod_sites_match_the_jax_composition(dtype, tol):
    # FLUX's `(layer_norm(x) * (1 + scale) + shift).astype(x.dtype)` (double
    # block, single block, head) has K3 mod's rounding points: ln(x) rounded
    # to x's dtype, the f32 modulation, one rounding at the end
    rng = np.random.default_rng(4)
    b, s, d = 2, 37, 256
    xj, xt = _both(rng.standard_normal((b, s, d)) * 3, dtype)
    sc = (0.3 * rng.standard_normal((b, 1, d))).astype(np.float32)
    sh = (0.3 * rng.standard_normal((b, 1, d))).astype(np.float32)
    want = (jnorms.layer_norm(xj) * (1 + jnp.asarray(sc)) + jnp.asarray(sh)
            ).astype(xj.dtype)
    got = tfp.layer_norm_mod(xt, scale=torch.from_numpy(sc),
                             shift=torch.from_numpy(sh), eps=1e-6)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0)


# ---------------------------------------------------------------- packing
def test_pack_unpack_match_jax_and_round_trip():
    lat = np.random.default_rng(5).standard_normal((2, 8, 12, 16)).astype(np.float32)
    packed = T.pack_latents(torch.from_numpy(lat))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(J.pack_latents(jnp.asarray(lat))))
    assert packed.shape == (2, 24, 64)
    np.testing.assert_array_equal(T.unpack_latents(packed, 4, 6).numpy(), lat)
