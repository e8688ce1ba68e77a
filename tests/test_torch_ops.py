"""The port's plain kernel versions (K1, K2, K3) and ops against the JAX
package: the Pallas kernels run with ``interpret=True`` on the CPU, as
``tests/test_ops.py`` runs them. Same seeded numpy inputs on both sides.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.ops import fused_prologue as jfp
from magcache_tpu.ops import norms as jnorms
from magcache_tpu.ops import rope as jrope
from magcache_tpu_torch.ops import attention as tattn
from magcache_tpu_torch.ops import fused_prologue as tfp
from magcache_tpu_torch.ops import norms as tnorms
from magcache_tpu_torch.ops import rope as trope

# ``magcache_tpu.ops`` re-exports the function ``attention`` over its module
jattn = importlib.import_module("magcache_tpu.ops.attention")


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch CPU tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# f32: the same algorithm and rounding points on both sides, only the f32
# summation order differs -> the JAX test's own 3e-5. bf16: additionally a
# bf16 rounding of p or of the output may flip at a tie -> 1e-2.
@pytest.mark.parametrize("dtype,tol", [("float32", 3e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("fixed_max", [None, 16.0])
def test_k1_plain_matches_pallas_interpret(dtype, tol, fixed_max):
    rng = np.random.default_rng(3)
    b, s, h, d, skv = 2, 300, 3, 128, 77
    qj, qt = _both(rng.standard_normal((b, s, h, d)), dtype)
    kj, kt = _both(rng.standard_normal((b, skv, h, d)), dtype)
    vj, vt = _both(rng.standard_normal((b, skv, h, d)), dtype)
    want = jattn.flash_attention_bshd(qj, kj, vj, kv_len=50, fixed_max=fixed_max,
                                      interpret=True, block_q=128, block_k=128)
    got = tattn.flash_attention_bshd(qt, kt, vt, kv_len=50, fixed_max=fixed_max)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("chunk", [7, 64, 1024])
def test_k1_plain_chunking_is_independent(chunk):
    # query-row chunks are independent; only the BLAS blocking of the f32
    # products may change with the chunk shape -> 1e-6
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 150, 2, 32, generator=g) for _ in range(3))
    ref = tattn.flash_attention_bshd_plain(q, k, v, fixed_max=16.0, chunk=150)
    got = tattn.flash_attention_bshd_plain(q, k, v, fixed_max=16.0, chunk=chunk)
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("sq,skv", [(64, 16), (100, 128), (200, 16), (129, 300)])
def test_attention_dispatcher_matches_jax(sq, skv):
    # <= 128 tokens: the einsum path on both sides; above: K1 (port, plain on
    # the CPU) vs JAX's XLA softmax. f32, summation order only -> 3e-5.
    rng = np.random.default_rng(5)
    qj, qt = _both(rng.standard_normal((2, sq, 4, 24)), "float32")
    kj, kt = _both(rng.standard_normal((2, skv, 4, 24)), "float32")
    vj, vt = _both(rng.standard_normal((2, skv, 4, 24)), "float32")
    want = jattn.attention(qj, kj, vj, fixed_max=16.0)
    got = tattn.attention(qt, kt, vt, fixed_max=16.0)
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-5, rtol=3e-5)


def test_kernel_wrappers_raise_off_cpu_without_fallback():
    # a tensor that is neither on the CPU nor on a card is refused, never
    # routed to the plain version
    q = torch.empty(1, 256, 2, 128, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tattn.flash_attention_bshd(q, q, q)
    x = torch.empty(1, 256, 256, device="meta", dtype=torch.bfloat16)
    g = torch.empty(256, device="meta")
    with pytest.raises(ValueError):
        tfp.rms_norm_rope(x, g, g, g, 2)
    with pytest.raises(ValueError):
        tfp.layer_norm_mod(x, weight=g, bias=g)
    with pytest.raises(NotImplementedError):
        tfp.rms_norm_rope(x, g, g, g, 2, norm_scope="head")
    with pytest.raises(NotImplementedError):
        tfp.layer_norm_mod(x)


# K2/K3 in bf16: both sides round the normed value at the same point; a tie
# may round differently after a differently ordered f32 sum -> JAX's 2e-2.
@pytest.mark.parametrize("b,s,heads,d", [(2, 300, 3, 128), (1, 512, 2, 128),
                                         (2, 130, 4, 64)])
def test_k2_plain_matches_pallas_interpret(b, s, heads, d):
    rng = np.random.default_rng(2)
    hd = heads * d
    xj, xt = _both(rng.standard_normal((b, s, hd)) * 2, "bfloat16")
    g = rng.standard_normal(hd).astype(np.float32)
    cos, sin = jrope.rope_freqs_1d(np.arange(s), d)
    want = jfp.rms_norm_rope(xj, jnp.asarray(g), jnp.asarray(cos), jnp.asarray(sin),
                             heads, eps=1e-6, norm_scope="token", interpret=True,
                             block_s=128)
    got = tfp.rms_norm_rope(xt, torch.from_numpy(g), torch.from_numpy(cos),
                            torch.from_numpy(sin), heads, eps=1e-6)
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, heads, d)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=0)


@pytest.mark.parametrize("mode", ["mod", "affine"])
@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 1e-5)])
def test_k3_plain_matches_pallas_interpret(mode, dtype, tol):
    rng = np.random.default_rng(4)
    b, s, hd = 2, 300, 256
    xj, xt = _both(rng.standard_normal((b, s, hd)) * 2, dtype)
    if mode == "mod":
        a = (rng.standard_normal((b, 1, hd)) * 0.1).astype(np.float32)
        c = (rng.standard_normal((b, 1, hd)) * 0.1).astype(np.float32)
        jkw = dict(scale=jnp.asarray(a), shift=jnp.asarray(c))
        tkw = dict(scale=torch.from_numpy(a), shift=torch.from_numpy(c))
    else:
        a = rng.standard_normal(hd).astype(np.float32)
        c = rng.standard_normal(hd).astype(np.float32)
        jkw = dict(weight=jnp.asarray(a), bias=jnp.asarray(c))
        tkw = dict(weight=torch.from_numpy(a), bias=torch.from_numpy(c))
    want = jfp.layer_norm_mod(xj, eps=1e-6, interpret=True, block_s=128, **jkw)
    got = tfp.layer_norm_mod(xt, eps=1e-6, **tkw)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0)


def test_norms_and_rope_match_f32():
    # f32 elementwise math and one reduction: 1e-5
    rng = np.random.default_rng(6)
    xj, xt = _both(rng.standard_normal((2, 10, 4, 24)), "float32")
    w = rng.standard_normal(24).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    np.testing.assert_allclose(
        _np(tnorms.rms_norm(xt, torch.from_numpy(w), eps=1e-6)),
        _np(jnorms.rms_norm(xj, jnp.asarray(w), eps=1e-6)), atol=1e-5)
    np.testing.assert_allclose(
        _np(tnorms.layer_norm(xt, torch.from_numpy(w), torch.from_numpy(bias))),
        _np(jnorms.layer_norm(xj, jnp.asarray(w), jnp.asarray(bias))), atol=1e-5)
    cos, sin = trope.rope_freqs_1d(np.arange(10), 24)
    jc, js = jrope.rope_freqs_1d(np.arange(10), 24)
    np.testing.assert_array_equal(cos, jc)
    np.testing.assert_array_equal(sin, js)
    np.testing.assert_allclose(
        _np(trope.apply_rope(xt, torch.from_numpy(cos), torch.from_numpy(sin))),
        _np(jrope.apply_rope(xj, jnp.asarray(jc), jnp.asarray(js))), atol=1e-5)


def test_scale_is_rounded_in_the_activation_dtype():
    # the kernel's q pre-scale: scale*log2(e) rounded to bf16, as JAX does
    s = 1 / math.sqrt(128) * math.log2(math.e)
    assert float(tattn._q_scale(1 / math.sqrt(128), torch.bfloat16)) == float(
        jnp.asarray(s, jnp.bfloat16))
