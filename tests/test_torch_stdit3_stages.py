"""The stages that K6 and K7 run as on the card, composed in plain PyTorch on
the CPU, against the fused plain versions and the JAX package's Pallas
kernels (``interpret=True``).

On a CUDA tensor K6 is three launches (the q projection and the
out-projection on the wgmma/TMA GEMM body, the row-max attention between
them) and K7 two (the LayerNorm-modulated operand, then the GEMM body).
Each stage has a plain version; composed, they must give the fused plain version bit for bit
(the same operations at the same rounding points), and stay within the JAX
tests' own bound of the Pallas kernel (``tests/test_fused_matmul_kernels.py``:
atol 0.05 for K6, 0.04 for K7) in bf16 and 1e-5 in f32.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu_torch.ops import attention as TA
from magcache_tpu_torch.ops import fused_prologue as TP
from magcache_tpu_torch.ops.gemm import linear_plain

JA = importlib.import_module("magcache_tpu.ops.attention")
JP = importlib.import_module("magcache_tpu.ops.fused_prologue")

D, DP = 72, 128
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _j(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _pad_heads(a, heads):
    """[..., heads*72] -> [..., heads*128] with zero lanes per head."""
    lead = a.shape[:-1]
    a = a.reshape(lead + (heads, D))
    a = np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, DP - D)])
    return a.reshape(lead + (-1,))


def _close(got, want, dtype, bf16_atol):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=bf16_atol, rtol=0)


def _k6_stages(x, wq, bq, k, v, wo, bo, heads, *, scale, kv_valid, residual):
    """K6 as the card runs it: q projection, attention, out-projection."""
    q = linear_plain(x, wq, bq)
    o = TA.cross_attention_rowmax_plain(q, k, v, heads, scale=scale, kv_valid=kv_valid)
    return linear_plain(o, wo, bo, resid=x if residual else None)


def _k6_case(rng, b, n, dm, heads, L):
    x = rng.standard_normal((b, n, dm)) * 0.3
    wq = rng.standard_normal((dm, heads * D)) * 0.05
    bq = rng.standard_normal(heads * D) * 0.05
    k = rng.standard_normal((b, L, heads * D)) * 0.3
    v = rng.standard_normal((b, L, heads * D)) * 0.3
    wo = rng.standard_normal((heads * D, dm)) * 0.05
    bo = rng.standard_normal(dm) * 0.05
    return x, wq, bq, k, v, wo, bo


# ---------------------------------------------------------------- K6
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("L,kv_valid,residual", [
    (120, None, True),     # Latte's caption
    (120, 77, False),
    (300, None, True),     # STDiT3's caption
    (300, 250, True),      # masked keys, a ragged last key tile
    (300, 129, False)])    # one key past the first tile
def test_k6_stages_compose_to_the_fused_plain_version(dtype, L, kv_valid, residual):
    _, td = DTYPES[dtype]
    heads, b, n, dm = 2, 2, 37, 144
    rng = np.random.default_rng(21)
    args = [_t(a, td) for a in _k6_case(rng, b, n, dm, heads, L)]
    args[1], args[5] = args[1].T.contiguous(), args[5].T.contiguous()   # nn.Linear layout
    x, wq, bq, k, v, wo, bo = args
    kw = dict(scale=D ** -0.5, kv_valid=kv_valid, residual=residual)
    got = _k6_stages(x, wq, bq, k, v, wo, bo, heads, **kw)
    want = TA.fused_cross_attention_plain(x, wq, bq, k, v, wo, bo, heads, **kw)
    assert got.dtype == td and got.shape == (b, n, dm)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("L,kv_valid", [(120, 100), (300, None), (300, 250)])
def test_k6_stages_match_jax_kernel(dtype, L, kv_valid):
    jd, td = DTYPES[dtype]
    heads, b, n, dm = 2, 2, 24, 144
    rng = np.random.default_rng(22)
    x, wq, bq, k, v, wo, bo = _k6_case(rng, b, n, dm, heads, L)
    want = JA.fused_cross_attention(
        _j(x, jd), _j(_pad_heads(wq, heads), jd), _j(_pad_heads(bq, heads), jd),
        _j(_pad_heads(k, heads), jd), _j(_pad_heads(v, heads), jd),
        _j(_pad_heads(wo.T, heads).T, jd), _j(bo, jd), heads, scale=D ** -0.5,
        kv_valid=kv_valid, true_d=D, residual=True, interpret=True)
    got = _k6_stages(_t(x, td), _t(wq.T, td), _t(bq, td), _t(k, td), _t(v, td),
                     _t(wo.T, td), _t(bo, td), heads, scale=D ** -0.5,
                     kv_valid=kv_valid, residual=True)
    _close(got, want, dtype, 0.05)


def test_k6_attention_stage_scales_scores_after_the_product():
    """The attention stage multiplies the f32 scores by scale*log2(e); a q
    pre-scaled in bf16 (K5r's form) rounds differently."""
    rng = np.random.default_rng(23)
    q, k, v = (_t(rng.standard_normal((1, 50, 2 * D)) * 2.0, torch.bfloat16)
               for _ in range(3))
    scale = D ** -0.5
    post = TA.cross_attention_rowmax_plain(q, k, v, 2, scale=scale)
    pre = TA.grouped_flash_attention_bshd_plain(
        *(t.unflatten(-1, (2, D)) for t in (q, k, v)), group=50, scale=scale)
    assert not torch.equal(post, pre.reshape(1, 50, -1))
    torch.testing.assert_close(post.float(), pre.reshape(1, 50, -1).float(),
                               atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------- K7
def _k7_stages(x, sc, sh, w, bias, *, act, rows_out, rep, eps=1e-6):
    """K7 as the card runs it: the modulated operand, then the GEMM with its
    epilogue."""
    y = TP.lnmod_operand_plain(x, sc, sh, eps=eps, batch_repeat=rep, dtype=w.dtype)
    return linear_plain(y, w, bias, act=act, rows_out=rows_out)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("act,rows_out,rep", [(None, None, 1), ("gelu", None, 1),
                                              (None, 24, 2), ("gelu", 21, 3),
                                              ("gelu", 33, 2)])
def test_k7_stages_compose_to_the_fused_plain_version(dtype, act, rows_out, rep):
    _, td = DTYPES[dtype]
    rng = np.random.default_rng(24)
    b, s, din, dout = 6, 20, 144, 216
    x = _t(rng.standard_normal((b, s, din)) * 2.0 + 0.5, td)
    sc = _t(rng.standard_normal((b // rep, din)) * 0.1, torch.float32)
    sh = _t(rng.standard_normal((b // rep, din)) * 0.1, torch.float32)
    w = _t(rng.standard_normal((dout, din)) * 0.05, td)
    bias = _t(rng.standard_normal(dout) * 0.1, td)
    kw = dict(act=act, rows_out=rows_out)
    got = _k7_stages(x, sc, sh, w, bias, rep=rep, **kw)
    want = TP.lnmod_matmul_plain(x, sc, sh, w, bias, batch_repeat=rep, **kw)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    if rows_out is not None:
        assert not got[:, s:].any()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("act,rows_out,rep", [("gelu", None, 1), (None, 24, 3)])
def test_k7_stages_match_jax_kernel(dtype, act, rows_out, rep):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(25)
    b, s, din, dout = 6, 20, 144, 216
    x = rng.standard_normal((b, s, din)) * 2.0 + 0.5
    sc = rng.standard_normal((b // rep, din)) * 0.1
    sh = rng.standard_normal((b // rep, din)) * 0.1
    w = rng.standard_normal((din, dout)) * 0.05
    bias = rng.standard_normal(dout) * 0.1
    want = JP.lnmod_matmul(_j(x, jd), _j(sc, jnp.float32), _j(sh, jnp.float32),
                           _j(w, jd), _j(bias, jd), act=act, eps=1e-6,
                           rows_out=rows_out, batch_repeat=rep, interpret=True)
    got = _k7_stages(_t(x, td), _t(sc, torch.float32), _t(sh, torch.float32),
                     _t(w.T, td), _t(bias, td), act=act, rows_out=rows_out, rep=rep)
    _close(got, want, dtype, 0.04)


def test_k7_statistics_are_two_pass():
    """A row with a large offset: the variance of the centred values, not
    E[x^2] - mean^2, which loses it in f32."""
    x = torch.full((1, 1, 64), 1000.0)
    x[..., ::2] += 0.01
    stats = TP.ln_stats_plain(x, 0.0)
    mean = x.double().mean()
    var = ((x.double() - mean) ** 2).mean()
    assert float(stats[0, 0]) == pytest.approx(float(mean), rel=1e-7)
    assert float(stats[0, 1]) == pytest.approx(float(var ** -0.5), rel=1e-2)


def test_linear_plain_epilogues():
    rng = np.random.default_rng(26)
    x = _t(rng.standard_normal((2, 5, 16)), torch.bfloat16)
    w = _t(rng.standard_normal((8, 16)) * 0.2, torch.bfloat16)
    bias = _t(rng.standard_normal(8), torch.float32)
    r = _t(rng.standard_normal((2, 5, 8)), torch.bfloat16)
    acc = x.float() @ w.float().T + bias
    assert torch.equal(linear_plain(x, w, bias), acc.to(torch.bfloat16))
    assert torch.equal(linear_plain(x, w, bias, resid=r), (acc + r.float()).to(torch.bfloat16))
    gelu = torch.nn.functional.gelu(acc, approximate="tanh").to(torch.bfloat16)
    assert torch.equal(linear_plain(x, w, bias, act="gelu"), gelu)
    padded = linear_plain(x, w, bias, rows_out=7)
    assert padded.shape == (2, 7, 8) and not padded[:, 5:].any()
