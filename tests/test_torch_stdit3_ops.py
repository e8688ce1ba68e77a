"""The plain versions of K1q and K5-K8 against the JAX package's Pallas
kernels run with ``interpret=True`` on the CPU.

The port keeps the published 72-wide heads; the JAX kernels take heads
zero-padded to 128 lanes (and, for K5, groups padded to an aligned length).
Each case builds its inputs with numpy, pads them for the JAX side, and
slices the JAX result back. f32 cases hold to 1e-5 (only the summation order
differs); bf16 cases to the JAX tests' own bounds for these kernels
(``tests/test_fused_matmul_kernels.py``: atol 0.04 for K7/K8, 0.05 for K6),
and K1q and K5 in bf16 to 2e-2 (two bf16 ulps of outputs below 2).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu_torch.ops import attention as TA
from magcache_tpu_torch.ops import fused_prologue as TP
from magcache_tpu_torch.ops.rope import grouped_rope_tables, rope_freqs_1d

# magcache_tpu.ops re-exports a function named ``attention`` over the module
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
    """[..., n*heads*72] -> [..., n*heads*128] with zero lanes per head."""
    lead = a.shape[:-1]
    a = a.reshape(lead + (-1, D))
    a = np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, DP - D)])
    return a.reshape(lead + (-1,))


def _unpad_heads(a):
    lead = a.shape[:-1]
    return a.reshape(lead + (-1, DP))[..., :D].reshape(lead + (-1,))


def _close(got, want, dtype, bf16_atol):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=bf16_atol, rtol=0)


# ---------------------------------------------------------------- K7
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("act,rows_out,rep", [(None, None, 1), ("gelu", None, 1),
                                              (None, 24, 2), ("gelu", 21, 3)])
def test_lnmod_matmul_plain_matches_jax_kernel(dtype, act, rows_out, rep):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(0)
    b, s, din, dout = 6, 20, 144, 216
    x = rng.standard_normal((b, s, din)) * 2.0 + 0.5
    sc = rng.standard_normal((b // rep, din)) * 0.1
    sh = rng.standard_normal((b // rep, din)) * 0.1
    w = rng.standard_normal((din, dout)) * 0.05
    bias = rng.standard_normal(dout) * 0.1
    want = JP.lnmod_matmul(_j(x, jd), _j(sc, jnp.float32), _j(sh, jnp.float32),
                           _j(w, jd), _j(bias, jd), act=act, eps=1e-6,
                           rows_out=rows_out, batch_repeat=rep, interpret=True)
    got = TP.lnmod_matmul(_t(x, td), _t(sc, torch.float32), _t(sh, torch.float32),
                          _t(w.T, td), _t(bias, td), act=act, eps=1e-6,
                          rows_out=rows_out, batch_repeat=rep)
    assert got.shape == want.shape and got.dtype == td
    if rows_out is not None:
        assert not got[:, s:].any()
    _close(got, want, dtype, 0.04)


# ---------------------------------------------------------------- K8
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("resid,rows_out,rep", [(True, None, 1), (False, 13, 1),
                                                (False, 20, 4), (True, 24, 2)])
def test_matmul_gated_residual_plain_matches_jax_kernel(dtype, resid, rows_out, rep):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(1)
    b, s, din, dout = 8, 16, 216, 144
    ro = s if rows_out is None else rows_out
    x = rng.standard_normal((b, s, din))
    w = rng.standard_normal((din, dout)) * 0.05
    bias = rng.standard_normal(dout) * 0.1
    gate = rng.standard_normal((b // rep, dout)) * 0.5
    r = rng.standard_normal((b, ro, dout)) if resid else None
    want = JP.matmul_gated_residual(
        _j(x, jd), _j(w, jd), _j(bias, jd), _j(gate, jnp.float32),
        None if r is None else _j(r, jd), rows_out=rows_out, batch_repeat=rep,
        interpret=True)
    got = TP.matmul_gated_residual(
        _t(x, td), _t(w.T, td), _t(bias, td), _t(gate, torch.float32),
        None if r is None else _t(r, td), rows_out=rows_out, batch_repeat=rep)
    assert got.shape == want.shape == (b, ro, dout)
    _close(got, want, dtype, 0.04)


# ---------------------------------------------------------------- K5
def _qkv_case(rng, rows, group_t, heads):
    """q|k|v rows for ``rows`` groups of ``group_t`` true tokens, 72 wide."""
    return rng.standard_normal((rows, group_t, 3 * heads * D)) * 1.5


def _jax_grouped(qkv, heads, group_t, group_j, gains, rope, jd):
    """JAX side: groups padded group_t -> group_j rows, heads to 128 lanes."""
    rows = qkv.shape[0]
    qp = np.pad(_pad_heads(qkv, 3 * heads), ((0, 0), (0, group_j - group_t), (0, 0)))
    qg = np.pad(gains[0], ((0, 0), (0, DP - D)))
    kg = np.pad(gains[1], ((0, 0), (0, DP - D)))
    tables = None
    if rope:
        cos, sin = rope_freqs_1d(np.arange(group_t), D)
        cp = np.ones((group_j, DP), np.float32)
        sp = np.zeros((group_j, DP), np.float32)
        cp[:group_t, :D] = np.repeat(cos, 2, -1)
        sp[:group_t, :D] = np.repeat(sin, 2, -1)
        tables = (jnp.asarray(cp), jnp.asarray(sp))
    out = JA.grouped_attention_fused_qkv(
        _j(qp.reshape(1, rows * group_j, -1), jd), heads, group=group_j,
        group_valid=group_t, scale=1.0 / np.sqrt(D),
        qk_gains=(jnp.asarray(qg), jnp.asarray(kg)), rope_tables=tables,
        true_d=D, eps=1e-6, fixed_max=JA.QKNORM_FIXED_MAX, interpret=True)
    out = np.asarray(out, np.float32).reshape(rows, group_j, -1)[:, :group_t]
    return _unpad_heads(out)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("group_t,group_j,rope,rows", [
    (5, 8, True, 12),       # temporal: T frames, padded group on the JAX side
    (15, 16, True, 4),      # the slice's T = 15
    (27, 32, False, 3),     # spatial: a frame whose token count is ragged
    (64, 64, False, 2)])    # an aligned frame
def test_grouped_attention_plain_matches_jax_kernel(dtype, group_t, group_j, rope,
                                                    rows):
    """The port runs unpadded groups (group = group_valid = true length)."""
    jd, td = DTYPES[dtype]
    heads = 2
    rng = np.random.default_rng(2)
    qkv = _qkv_case(rng, rows, group_t, heads)
    gains = (1.0 + 0.2 * rng.standard_normal((heads, D)),
             1.0 + 0.2 * rng.standard_normal((heads, D)))
    want = _jax_grouped(qkv, heads, group_t, group_j, gains, rope, jd)
    tables = None
    if rope:
        tables = tuple(torch.from_numpy(t) for t in grouped_rope_tables(group_t, group_t, D))
    got = TA.grouped_attention_fused_qkv(
        _t(qkv.reshape(1, rows * group_t, -1), td), heads, group=group_t,
        scale=1.0 / np.sqrt(D),
        qk_gains=tuple(_t(g, torch.float32) for g in gains), rope_tables=tables,
        true_d=D, eps=1e-6, fixed_max=TA.QKNORM_FIXED_MAX)
    _close(got.reshape(rows, group_t, -1), want, dtype, 2e-2)


@pytest.mark.parametrize("rope", [False, True])
def test_grouped_attention_plain_padded_group_matches_jax(rope):
    """The same padded geometry on both sides (group_valid < group): padded
    keys are masked, padded query rows compute what the JAX kernel does."""
    heads, group_t, group = 2, 6, 8
    rng = np.random.default_rng(3)
    qkv = _qkv_case(rng, 5, group, heads)
    gains = (1.0 + 0.2 * rng.standard_normal((heads, D)),
             1.0 + 0.2 * rng.standard_normal((heads, D)))
    tables = jtables = None
    if rope:
        cos, sin = grouped_rope_tables(group_t, group, D)
        tables = (torch.from_numpy(cos), torch.from_numpy(sin))
        cp = np.ones((group, DP), np.float32)
        sp = np.zeros((group, DP), np.float32)
        cp[:, :D], sp[:, :D] = np.repeat(cos, 2, -1), np.repeat(sin, 2, -1)
        jtables = (jnp.asarray(cp), jnp.asarray(sp))
    want = JA.grouped_attention_fused_qkv(
        jnp.asarray(_pad_heads(qkv, 3 * heads).reshape(1, 5 * group, -1), jnp.float32),
        heads, group=group, group_valid=group_t, scale=1.0 / np.sqrt(D),
        qk_gains=tuple(jnp.asarray(np.pad(g, ((0, 0), (0, DP - D)))) for g in gains),
        rope_tables=jtables, true_d=D, eps=1e-6, fixed_max=JA.QKNORM_FIXED_MAX,
        interpret=True)
    got = TA.grouped_attention_fused_qkv(
        _t(qkv.reshape(1, 5 * group, -1), torch.float32), heads, group=group,
        group_valid=group_t, scale=1.0 / np.sqrt(D),
        qk_gains=tuple(_t(g, torch.float32) for g in gains), rope_tables=tables,
        true_d=D, eps=1e-6, fixed_max=TA.QKNORM_FIXED_MAX)
    np.testing.assert_allclose(got.numpy(), _unpad_heads(np.asarray(want)),
                               atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- K1q
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s,strided", [(100, False), (130, True), (64, True)])
def test_flash_attention_qknorm_plain_matches_jax_kernel(dtype, s, strided):
    """K1 with the fused per-head RMS qk-norm (STDiT3's frames of more than
    2,048 tokens): the JAX kernel on heads zero-padded to 128 lanes with
    ``true_d`` 72 and zero-padded gains; the port on 72-wide heads, read as
    column views of one fused projection when ``strided``. S = 100 and 130
    leave ragged key and query tiles."""
    jd, td = DTYPES[dtype]
    heads, b = 2, 3
    rng = np.random.default_rng(6)
    qkv = rng.standard_normal((b, s, 3 * heads * D)) * 1.5
    gains = (1.0 + 0.2 * rng.standard_normal((heads, D)),
             1.0 + 0.2 * rng.standard_normal((heads, D)))
    parts = [qkv[..., i * heads * D:(i + 1) * heads * D].reshape(b, s, heads, D)
             for i in range(3)]
    pad = [(0, 0)] * 3 + [(0, DP - D)]
    want = JA.flash_attention_bshd(
        *(_j(np.pad(a, pad), jd) for a in parts), scale=1.0 / np.sqrt(D),
        fixed_max=JA.QKNORM_FIXED_MAX,
        qk_gains=tuple(jnp.asarray(np.pad(g, ((0, 0), (0, DP - D))), jnp.float32)
                       for g in gains),
        true_d=D, eps=1e-6, interpret=True)
    want = np.asarray(want, np.float32)[..., :D]
    if strided:
        q, k, v = (p.unflatten(-1, (heads, D)) for p in _t(qkv, td).chunk(3, dim=-1))
        assert q.stride()[1] == 3 * heads * D and not q.is_contiguous()
    else:
        q, k, v = (_t(a, td) for a in parts)
    got = TA.flash_attention_bshd(
        q, k, v, scale=1.0 / np.sqrt(D), fixed_max=TA.QKNORM_FIXED_MAX,
        qk_gains=tuple(_t(g, torch.float32) for g in gains), true_d=D, eps=1e-6)
    assert got.shape == (b, s, heads, D) and got.dtype == td
    _close(got, want, dtype, 2e-2)


def test_flash_attention_qknorm_rounds_q_once_in_f32():
    """The normed path scales q by scale*log2(e) in f32 and rounds once; K1
    without the norm scales q in bf16 by the bf16-rounded factor. On normed
    bf16 inputs with unit gains the two give different outputs."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 40, 1, D))
    q, k, v = (_t(x * f, torch.bfloat16) for f in (1.0, 0.7, 1.3))
    ones = torch.ones(D)
    fused = TA.flash_attention_bshd_plain(q, k, v, fixed_max=16.0, qk_gains=(ones, ones),
                                          true_d=D)
    qn, kn = (TA._rms_head(t, ones, D, 1e-6) for t in (q, k))
    scale = float(D ** -0.5 * np.log2(np.e))
    s = (qn * scale).to(torch.bfloat16).float()[0, :, 0] @ kn.to(torch.bfloat16).float()[0, :, 0].T
    p = torch.exp2(s - 16.0)
    want = (p.to(torch.bfloat16).float() @ v.float()[0, :, 0]) / p.sum(-1, keepdim=True)
    torch.testing.assert_close(fused[0, :, 0].float(), want.to(torch.bfloat16).float(),
                               atol=0, rtol=0)
    unfused = TA.flash_attention_bshd_plain(qn.to(torch.bfloat16), kn.to(torch.bfloat16), v,
                                            fixed_max=16.0)
    assert not torch.equal(fused, unfused)


# ---------------------------------------------------------------- K6
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("residual,kv_valid", [(False, None), (True, None), (True, 25)])
def test_fused_cross_attention_plain_matches_jax_kernel(dtype, residual, kv_valid):
    jd, td = DTYPES[dtype]
    heads, L, dm, b, n = 2, 36, 144, 2, 40
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, n, dm)) * 0.3
    wq = rng.standard_normal((dm, heads * D)) * 0.05
    bq = rng.standard_normal(heads * D) * 0.05
    k = rng.standard_normal((b, L, heads * D)) * 0.3
    v = rng.standard_normal((b, L, heads * D)) * 0.3
    wo = rng.standard_normal((heads * D, dm)) * 0.05
    bo = rng.standard_normal(dm) * 0.05
    sc = 1.0 / np.sqrt(D)
    wo_p = _pad_heads(wo.T, heads).T                   # zero pad rows
    want = JA.fused_cross_attention(
        _j(x, jd), _j(_pad_heads(wq, heads), jd), _j(_pad_heads(bq, heads), jd),
        _j(_pad_heads(k, heads), jd), _j(_pad_heads(v, heads), jd), _j(wo_p, jd),
        _j(bo, jd), heads, scale=sc, kv_valid=kv_valid, true_d=D,
        residual=residual, interpret=True)
    got = TA.fused_cross_attention(
        _t(x, td), _t(wq.T, td), _t(bq, td), _t(k, td), _t(v, td), _t(wo.T, td),
        _t(bo, td), heads, scale=sc, kv_valid=kv_valid, true_d=D,
        residual=residual)
    assert got.shape == (b, n, dm)
    _close(got, want, dtype, 0.05)


# ---------------------------------------------------------------- wrappers
def test_wrappers_refuse_bad_geometry_before_any_kernel():
    x = torch.zeros(4, 10, 16)
    w = torch.zeros(8, 16)
    with pytest.raises(ValueError):
        TP.lnmod_matmul(x, torch.zeros(4, 16), torch.zeros(4, 16), w, rows_out=9)
    with pytest.raises(ValueError):
        TP.matmul_gated_residual(x, w, None, torch.zeros(1, 8), batch_repeat=3)
    with pytest.raises(ValueError):
        TA.grouped_attention_fused_qkv(torch.zeros(1, 10, 3 * 2 * 8), 2, group=4,
                                       qk_gains=(torch.ones(8),) * 2, fixed_max=16.0)
    with pytest.raises(ValueError):
        TA.fused_cross_attention(x, w, None, torch.zeros(4, 3, 8), torch.zeros(4, 3, 8),
                                 torch.zeros(16, 8), None, 2, kv_valid=4)
