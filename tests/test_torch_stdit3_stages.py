"""The stages that K6, K7, K8 and K1q run as on the card, composed in plain
PyTorch on the CPU, against the fused plain versions and the JAX package's
Pallas kernels (``interpret=True``).

On a CUDA tensor K6 is three launches (the q projection and the
out-projection on the wgmma/TMA GEMM body, the row-max attention between
them), K7 two (the LayerNorm-modulated operand, then the GEMM body), K8 one
(the GEMM body with the gate epilogue, on rows that ``ops.gemm.gate_geometry``
lays out) and K1q two (the qk-norm pre-pass, then the attention body on the
normed q at q_scale 1). Each stage has a plain version; composed, they must
give the fused plain version bit for bit (the same operations at the same
rounding points), and stay within the JAX tests' own bound of the Pallas
kernel (``tests/test_fused_matmul_kernels.py``: atol 0.05 for K6, 0.04 for
K7 and K8; ``tests/test_torch_stdit3_ops.py``: 0.02 for K1q) in bf16 and
1e-5 in f32.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu_torch.ops import attention as TA
from magcache_tpu_torch.ops import fused_prologue as TP
from magcache_tpu_torch.ops.gemm import gate_geometry, gate_row_index, linear_plain

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


# ---------------------------------------------------------------- K8
def _k8_stages(x, w, bias, gate, resid, *, rows_out, rep):
    """K8 as the card runs it: x laid onto the GEMM body's rows (flat where
    rows_out == S_in), each output row times the gate row the kernel
    computes for it, then back to ``[B, rows_out, N]``."""
    b, s_in, d_in = x.shape
    rows_out = s_in if rows_out is None else rows_out
    geom = gate_geometry(b, s_in, rows_out, rep)
    idx = gate_row_index(geom)
    rows = gate.reshape(b // rep, -1)[idx.clamp(min=0)]        # [batches, rows_out, N]
    out = linear_plain(
        x.reshape(geom.batches, geom.rows, d_in), w, bias, gate=rows,
        resid=None if resid is None else resid.reshape(geom.batches, geom.rows_out, -1),
        rows_out=geom.rows_out)
    return out.reshape(b, rows_out, -1)


@pytest.mark.parametrize("b,s_in,rows_out,rep,flat", [
    (6, 20, None, 1, True),       # mlp2-like: a gate row per batch row
    (6, 20, None, 3, True),       # spatial proj: a gate row per rep frames
    (3180, 15, None, 1590, True),  # STDiT3 480p temporal: T = 15, batch_repeat S
    (18, 15, None, 9, True),      # 135 rows a gate row: tile 1 straddles a boundary
    (4, 40, 33, 2, False),        # drops rows
    (4, 40, 47, 1, False),        # zero-fills rows
    (6, 15, 16, 3, False)])       # one pad row a batch row
def test_k8_gate_rows_equal_repeat_interleave(b, s_in, rows_out, rep, flat):
    ro = s_in if rows_out is None else rows_out
    geom = gate_geometry(b, s_in, ro, rep)
    assert geom.flat == flat
    assert geom.batches * geom.rows == b * s_in
    idx = gate_row_index(geom).reshape(b, ro)
    want = torch.arange(b // rep).repeat_interleave(rep)[:, None].expand(b, ro)
    live = torch.arange(ro)[None, :] < s_in
    assert torch.equal(idx[:, :min(ro, s_in)], want[:, :min(ro, s_in)])
    assert (idx[~live.expand(b, ro)] == -1).all()           # pad rows read no gate
    if flat:
        # the body's 128-row tiles over the flat rows; where a gate row does
        # not span a multiple of 128 rows some tile holds two gate rows
        tiles = gate_row_index(geom)[0].split(128)
        straddles = [t for t in tiles if t.unique().numel() > 1]
        assert bool(straddles) == (b // rep > 1 and geom.span % 128 != 0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s_in,rows_out,rep,resid", [
    (6, 20, None, 1, True),
    (6, 20, None, 3, False),
    (18, 15, None, 9, False),     # T = 15 flattened across gate boundaries
    (4, 40, 33, 2, True),         # drops rows, 3-D
    (4, 40, 47, 2, True),         # pad rows: zeros, not gate * bias
    (6, 15, 16, 3, False)])
def test_k8_stages_compose_to_the_fused_plain_version(dtype, b, s_in, rows_out, rep, resid):
    _, td = DTYPES[dtype]
    rng = np.random.default_rng(27)
    din, dout = 144, 216
    ro = s_in if rows_out is None else rows_out
    x = _t(rng.standard_normal((b, s_in, din)), td)
    w = _t(rng.standard_normal((dout, din)) * 0.1, td)
    bias = _t(rng.standard_normal(dout) * 0.5, td)
    gate = _t(rng.standard_normal((b // rep, dout)), torch.float32)
    r = _t(rng.standard_normal((b, ro, dout)), td) if resid else None
    got = _k8_stages(x, w, bias, gate, r, rows_out=rows_out, rep=rep)
    want = TP.matmul_gated_residual_plain(x, w, bias, gate, r, rows_out=rows_out,
                                          batch_repeat=rep)
    assert got.shape == (b, ro, dout) and got.dtype == td
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    if ro > s_in:
        assert not got[:, s_in:].any()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s_in,rows_out,rep,resid", [
    (6, 20, None, 3, True), (18, 15, None, 9, False), (4, 40, 47, 2, True)])
def test_k8_stages_match_jax_kernel(dtype, b, s_in, rows_out, rep, resid):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(28)
    din, dout = 128, 256
    ro = s_in if rows_out is None else rows_out
    x = rng.standard_normal((b, s_in, din))
    w = rng.standard_normal((din, dout)) * 0.1
    bias = rng.standard_normal(dout) * 0.5
    gate = rng.standard_normal((b // rep, dout))
    r = rng.standard_normal((b, ro, dout)) if resid else None
    want = JP.matmul_gated_residual(
        _j(x, jd), _j(w, jd), _j(bias, jd), _j(gate, jnp.float32),
        None if r is None else _j(r, jd), rows_out=rows_out, batch_repeat=rep,
        interpret=True)
    got = _k8_stages(_t(x, td), _t(w.T, td), _t(bias, td), _t(gate, torch.float32),
                     None if r is None else _t(r, td), rows_out=rows_out, rep=rep)
    _close(got, want, dtype, 0.04)


# ---------------------------------------------------------------- K1q
def _k1q_case(rng, b, s, heads, strided, td):
    """q, k, v as column views of one fused ``[B, S, 3*H*72]`` projection
    (STDiT3's), or as contiguous copies; and per-head gains."""
    qkv = _t(rng.standard_normal((b, s, 3 * heads * D)) * 1.5, td)
    q, k, v = (p.unflatten(-1, (heads, D)) for p in qkv.chunk(3, dim=-1))
    if not strided:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    gains = tuple(_t(1.0 + 0.2 * rng.standard_normal((heads, D)), torch.float32)
                  for _ in range(2))
    return q, k, v, gains


def _k1q_stages(q, k, v, gains, *, scale, kv_len):
    """K1q as the card runs it: the pre-pass writes q^ and k^ (the first
    kv_len keys), then the fixed-max body at q_scale 1."""
    kv = k.shape[1] if kv_len is None else kv_len
    qn, kn = TA.qk_norm_plain(q, k[:, :kv], gains, scale=scale, true_d=D, eps=1e-6,
                              dtype=v.dtype)
    assert qn.is_contiguous() and kn.shape == (k.shape[0], kv) + k.shape[2:]
    return TA.flash_attention_prescaled_plain(qn, kn, v, kv_len=kv,
                                              fixed_max=TA.QKNORM_FIXED_MAX)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s,kv_len,strided", [(130, None, True), (130, 77, True),
                                              (200, 129, False), (64, None, False)])
def test_k1q_stages_compose_to_the_plain_version(dtype, s, kv_len, strided):
    _, td = DTYPES[dtype]
    rng = np.random.default_rng(29)
    q, k, v, gains = _k1q_case(rng, 2, s, 3, strided, td)
    kw = dict(scale=D ** -0.5, kv_len=kv_len)
    got = _k1q_stages(q, k, v, gains, **kw)
    want = TA.flash_attention_bshd_plain(q, k, v, qk_gains=gains, true_d=D, eps=1e-6,
                                         fixed_max=TA.QKNORM_FIXED_MAX, **kw)
    assert got.shape == (2, s, 3, D) and got.dtype == td
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_k1q_pre_pass_reads_views_as_their_copies():
    rng = np.random.default_rng(30)
    q, k, _, gains = _k1q_case(rng, 2, 100, 2, True, torch.bfloat16)
    assert not q.is_contiguous() and q.stride(1) == 3 * 2 * D
    views = TA.qk_norm_plain(q, k, gains, scale=D ** -0.5, true_d=D)
    copies = TA.qk_norm_plain(q.contiguous(), k.contiguous(), gains, scale=D ** -0.5,
                              true_d=D)
    for a, c in zip(views, copies):
        assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s,kv_len", [(130, None), (130, 100), (300, 257)])
def test_k1q_stages_match_jax_kernel(dtype, s, kv_len):
    """The JAX kernel on heads zero-padded to 128 lanes with ``true_d`` 72
    and zero-padded gains; the port's stages on 72-wide column views of one
    fused projection; a ragged kv_len masks trailing keys."""
    jd, td = DTYPES[dtype]
    heads, b = 2, 2
    rng = np.random.default_rng(31)
    qkv = rng.standard_normal((b, s, 3 * heads * D)) * 1.5
    gains = (1.0 + 0.2 * rng.standard_normal((heads, D)),
             1.0 + 0.2 * rng.standard_normal((heads, D)))
    parts = [qkv[..., i * heads * D:(i + 1) * heads * D].reshape(b, s, heads, D)
             for i in range(3)]
    pad = [(0, 0)] * 3 + [(0, DP - D)]
    want = JA.flash_attention_bshd(
        *(_j(np.pad(a, pad), jd) for a in parts), scale=1.0 / np.sqrt(D),
        kv_len=kv_len, fixed_max=JA.QKNORM_FIXED_MAX,
        qk_gains=tuple(jnp.asarray(np.pad(g, ((0, 0), (0, DP - D))), jnp.float32)
                       for g in gains),
        true_d=D, eps=1e-6, interpret=True)
    want = np.asarray(want, np.float32)[..., :D]
    q, k, v = (p.unflatten(-1, (heads, D)) for p in _t(qkv, td).chunk(3, dim=-1))
    got = _k1q_stages(q, k, v, tuple(_t(g, torch.float32) for g in gains),
                      scale=1.0 / np.sqrt(D), kv_len=kv_len)
    _close(got, want, dtype, 2e-2)
