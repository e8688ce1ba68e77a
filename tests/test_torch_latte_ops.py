"""The plain versions of the port's K5r, K4 and K9 and its ``attention()`` at
head dim 72 against the JAX package's kernels (Pallas interpret mode) on the
CPU, at small shapes made from numpy seeds.

The JAX kernels take 128-lane heads: their inputs are the same values
zero-padded from 72 to 128 lanes (exact: padded q/k lanes add nothing to a
score, padded v lanes only fill dropped output lanes), and the RoPE tables
are the packed [group, 128] form of the port's [group, 36] ones.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu_torch.ops import attention as A
from magcache_tpu_torch.ops import tiny_attention as T
from magcache_tpu_torch.ops.rope import grouped_rope_tables, rope_freqs_1d

# the package's __init__ re-exports the function ``attention`` over the module
JA = importlib.import_module("magcache_tpu.ops.attention")
JT = importlib.import_module("magcache_tpu.ops.tiny_attention")

D, DP = 72, 128
SCALE = D ** -0.5
# f32: summation order only; bf16 outputs: one flipped rounding of an output
# of magnitude < 2 is 2^-7 (the inputs round at the same points on both sides)
F32_TOL = 2e-5
BF16_ATOL, BF16_RTOL = 1.6e-2, 1e-2


def _rand(rng, *shape, dtype="float32", scale=1.0):
    x = rng.standard_normal(shape) * scale
    return x.astype(np.float32) if dtype == "float32" else \
        np.asarray(jnp.asarray(x, jnp.bfloat16))


def _pad(x, axis=-1, to=DP):
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, to - x.shape[axis])
    return np.pad(x, pad)


def _t(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.float32 if dtype == "float32" else torch.bfloat16)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not torch.is_tensor(x) \
        else x.float().numpy()


def _close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=BF16_RTOL)


def _jax_rope(cos, sin):
    """The port's [group, 36] tables as the JAX kernels' [group, 128] ones."""
    c, s = (np.repeat(np.asarray(t), 2, axis=-1) for t in (cos, sin))
    cp = np.ones((c.shape[0], DP), np.float32)
    sp = np.zeros((c.shape[0], DP), np.float32)
    cp[:, :D], sp[:, :D] = c, s
    return jnp.asarray(cp), jnp.asarray(sp)


# ---------------------------------------------------------------- K5r
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,heads,group,gvalid", [
    (2, 128, 2, 64, 64),      # spatial: one group per frame
    (1, 128, 2, 64, 50),      # padded frames
    (1, 512, 3, 16, 16),      # temporal: groups of 16 frames
    (2, 160, 2, 16, 15)])     # temporal with a masked last frame
def test_k5r_plain_matches_jax_kernel(dtype, b, s, heads, group, gvalid):
    rng = np.random.default_rng(group + gvalid + heads)
    qkv = _rand(rng, b, s, 3, heads, D, dtype=dtype, scale=1.5)
    got = A.grouped_attention_fused_qkv_plain(
        _t(qkv.reshape(b, s, -1), dtype), heads, group=group, group_valid=gvalid,
        scale=SCALE)
    want = JA.grouped_attention_fused_qkv(
        jnp.asarray(_pad(qkv).reshape(b, s, -1), jnp.dtype(dtype)), heads,
        group=group, group_valid=gvalid, scale=SCALE, true_d=D, interpret=True)
    want = _np(want).reshape(b, s, heads, DP)[..., :D].reshape(b, s, -1)
    _close(_np(got), want, dtype)
    # the wrapper takes the plain version on a CPU tensor and counts nothing
    before = (A.grouped_attention_fused_qkv.launches,
              A.grouped_attention_fused_qkv.rowmax_launches)
    again = A.grouped_attention_fused_qkv(_t(qkv.reshape(b, s, -1), dtype), heads,
                                          group=group, group_valid=gvalid, scale=SCALE)
    assert torch.equal(again, got)
    assert (A.grouped_attention_fused_qkv.launches,
            A.grouped_attention_fused_qkv.rowmax_launches) == before


def test_k5r_rounds_q_once_after_an_f32_scale():
    """K5r's q is the bf16 input taken to f32, multiplied by scale*log2(e) in
    f32 and rounded to bf16 once (``_grouped_kernel``); K1's plain version
    instead multiplies by a bf16-rounded scale. Here the two differ."""
    rng = np.random.default_rng(7)
    heads, group = 1, 16
    qkv = _t(_rand(rng, 1, group, 3 * heads * D, dtype="bfloat16", scale=2.0), "bf16")
    q, k, v = qkv.unflatten(-1, (3, heads, D)).unbind(2)
    c = SCALE * math.log2(math.e)

    def attend(qs):     # the plain version's ops, the q rounding apart
        s = torch.einsum("nqhd,nkhd->nhqk", qs.float(), k.float())
        p = torch.exp2(s - s.amax(-1, keepdim=True))
        o = torch.einsum("nhqk,nkhd->nqhd", p.to(torch.bfloat16).float(), v.float())
        return (o / p.sum(-1).permute(0, 2, 1)[..., None]).to(torch.bfloat16)

    f32_scale = attend((q.float() * c).to(torch.bfloat16))
    bf16_scale = attend(q * torch.tensor(c, dtype=torch.bfloat16))
    got = A.grouped_attention_fused_qkv_plain(qkv, heads, group=group, scale=SCALE)
    assert torch.equal(got.reshape(f32_scale.shape), f32_scale)
    assert not torch.equal(got.reshape(bf16_scale.shape), bf16_scale)


def test_grouped_refuses_a_fixed_shift_without_gains():
    qkv = torch.zeros(1, 32, 3 * 2 * D)
    with pytest.raises(ValueError, match="qk_gains"):
        A.grouped_attention_fused_qkv(qkv, 2, group=16, fixed_max=16.0)
    q = torch.zeros(1, 32, 2, D)
    with pytest.raises(ValueError, match="qk_gains"):
        A.grouped_flash_attention_bshd(q, q, q, group=16, fixed_max=16.0)
    with pytest.raises(ValueError, match="geometry"):
        A.grouped_flash_attention_bshd(q, q, q, group=24)


# ---------------------------------------------------------------- K4
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm,rope,fixed_max", [
    (False, False, None), (False, True, None), (True, True, None),
    (True, True, 16.0), (True, False, 16.0)])
def test_k4_plain_matches_jax_kernel(dtype, norm, rope, fixed_max):
    rng = np.random.default_rng(11 + 2 * norm + rope)
    b, s, heads, group, gvalid = 2, 96, 2, 16, 13
    q, k, v = (_rand(rng, b, s, heads, D, dtype=dtype, scale=1.5) for _ in range(3))
    qg, kg = (1.0 + 0.2 * rng.standard_normal((heads, D)).astype(np.float32)
              for _ in range(2))
    cos, sin = grouped_rope_tables(gvalid, group, D)
    kw = dict(group=group, group_valid=gvalid, scale=SCALE, true_d=D, eps=1e-6,
              fixed_max=fixed_max)
    got = A.grouped_flash_attention_bshd_plain(
        *(_t(x, dtype) for x in (q, k, v)),
        qk_gains=(torch.from_numpy(qg), torch.from_numpy(kg)) if norm else None,
        rope_tables=(torch.from_numpy(cos), torch.from_numpy(sin)) if rope else None,
        **kw)
    want = JA.grouped_flash_attention_bshd(
        *(jnp.asarray(_pad(x), jnp.dtype(dtype)) for x in (q, k, v)),
        qk_gains=(jnp.asarray(_pad(qg)), jnp.asarray(_pad(kg))) if norm else None,
        rope_tables=_jax_rope(cos, sin) if rope else None, interpret=True, **kw)
    _close(_np(got), _np(want)[..., :D], dtype)
    assert torch.equal(A.grouped_flash_attention_bshd(
        *(_t(x, dtype) for x in (q, k, v)),
        qk_gains=(torch.from_numpy(qg), torch.from_numpy(kg)) if norm else None,
        rope_tables=(torch.from_numpy(cos), torch.from_numpy(sin)) if rope else None,
        **kw), got)


def test_k5_plain_is_k4_on_column_views():
    rng = np.random.default_rng(3)
    qkv = _t(_rand(rng, 2, 48, 3 * 2 * D), "float32")
    q, k, v = qkv.unflatten(-1, (3, 2, D)).unbind(2)
    gains = (torch.ones(D) * 1.1, torch.ones(D) * 0.9)
    kw = dict(group=16, group_valid=14, qk_gains=gains, fixed_max=16.0)
    assert torch.equal(A.grouped_attention_fused_qkv_plain(qkv, 2, **kw),
                       A.grouped_flash_attention_bshd_plain(q, k, v, **kw).reshape(2, 48, -1))


# ---------------------------------------------------------------- K9
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,t,heads,d", [(16, 16, 16, 72), (32, 15, 2, 64)])
@pytest.mark.parametrize("norm,rope", [(False, False), (True, True), (True, False)])
def test_k9_plain_matches_jax_kernel(dtype, r, t, heads, d, norm, rope):
    rng = np.random.default_rng(r + t + 2 * norm + rope)
    qkv = _rand(rng, r, t, 3 * heads * d, dtype=dtype, scale=1.5)
    qg, kg = (1.0 + 0.2 * rng.standard_normal(d).astype(np.float32) for _ in range(2))
    cos, sin = rope_freqs_1d(np.arange(t), d)
    args = ((qg, kg) if norm else (None, None)) + ((cos, sin) if rope else (None, None))
    kw = dict(eps=1e-6, scale=d ** -0.5)
    targs = [None if a is None else torch.from_numpy(a) for a in args]
    got = T.tiny_temporal_attention(_t(qkv, dtype), *targs, heads, mode="vpu", **kw)
    plain = T.tiny_temporal_attention_plain(_t(qkv, dtype), *targs, heads, **kw)
    assert torch.equal(got, plain)
    want = JT.tiny_temporal_attention(
        jnp.asarray(qkv, jnp.dtype(dtype)),
        *(None if a is None else jnp.asarray(a) for a in args), heads,
        interpret=True, **kw)
    _close(_np(got), _np(want), dtype)


@pytest.mark.parametrize("norm,rope", [(False, False), (True, True)])
def test_grouped_mode_matches_jax_grouped(norm, rope):
    rng = np.random.default_rng(5 + norm)
    r, t, heads = 24, 16, 2
    qkv = _rand(rng, r, t, 3 * heads * D, dtype="bfloat16", scale=1.5)
    qg, kg = (1.0 + 0.2 * rng.standard_normal(D).astype(np.float32) for _ in range(2))
    cos, sin = rope_freqs_1d(np.arange(t), D)
    args = ((qg, kg) if norm else (None, None)) + ((cos, sin) if rope else (None, None))
    kw = dict(eps=1e-6, scale=SCALE)
    before = A.grouped_flash_attention_bshd.launches
    got = T.tiny_temporal_attention(
        _t(qkv, "bf16"), *(None if a is None else torch.from_numpy(a) for a in args),
        heads, mode="grouped", **kw)
    assert A.grouped_flash_attention_bshd.launches == before   # CPU: plain version
    want = JT._grouped(jnp.asarray(qkv, jnp.bfloat16),
                       *(None if a is None else jnp.asarray(a) for a in args), heads,
                       interpret=True, **kw)
    _close(_np(got), _np(want), "bfloat16")


def test_tiny_attention_routes_by_shape():
    rng = np.random.default_rng(9)
    qkv = _t(_rand(rng, 4, 33, 3 * 2 * 8), "float32")      # T > 32
    ref = T._reference(qkv, None, None, None, None, 2, eps=1e-6, scale=8 ** -0.5)
    for mode in T.MODES:
        assert torch.equal(T.tiny_temporal_attention(qkv, None, None, None, None, 2,
                                                     mode=mode), ref)
    odd = _t(_rand(rng, 4, 8, 3 * 2 * 7), "float32")      # odd head dim
    assert torch.equal(
        T.tiny_temporal_attention(odd, None, None, None, None, 2, mode="vpu"),
        T._reference(odd, None, None, None, None, 2, eps=1e-6, scale=7 ** -0.5))
    with pytest.raises(ValueError, match="mode"):
        T.tiny_temporal_attention(odd, None, None, None, None, 2, mode="0")


@pytest.mark.parametrize("t,d,route", [
    (16, 72, "stream"),      # Latte temporal
    (15, 72, "stream"),      # STDiT3 temporal
    (1, 72, "stream"),
    (17, 72, "general"),     # past a box of 16 frames
    (16, 64, "general"),     # another head dim
    (32, 128, "general"),
    (5, 80, "general")])
def test_k9_route_by_frames_and_head_dim(t, d, route):
    assert T.tiny_kernel_route(t, d) == route


@pytest.mark.parametrize("rows,heads,t,gains,rope,stages,per_block,grid", [
    (2048, 16, 16, False, False, 4096, 32, 128),   # Latte temporal
    (3180, 16, 15, True, True, 6360, 49, 130),     # STDiT3 480p temporal
    (133, 3, 16, True, True, 133, 2, 67),          # 3 heads; the last block one stage
    (1000, 20, 15, False, True, 3000, 23, 131),    # 20 heads: a group's third stage cut
    (5, 16, 9, True, False, 10, 1, 10)])
def test_k9_stream_geometry(rows, heads, t, gains, rope, stages, per_block, grid):
    g = T.tiny_stream_geometry(rows, heads, t, 132, gains=gains, rope=rope)
    assert (g.stages, g.per_block, g.grid) == (stages, per_block, grid)
    # every stage in exactly one block's range, no block without a stage
    assert g.grid * g.per_block >= g.stages > (g.grid - 1) * g.per_block
    box = 16 * 72 * 2                               # a head's 16 rows of 72, bf16
    ring = 2 * (3 * 8 * box + 16)                   # q, k, v boxes + two mbarriers
    scratch = 8 * 2 * 16 * 76 * 4                   # each consumer warp's f32 k^ and v
    assert g.smem_bytes == ring + scratch + 128 + (2 * heads * 72 * 4 if gains else 0) + \
        (2 * t * 36 * 4 if rope else 0)
    assert g.smem_bytes <= A.SMEM_LIMIT


def test_k9_stream_geometry_refuses_what_does_not_fit():
    assert T.tiny_stream_geometry(10, 68, 16, 132, gains=True, rope=True).smem_bytes \
        <= A.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        T.tiny_stream_geometry(10, 69, 16, 132, gains=True, rope=True)


def test_k9_stream_maps_are_column_views_of_the_projection():
    # R groups of T frames: [1, R*T, H, 72] views of qkv [R, T, 3*H*72]
    r, t, heads = 6, 15, 3
    qkv = torch.zeros(r, t, 3 * heads * D, dtype=torch.bfloat16)
    q, k, v = A.split_qkv(qkv.reshape(1, r * t, -1), heads)
    maps = A.stream_tma_maps("tiny_temporal_attention", q, k, v, t, t)
    row = 3 * heads * D * 2                         # a token's bytes
    for m, view in zip(maps, (q, k, v)):
        assert view.data_ptr() - qkv.data_ptr() in (0, heads * D * 2, 2 * heads * D * 2)
        assert m.dims == (D, t, heads, r, 1)
        assert m.strides[:3] == (row, D * 2, t * row)
        assert m.box == (D, 16, 8, 1, 1) and m.swizzle == 0


def test_k9_refuses_what_its_kernels_do_not_take():
    r, t, heads = 4, 16, 2
    cos, sin = (torch.from_numpy(a) for a in rope_freqs_1d(np.arange(t), D))
    gain = torch.ones(D)
    gains, tabs = T.check_kernel_args((r, t, 3 * heads * D), heads, gain, gain * 2, cos,
                                      sin, torch.device("cpu"))
    assert [tuple(g.shape) for g in gains] == [(heads, D)] * 2 and gains[1][1, 0] == 2
    assert all(x.dtype == torch.float32 and x.is_contiguous() for x in gains + tabs)
    assert T.check_kernel_args((r, t, 3 * heads * D), heads, None, None, None, None,
                               torch.device("cpu")) == ([None, None], [None, None])
    cpu = torch.device("cpu")
    for d in (12, 136):                              # not a multiple of 8; past 128
        with pytest.raises(ValueError, match="head dims"):
            T.check_kernel_args((r, t, 3 * heads * d), heads, None, None, None, None, cpu)
    with pytest.raises(ValueError, match="q_gain"):  # neither [H, D] nor [D]
        T.check_kernel_args((r, t, 3 * heads * D), heads, torch.ones(D - 8), gain, None,
                            None, cpu)
    with pytest.raises(ValueError, match="k_gain"):  # one gain only
        T.check_kernel_args((r, t, 3 * heads * D), heads, gain, None, None, None, cpu)
    with pytest.raises(ValueError, match="rope tables"):   # tables of other frames
        T.check_kernel_args((r, t + 1, 3 * heads * D), heads, None, None, cos, sin, cpu)
    with pytest.raises(ValueError, match="rope tables"):   # on another device
        T.check_kernel_args((r, t, 3 * heads * D), heads, None, None, cos, sin,
                            torch.device("meta"))
    with pytest.raises(ValueError, match="mode"):
        T.tiny_temporal_attention(torch.zeros(r, t, 3 * heads * D), None, None, None, None,
                                  heads, mode="tiled")


# ---------------------------------------------------------------- attention()
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv", [(200, 200), (300, 40)])
def test_attention_head_dim_72_matches_jax_pallas(dtype, sq, skv):
    """``attention()`` at head dim 72 against JAX's, which zero-pads to 128
    and runs its flash kernel. The card route pads the same way before K1;
    here that composition runs through K1's plain version."""
    rng = np.random.default_rng(sq + skv)
    q = _rand(rng, 2, sq, 2, D, dtype=dtype)
    k, v = (_rand(rng, 2, skv, 2, D, dtype=dtype) for _ in range(2))
    want = _np(JA.attention(*(jnp.asarray(x, jnp.dtype(dtype)) for x in (q, k, v)),
                            impl="pallas_interpret"))
    got = A.attention(*(_t(x, dtype) for x in (q, k, v)))
    _close(_np(got), want, dtype)
    padded = A.flash_attention_bshd_plain(*(_t(_pad(x), dtype) for x in (q, k, v)),
                                          scale=SCALE)[..., :D]
    _close(_np(padded), want, dtype)
