"""The TMA tensor-map geometry of the wgmma/TMA attention body, on the CPU.

``ops/attention.py`` computes every extent, byte stride, box and swizzle
that the C side hands to ``cuTensorMapEncodeTiled``; these tests hold it to
the layouts the main paths pass: Wan's contiguous ``[B, S, H, 128]``
activations (K1), Ulysses' head-major views (K1b, K1c), Latte's q/k/v column
views of one fused projection (K5r), K4's tensors with several groups per
sequence, K1q's normed copies beside the v view of STDiT3's projection, and
the GEMM body's maps (K7, K6, and K8 on flattened or 3-D rows). No card is
needed: the geometry is plain Python.
"""

import pytest
import torch

from magcache_tpu_torch.ops import attention as A

BF16 = torch.bfloat16


def _meta(*shape):
    # strides and shapes only: no storage is touched
    return torch.empty(shape, dtype=BF16, device="meta")


def test_wan_self_attention_maps():
    x = _meta(2, 32760, 12, 128)
    maps = A.flash_tma_maps("K1", *(t.transpose(1, 2) for t in (x, x, x)), 32760)
    assert len(maps) == 6
    row, plane = 12 * 128 * 2, 32760 * 12 * 128 * 2
    for m in maps:
        assert m.dims == (128, 32760, 12, 2)
        assert m.strides == (row, 256, plane)
        assert m.box == (64, A.TMA_BOX_ROWS, 1, 1) and m.swizzle == 128
    assert maps[0] == maps[1]               # the second box starts at column 64
    assert maps[0].words() == [4, 128, 128, 32760, 12, 2, 1, row, 256, plane, 0,
                               64, 128, 1, 1, 1]


def test_wan_cross_attention_masks_keys_by_extent():
    q, ctx = _meta(2, 32760, 12, 128), _meta(2, 512, 12, 128)
    maps = A.flash_tma_maps("K1", q.transpose(1, 2), ctx.transpose(1, 2),
                            ctx.transpose(1, 2), 300)
    assert maps[0].dims[1] == 32760
    assert [m.dims[1] for m in maps[2:]] == [300] * 4   # keys past kv_len read as 0


@pytest.mark.parametrize("sp", [2, 4])
def test_ulysses_head_major_views(sp):
    # after the all-to-all a rank holds all tokens of H/sp heads, [B, S, H/sp, D],
    # and hands the kernel its [B, H/sp, S, D] view
    x = _meta(2, 32760, 12 // sp, 128)
    view = x.transpose(1, 2)
    (m, _, k, _, v, _) = A.flash_tma_maps("flash_attention_bhsd", view, view, view, 32760)
    hs = 12 // sp
    assert m.dims == (128, 32760, hs, 2)
    assert m.strides == (hs * 256, 256, 32760 * hs * 256)
    # a contiguous [B, H, S, D] tensor has the token stride innermost
    c = _meta(2, hs, 8190, 128)
    m = A.flash_tma_maps("flash_attention_bhsd_aux", c, c, c, 8190)[0]
    assert m.dims == (128, 8190, hs, 2)
    assert m.strides == (256, 8190 * 256, hs * 8190 * 256)


def test_latte_column_views():
    qkv = torch.empty(32, 1024, 3 * 16 * 72, dtype=BF16)
    q, k, v = A.split_qkv(qkv, 16)
    assert (k.data_ptr() - qkv.data_ptr(), v.data_ptr() - qkv.data_ptr()) == (2304, 4608)
    maps = A.grouped_tma_maps("grouped_attention_fused_qkv", q, k, v, 1024, 1024)
    assert len(maps) == 6
    for i, m in enumerate(maps):
        # (channel, head, in-group position, group, batch); one group a frame
        assert m.dims == (72, 16, 1024, 1, 32)
        assert m.strides == (144, 3456 * 2, 16, 1024 * 3456 * 2)
        wide = i % 2 == 0
        assert m.box == ((64 if wide else 16), 1, A.TMA_BOX_ROWS, 1, 1)
        assert m.swizzle == (128 if wide else 32)


def test_k4_groups_within_a_sequence():
    qkv = torch.empty(2, 300, 3 * 2 * 72, dtype=BF16)
    q, k, v = qkv.unflatten(-1, (3, 2, 72)).unbind(2)
    maps = A.grouped_tma_maps("grouped_flash_attention_bshd", q, k, v, 100, 77)
    ts = 3 * 2 * 72 * 2
    assert maps[0].dims == (72, 2, 100, 3, 2)          # q: the whole group
    assert [m.dims[2] for m in maps[2:]] == [77] * 4    # k, v: group_valid
    for m in maps:
        assert m.strides == (144, ts, 100 * ts, 300 * ts)
    dense = A.grouped_tma_maps("grouped_flash_attention_bshd", *(
        t.contiguous() for t in (q, k, v)), 100, 77)
    assert dense[0].strides == (144, 288, 100 * 288, 300 * 288)


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_a_stride_off_16_bytes_raises_naming_the_tensor(which):
    good = _meta(1, 2, 200, 128)
    bad = _meta(1, 2, 200, 132)[..., :128]              # rows 264 bytes apart
    args = {n: (bad if n == which else good) for n in "qkv"}
    with pytest.raises(ValueError, match=f"flash_attention_bhsd: {which}: .*16 bytes"):
        A.flash_tma_maps("flash_attention_bhsd", args["q"], args["k"], args["v"], 200)
    odd = torch.empty(1, 32, 3 * 2 * 72 + 4, dtype=BF16)[..., :3 * 2 * 72]
    q, k, v = A.split_qkv(odd, 2)                       # token stride 440 bytes
    with pytest.raises(ValueError, match="K5r: q: .*16 bytes"):
        A.grouped_tma_maps("K5r", q, k, v, 32, 32)


def test_extent_one_dimensions_take_any_stride():
    # a batch of 1 is never stepped along, whatever stride the view carries
    x = torch.empty(1 << 20, dtype=BF16, device="meta").as_strided(
        (1, 300, 2, 128), (3, 256, 128, 1))              # batch stride 6 bytes
    m = A.flash_tma_maps("K1", *(x.transpose(1, 2) for _ in range(3)), 300)[0]
    assert m.dims == (128, 300, 2, 1) and m.strides == (512, 256, 16)


@pytest.mark.parametrize("group,gains,rope,fixed_max,want", [
    (1024, False, False, None, "tma"),     # Latte spatial (K5r)
    (17, False, False, None, "tma"),
    (16, False, False, None, "stream"),    # Latte temporal (K5r)
    (1590, True, False, 16.0, "prepass"),  # STDiT3 spatial (K5)
    (100, False, True, None, "prepass"),   # the row max with RoPE
    (32, True, False, None, "prepass")])   # the row max with gains
def test_grouped_routing_by_arguments(group, gains, rope, fixed_max, want):
    g = (torch.ones(72), torch.ones(72)) if gains else None
    r = (torch.ones(group, 36), torch.zeros(group, 36)) if rope else None
    assert A.grouped_kernel(group, g, r, fixed_max) == want


def test_k5_spatial_prepass_maps_over_normed_copies_and_the_v_view():
    # 480p: 30 frames of 1,590 tokens, one group a frame, 1,400 valid keys;
    # q^ and k^ are the pre-pass's contiguous copies, v a column view
    frames, s, heads, gvalid = 30, 1590, 16, 1400
    qkv = _meta(frames, s, 3 * heads * 72)
    _, _, v = A.split_qkv(qkv, heads)
    qn = kn = _meta(frames, s, heads, 72)
    maps = A.grouped_tma_maps("grouped_attention_fused_qkv", qn, kn, v, s, gvalid)
    assert len(maps) == 6
    row, proj_row = heads * 72 * 2, 3 * heads * 72 * 2
    for i, m in enumerate(maps):
        # (channel, head, in-group position, group, batch): positions past
        # group_valid in k^ (never written) and v arrive as zeros
        assert m.dims == (72, heads, s if i < 2 else gvalid, 1, frames)
        wide = i % 2 == 0
        assert m.box == ((64 if wide else 16), 1, A.TMA_BOX_ROWS, 1, 1)
        assert m.swizzle == (128 if wide else 32)
        # one group a batch row: its dimension (extent 1) is never stepped
        if i < 4:                                   # q^, k^: contiguous
            assert m.strides == (144, row, 16, row * s)
        else:                                       # v: read in place
            assert m.strides == (144, proj_row, 16, proj_row * s)
    assert A.grouped_kernel(s, (None, None), None, 16.0) == "prepass"


@pytest.mark.parametrize("n_groups,heads,group,gains,rope,stages,per_block,grid", [
    (7200, 16, 15, True, True, 14400, 110, 131),   # 720p temporal: 108,000 rows
    (3180, 16, 15, True, True, 6360, 49, 130),     # 480p temporal
    (2048, 16, 16, False, False, 4096, 32, 128),   # Latte temporal
    (7, 3, 15, True, False, 7, 1, 7),              # 3 heads: one stage a group
    (5, 20, 15, False, True, 15, 1, 15),           # 20 heads: the third stage of a group cut
    (1, 1, 16, False, True, 1, 1, 1)])
def test_stream_geometry(n_groups, heads, group, gains, rope, stages, per_block, grid):
    g = A.stream_geometry(n_groups, heads, group, 132, gains=gains, rope=rope)
    assert (g.stages, g.per_block, g.grid) == (stages, per_block, grid)
    # a stage is one group's 8 heads: ceil(H / 8) stages a group
    assert g.stages == n_groups * -(-heads // A.STREAM_SLOTS)
    # every stage in exactly one block's range, no block without a stage
    assert g.grid * g.per_block >= g.stages > (g.grid - 1) * g.per_block
    rows = 16 * 72 * 2                                # a head's 16 rows of 72
    ring = A.STREAM_RING * (3 * A.STREAM_SLOTS * rows + 16)   # q, k, v boxes + mbarriers
    scratch = A.STREAM_SLOTS * 2 * rows               # each consumer warp's q^ and k^
    assert g.smem_bytes == ring + scratch + 128 + (2 * heads * 72 * 4 if gains else 0) + \
        (2 * group * 36 * 4 if rope else 0)
    assert g.smem_bytes <= A.SMEM_LIMIT


def test_stream_geometry_refuses_what_does_not_fit():
    assert A.stream_geometry(10, 43, 16, 132, gains=True, rope=True).smem_bytes <= A.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        A.stream_geometry(10, 44, 16, 132, gains=True, rope=True)


@pytest.mark.parametrize("which", ["K5", "K4"])
def test_stream_maps_box_eight_heads_of_one_group(which):
    # 720p temporal: 7,200 groups of 15 frames in one row of the projection
    # (K5); K4: three tensors with their own token strides, 2 batch rows
    heads, group, gvalid = 16, 15, 13
    if which == "K5":
        qkv = _meta(1, 7200 * group, 3 * heads * 72)
        q, k, v = A.split_qkv(qkv, heads)
    else:
        q, k, v = (_meta(2, 40 * group, heads * 72 + 8 * i)[..., :heads * 72]
                   .unflatten(-1, (heads, 72)) for i in range(1, 4))
    maps = A.stream_tma_maps("grouped_attention", q, k, v, group, gvalid)
    assert len(maps) == 3
    for i, (m, t) in enumerate(zip(maps, (q, k, v))):
        b, s, _, _ = t.shape
        ts = t.stride(1) * 2
        # (channel, in-group position, head, group, batch); rows past the
        # position extent (group for q, group_valid for k and v) are zeros
        assert m.dims == (72, group if i == 0 else gvalid, heads, s // group, b)
        assert m.strides[:3] == (ts, 144, group * ts)
        assert m.box == (72, 16, A.STREAM_SLOTS, 1, 1) and m.swizzle == 0
        assert m.words()[:2] == [5, 0]
    if which == "K5":
        assert maps[0].strides[0] == 6912 and maps[0].dims[3] == 7200


# ---- the GEMM body (K7, K6's projections) and K6's attention stage ----------
from magcache_tpu_torch.ops import gemm as G                       # noqa: E402


@pytest.mark.parametrize("b,s,k,n", [
    (30, 1590, 1152, 3456),     # STDiT3 spatial qkv: 13 row tiles a frame, the last ragged
    (2, 54000, 1152, 4608),     # 720p mlp1
    (2, 16384, 1152, 1152),     # Latte's cross q projection
    (3, 5, 72, 40)])            # one ragged k-tile, one ragged N tile
def test_gemm_maps_are_3d_over_rows_with_the_true_extent(b, s, k, n):
    x, w, out = _meta(b, s, k), _meta(n, k), _meta(b, s + 7, n)
    a, wm, om = G.gemm_tma_maps("lnmod_matmul", x, w, out)
    rows, cols, kt = G.GEMM_TILE
    # rows past S (a ragged last tile, or rows_out's pad) arrive as zeros
    assert a.dims == (k, s, b) and a.strides == (2 * k, 2 * k * s)
    assert a.box == (kt, rows, 1) and a.swizzle == 128
    # columns past K arrive as zeros in both operands
    assert wm.dims == (k, n) and wm.strides == (2 * k,)
    assert wm.box == (kt, cols) and wm.swizzle == 128
    assert a.words()[:2] == [3, 128] and wm.words()[:2] == [2, 128]
    # the stores stop at rows_out (here S + 7: zero pad rows) and N
    assert om.dims == (n, s + 7, b) and om.strides == (2 * n, 2 * n * (s + 7))
    assert om.box == (64, 64, 1) and om.swizzle == 128


def test_gemm_tiles_divide_the_stdit3_widths():
    rows, cols, _ = G.GEMM_TILE
    assert rows == A.TMA_BOX_ROWS
    assert all(width % cols == 0 for width in (1152, 3 * 1152, 4 * 1152))


def test_gemm_maps_refuse_a_width_off_16_bytes():
    # rows of 1,150 bf16 values are 2,300 bytes apart
    with pytest.raises(ValueError, match="lnmod_matmul: x: .*16 bytes"):
        G.gemm_tma_maps("lnmod_matmul", _meta(2, 10, 1150), _meta(64, 1150), _meta(2, 10, 64))
    with pytest.raises(ValueError, match="lnmod_matmul: w: .*16 bytes"):
        G.gemm_tma_maps("lnmod_matmul", _meta(2, 10, 1152)[..., :1150], _meta(64, 1150),
                        _meta(2, 10, 64))


@pytest.mark.parametrize("n,L,kv_valid", [(54000, 300, 300), (16384, 120, 120),
                                          (333, 300, 250), (28800, 512, 512)])
def test_cross_attention_maps_head_dim_72(n, L, kv_valid):
    heads = 16
    q, kv = _meta(2, n, heads * 72), _meta(2, L, heads * 72)
    views = [t.unflatten(-1, (heads, 72)) for t in (q, kv, kv)]
    maps = A.cross_tma_maps("fused_cross_attention", *views, kv_valid)
    assert len(maps) == 6
    row = heads * 72 * 2
    for i, m in enumerate(maps):
        # (channel, head, token, batch); q's token extent N, k and v kv_valid
        assert m.dims == (72, heads, n if i < 2 else kv_valid, 2)
        assert m.strides == (144, row, row * (n if i < 2 else L))
        wide = i % 2 == 0
        assert m.box == ((64 if wide else 16), 1, A.TMA_BOX_ROWS, 1)
        assert m.swizzle == (128 if wide else 32)
    assert kv_valid <= A.CROSS_MAX_KEYS


# ---- K1q: the attention body at head dim 72 on the pre-pass's copies --------
@pytest.mark.parametrize("frames,s,heads,kv_len", [
    (30, 3600, 16, 3600),       # one 720p spatial block
    (2, 2304, 2, 2304),         # frames just above K5's 2,048 tokens
    (3, 300, 2, 77)])           # a kv_len off the 128-key tiles
def test_k1q_maps_over_normed_copies_and_the_v_view(frames, s, heads, kv_len):
    qkv = _meta(frames, s, 3 * heads * 72)
    _, _, v = A.split_qkv(qkv, heads)
    qn, kn = _meta(frames, s, heads, 72), _meta(frames, kv_len, heads, 72)
    maps = A.flash_tma_maps("K1q", qn.transpose(1, 2), kn.transpose(1, 2),
                            v.transpose(1, 2), kv_len)
    assert len(maps) == 6
    row, proj_row = heads * 72 * 2, 3 * heads * 72 * 2
    for i, m in enumerate(maps):
        rows = s if i < 2 else kv_len
        # (channel, token, head, batch); columns 72..79 past the extent
        assert m.dims == (72, rows, heads, frames)
        wide = i % 2 == 0
        assert m.box == ((64 if wide else 16), A.TMA_BOX_ROWS, 1, 1)
        assert m.swizzle == (128 if wide else 32)
        if i < 2:                                   # q^: contiguous
            assert m.strides == (row, 144, s * row)
        elif i < 4:                                 # k^: kv_len rows a frame
            assert m.strides == (row, 144, kv_len * row)
        else:                                       # v: read in place
            assert m.strides == (proj_row, 144, s * proj_row)
    assert proj_row == 6912 or heads != 16          # 720p: 6,912-byte token stride


def test_k1q_v_view_offset_is_16_byte_aligned():
    qkv = torch.empty(1, 4, 3 * 16 * 72, dtype=BF16)
    _, _, v = A.split_qkv(qkv, 16)
    assert (v.data_ptr() - qkv.data_ptr()) % 16 == 0 and v.stride()[2:] == (72, 1)


# ---- K8: the GEMM body's maps over flattened or 3-D rows --------------------
@pytest.mark.parametrize("b,s_in,rows_out,rep,k", [
    (2 * 3600, 15, 15, 3600, 1152),     # 720p temporal proj: flat, 108,000 rows
    (30, 3600, 3600, 15, 1152),         # 720p spatial proj + residual: flat
    (2, 54000, 54000, 1, 4608),         # 720p mlp2: flat, 72 k-tiles
    (4, 40, 47, 2, 144),                # pad rows: 3-D
    (4, 40, 33, 1, 216)])               # dropped rows: 3-D
def test_k8_maps_flat_or_3d(b, s_in, rows_out, rep, k):
    n = 1152 if k != 144 else 216
    geom = G.gate_geometry(b, s_in, rows_out, rep)
    x = _meta(geom.batches, geom.rows, k)
    out = _meta(geom.batches, geom.rows_out, n)
    a, wm, om, rm = G.gemm_tma_maps("matmul_gated_residual", x, _meta(n, k), out, out)
    rows = G.GEMM_TILE[0]
    if rows_out == s_in:
        # one batch row of all B*S_in rows: every tile but the last is live
        assert geom.flat and a.dims == (k, b * s_in, 1) and om.dims == (n, b * s_in, 1)
        assert geom.span == s_in * rep
    else:
        # tiles stay in one batch row: the extent S_in zero-fills pad rows,
        # the output extent rows_out drops rows
        assert not geom.flat and a.dims == (k, s_in, b) and om.dims == (n, rows_out, b)
    assert a.box == (G.GEMM_TILE[2], rows, 1) and om.box == (64, 64, 1)
    assert rm == om                      # the residual tile comes in as the output goes out
    tiles = -(-geom.rows_out // rows) * geom.batches * (n // G.GEMM_TILE[1])
    if (b, s_in) == (2 * 3600, 15):
        assert tiles == 844 * 6          # not 7,200 x 6 tiles of 15 live rows
