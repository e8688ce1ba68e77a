"""The port's kernels on an NVIDIA card, against their plain versions.

Marked ``cuda``: without a card (and nvcc) these tests skip. On a
card, from the repository root::

    python -m pytest tests/test_torch_cuda.py -q -p no:cacheprovider

The chip smoke run (``python3 chip_smoke.py``) checks the same kernels at the
main path's full shapes; these use ragged small shapes.
"""

import numpy as np
import pytest
import torch

from magcache_tpu_torch.ops import attention as A
from magcache_tpu_torch.ops import fused_prologue as P

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(dev, *shape, dtype=torch.bfloat16, scale=1.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


# the kernel and the plain version round at the same points; the f32 sums
# run in another order -> a bf16 ulp or two of the output
@pytest.mark.parametrize("fixed_max", [None, 16.0])
@pytest.mark.parametrize("sq,skv,kv_len", [(300, 77, 50), (300, 300, None),
                                           (1000, 512, None), (65, 129, 128)])
def test_k1_matches_plain(dev, fixed_max, sq, skv, kv_len):
    q = _rand(dev, 2, sq, 3, 128, seed=1)
    k = _rand(dev, 2, skv, 3, 128, seed=2)
    v = _rand(dev, 2, skv, 3, 128, seed=3)
    before = A.flash_attention_bshd.launches
    got = A.flash_attention_bshd(q, k, v, kv_len=kv_len, fixed_max=fixed_max)
    want = A.flash_attention_bshd_plain(q, k, v, kv_len=kv_len, fixed_max=fixed_max)
    torch.cuda.synchronize()
    assert A.flash_attention_bshd.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=2e-2)


def test_k1_refuses_what_it_does_not_take(dev):
    q = _rand(dev, 1, 200, 2, 64)
    with pytest.raises(ValueError, match="head dim"):
        A.flash_attention_bshd(q, q, q)
    q = _rand(dev, 1, 200, 2, 128, dtype=torch.float32)
    with pytest.raises(ValueError):
        A.flash_attention_bshd(q, q, q)


# a flipped bf16 rounding of the normed value -> one ulp of the pair's
# largest element
@pytest.mark.parametrize("b,s,heads", [(2, 300, 12), (1, 129, 2), (2, 77, 24), (1, 50, 40),
                                       (3, 9, 9)])
def test_k2_matches_plain(dev, b, s, heads):
    x = _rand(dev, b, s, heads * 128, scale=2.0)
    gain = 1.0 + _rand(dev, heads * 128, dtype=torch.float32, scale=0.1, seed=4)
    ang = torch.rand(s, 64, device=dev) * 6.28
    cos, sin = torch.cos(ang), torch.sin(ang)
    got = P.rms_norm_rope(x, gain, cos, sin, heads, eps=1e-6)
    want = P.rms_norm_rope_plain(x, gain, cos, sin, heads, eps=1e-6)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=1.6e-2)


@pytest.mark.parametrize("s,heads,row,offset,shared_gain", [
    (4096, 24, 9216, 0, True),       # FLUX double block, image q slice
    (4096, 24, 9216, 3072, True),    # ... its k slice
    (512, 24, 9216, 3072, True),     # text k slice
    (4608, 24, 21504, 3072, True),   # single block, k slice of lin1
    (333, 24, 3072, 0, False),       # contiguous rows, [H*D] gain
    (77, 3, 1000, 128, True),        # narrow and ragged
    (65, 12, 1536, 0, False),        # 12 heads, [H*D] gain
    (65, 12, 4608, 1536, True),      # 12 heads, a k slice, shared gain
    (40, 40, 5120, 0, True),         # 40 heads (20 vectors a lane), shared gain
    (33, 40, 15360, 5120, False)])   # 40 heads, a k slice, [H*D] gain
def test_k2_head_scope_matches_plain(dev, s, heads, row, offset, shared_gain):
    hd = heads * 128
    fused = _rand(dev, 1, s, row, scale=2.0, seed=7)
    x = fused[..., offset:offset + hd]
    gain = 1.0 + _rand(dev, 128 if shared_gain else hd, dtype=torch.float32,
                       scale=0.1, seed=8)
    ang = torch.rand(s, 64, device=dev) * 6.28
    cos, sin = torch.cos(ang), torch.sin(ang)
    before = (P.rms_norm_rope.launches, dict(P.rms_norm_rope.scope_launches))
    got = P.rms_norm_rope(x, gain, cos, sin, heads, eps=1e-6, norm_scope="head")
    want = P.rms_norm_rope_plain(x, gain, cos, sin, heads, eps=1e-6,
                                 norm_scope="head")
    torch.cuda.synchronize()
    assert P.rms_norm_rope.launches == before[0] + 1 and got.is_contiguous()
    assert P.rms_norm_rope.scope_launches == dict(before[1], head=before[1]["head"] + 1)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=1.6e-2)


# K2's tp passes: the statistics are f32 sums of the same squares in
# another order; the apply pass rounds as K2 does
@pytest.mark.parametrize("b,s,heads,tp", [(2, 300, 6, 2), (1, 129, 3, 4), (2, 77, 10, 4),
                                          (1, 50, 20, 2), (3, 9, 12, 2), (2, 65, 7, 3)])
def test_k2_tp_passes_match_plain(dev, b, s, heads, tp):
    x = _rand(dev, b, s, heads * 128, scale=2.0)
    gain = 1.0 + _rand(dev, heads * 128, dtype=torch.float32, scale=0.1, seed=4)
    ang = torch.rand(s, 64, device=dev) * 6.28
    cos, sin = torch.cos(ang), torch.sin(ang)
    before = (P.row_sumsq.launches, P.rms_norm_rope.tp_launches,
              dict(P.rms_norm_rope.scope_launches))
    ss = P.row_sumsq(x)
    torch.testing.assert_close(ss, P.row_sumsq_plain(x), atol=0.0, rtol=1e-5)
    total = ss * tp                              # tp ranks' equal slices, summed
    got = P.rms_norm_rope(x, gain, cos, sin, heads, eps=1e-6, row_sumsq=total,
                          width=tp * heads * 128)
    want = P.rms_norm_rope_plain(x, gain, cos, sin, heads, eps=1e-6, row_sumsq=total,
                                 width=tp * heads * 128)
    torch.cuda.synchronize()
    assert (P.row_sumsq.launches, P.rms_norm_rope.tp_launches) == (before[0] + 1,
                                                                   before[1] + 1)
    assert P.rms_norm_rope.scope_launches == before[2]        # not a scope's launch
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=1.6e-2)
    with pytest.raises(ValueError, match="row_sumsq must be f32"):
        P.rms_norm_rope(x, gain, cos, sin, heads, row_sumsq=total.double(),
                        width=tp * heads * 128)
    with pytest.raises(ValueError, match="token scope"):
        P.rms_norm_rope(x, gain, cos, sin, heads, row_sumsq=total, width=heads * 128,
                        norm_scope="head")


def test_k2_refuses_what_it_does_not_take(dev):
    tab = torch.zeros(10, 32, device=dev)
    x = _rand(dev, 1, 10, 4 * 64)                           # head dim 64
    for scope in ("token", "head"):
        with pytest.raises(ValueError, match="head dim"):
            P.rms_norm_rope(x, torch.ones(64, device=dev), tab, tab, 4,
                            norm_scope=scope)
    tab = torch.zeros(10, 64, device=dev)
    x = _rand(dev, 1, 10, 2 * 128)
    with pytest.raises(ValueError):                          # f32 x
        P.rms_norm_rope(x.float(), torch.ones(128, device=dev), tab, tab, 2,
                        norm_scope="head")
    with pytest.raises(ValueError):                          # channel stride 2
        P.rms_norm_rope(_rand(dev, 1, 10, 512)[..., ::2], torch.ones(128, device=dev),
                        tab, tab, 2, norm_scope="head")
    with pytest.raises(ValueError):                          # [D] gain, token scope
        P.rms_norm_rope(x, torch.ones(128, device=dev), tab, tab, 2)
    g = torch.ones(128, device=dev)
    for scope in ("token", "head"):
        with pytest.raises(ValueError, match="16-byte aligned"):  # slice at 4 values
            P.rms_norm_rope(_rand(dev, 1, 10, 1024)[..., 4:4 + 256], g.repeat(2), tab,
                            tab, 2, norm_scope=scope)
        with pytest.raises(ValueError, match="16-byte aligned"):  # row stride 1,028
            P.rms_norm_rope(_rand(dev, 1, 10, 1028)[..., :256], g.repeat(2), tab, tab,
                            2, norm_scope=scope)
    with pytest.raises(ValueError, match="at most"):         # 48 heads: 6,144 a row
        P.rms_norm_rope(_rand(dev, 1, 10, 48 * 128), g, tab, tab, 48, norm_scope="head")


def test_tiny_flux_pipeline_runs_through_the_kernels(dev):
    from magcache_tpu_torch.models.flux import FluxConfig, FluxModel
    from magcache_tpu_torch.pipelines.flux import FluxPipeline, FluxPipelineConfig

    cfg = FluxPipelineConfig(height=192, width=128, txt_len=40,
                             num_inference_steps=28, use_magcache=True)
    mcfg = FluxConfig.tiny(hidden=256, heads=2, axes_dims=(16, 56, 56),
                           dtype="bfloat16")
    model = FluxModel(mcfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    pipe = FluxPipeline(cfg, dev, model=model)
    counts = [A.flash_attention_bshd, P.rms_norm_rope, P.layer_norm_mod]
    before = [f.launches for f in counts]
    scopes = dict(P.rms_norm_rope.scope_launches)
    out = pipe.generate("a fox", seed=0)           # 40 + 96 tokens > 128: K1
    runs = int((~out.skips.all(1)).sum())
    assert int(out.skips.sum()) == 19 and runs == 9
    # per trunk run of 2 double + 2 single blocks; K3 also runs in the head
    assert [f.launches - b for f, b in zip(counts, before)] == [
        4 * runs, 12 * runs, 10 * runs + 28]
    assert P.rms_norm_rope.scope_launches == dict(token=scopes["token"],
                                                  head=scopes["head"] + 12 * runs)
    assert torch.isfinite(out.latents).all()


@pytest.mark.parametrize("mode", ["mod", "affine"])
@pytest.mark.parametrize("width", [1152, 1536, 3072, 5120, 256, 200])
def test_k3_matches_plain(dev, mode, width):
    b = 2
    x = _rand(dev, b, 300, width, scale=2.0)
    if mode == "mod":
        kw = dict(scale=_rand(dev, b, 1, width, dtype=torch.float32, scale=0.1, seed=5),
                  shift=_rand(dev, b, 1, width, dtype=torch.float32, scale=0.1, seed=6))
    else:
        kw = dict(weight=1.0 + _rand(dev, width, dtype=torch.float32, scale=0.1, seed=5),
                  bias=_rand(dev, width, dtype=torch.float32, scale=0.1, seed=6))
    got = P.layer_norm_mod(x, eps=1e-6, **kw)
    want = P.layer_norm_mod_plain(x, eps=1e-6, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=1.6e-2)


@pytest.mark.parametrize("row", [3072, 6144])
def test_k3_reads_modulation_rows_in_place(dev, row):
    """scale/shift as views of a wider f32 table (row stride 6D, as Wan's
    and FLUX's modulation chunks), and one row expanded over the batch."""
    x = _rand(dev, 2, 130, 1536, scale=2.0)
    table = _rand(dev, 2, 1, row, dtype=torch.float32, scale=0.1, seed=5)
    sc, sh = table[..., :1536], table[..., row - 1536:]
    got = P.layer_norm_mod(x, scale=sc, shift=sh, eps=1e-6)
    want = P.layer_norm_mod_plain(x, scale=sc, shift=sh, eps=1e-6)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=1.6e-2)
    one = table[:1, :, :1536].expand(2, 1, 1536)
    torch.testing.assert_close(P.layer_norm_mod(x, scale=one, shift=one).float(),
                               P.layer_norm_mod_plain(x, scale=one, shift=one).float(),
                               atol=3e-2, rtol=1.6e-2)


def test_k3_refuses_what_it_does_not_take(dev):
    g = torch.zeros(2, 1, 104, device=dev)
    with pytest.raises(ValueError, match="multiples of 8"):  # width 100
        P.layer_norm_mod(_rand(dev, 2, 7, 100), eps=1e-6)
    with pytest.raises(ValueError, match="multiples of 8"):  # width 6,144
        P.layer_norm_mod(_rand(dev, 1, 7, 6144), eps=1e-6)
    with pytest.raises(ValueError, match="contiguous"):      # strided rows
        P.layer_norm_mod(_rand(dev, 2, 7, 208)[..., :104], scale=g, shift=g)
    with pytest.raises(ValueError, match="rows must be f32"):  # bf16 table
        P.layer_norm_mod(_rand(dev, 2, 7, 104), scale=g.bfloat16(), shift=g)


def _parent_operand(dev, x, a, c, rep, eps=1e-6):
    """The operand pass K7 ran before it moved onto ``csrc/prologue.cu``:
    ``tools/ln_modulate_parent.cu``, built on its own."""
    import ctypes
    import os

    from magcache_tpu_torch.ops.build import load_standalone_library

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lib = load_standalone_library(os.path.join(root, "tools", "ln_modulate_parent.cu"))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mc_ln_modulate_parent.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ctypes.c_float, vp]
    y = torch.empty_like(x)
    b, s, k = x.shape
    assert lib.mc_ln_modulate_parent(x.data_ptr(), a.data_ptr(), c.data_ptr(), y.data_ptr(),
                                     b, s, k, rep, eps,
                                     torch.cuda.current_stream().cuda_stream) == 0
    return y


@pytest.mark.parametrize("b,s,k,rep", [(30, 159, 1152, 15), (2, 333, 1152, 1),
                                       (6, 27, 144, 2), (2, 65, 4608, 1), (2, 40, 1536, 2)])
def test_k7_operand_is_bit_equal_to_the_parent_kernel(dev, b, s, k, rep):
    from magcache_tpu_torch.ops.build import check_launch, load_cuda_library

    x = _rand(dev, b, s, k, scale=2.0, seed=1)
    a = 1.0 + _rand(dev, b // rep, k, dtype=torch.float32, scale=0.1, seed=2)
    c = _rand(dev, b // rep, k, dtype=torch.float32, scale=0.1, seed=3)
    lib = load_cuda_library()
    y = torch.empty_like(x)
    check_launch(lib, lib.mc_ln_modulate(x.data_ptr(), a.data_ptr(), c.data_ptr(),
                                         y.data_ptr(), b, s, k, rep, 1e-6,
                                         torch.cuda.current_stream().cuda_stream), "K7")
    want = _parent_operand(dev, x, a, c, rep)
    torch.cuda.synchronize()
    assert torch.equal(y, want)


def test_tiny_pipeline_runs_through_the_kernels(dev):
    from magcache_tpu_torch.models.wan import WanConfig
    from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

    cfg = WanPipelineConfig(
        size=(192, 128), frame_num=5, sample_steps=10, sample_shift=5.0,
        guide_scale=5.0, use_magcache=True,
        model_cfg_override=WanConfig.tiny(dim=256, heads=2, ffn_dim=512,
                                          dtype="bfloat16"))
    pipe = WanPipeline(cfg, dev)
    counts = [A.flash_attention_bshd, P.rms_norm_rope, P.layer_norm_mod]
    before = [f.launches for f in counts]
    scopes = dict(P.rms_norm_rope.scope_launches)
    out = pipe.generate("a cat", seed=0)
    runs = int((~out.skips.all(1)).sum())
    per_run = [2 * 2, 2 * 2, 3 * 2]        # per block x 2 blocks
    assert [f.launches - b for f, b in zip(counts, before)] == [
        n * runs for n in per_run]
    assert P.rms_norm_rope.scope_launches == dict(token=scopes["token"] + 4 * runs,
                                                  head=scopes["head"])
    assert torch.isfinite(out.latents).all()
    assert np.asarray(out.skips).sum() == 10


# ---- STDiT3 kernels K5-K8 at odd shapes (head dim 72) -----------------------
# Kernel and plain version round at the same points; f32 sums run in another
# order, which can flip a bf16 rounding of an intermediate (q, the GEMM
# operand, the pre-gate product) and then moves an output by about one bf16
# ulp of its magnitude: atol 2e-2 + rtol 2e-2 for outputs of order 1.
ATOL, RTOL = 2e-2, 2e-2


def _close(got, want):
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,s,din,dout,rows_out,rep,act", [
    (30, 1590, 1152, 3456, None, 15, None),   # spatial qkv: ragged last row tile a frame
    (2, 333, 1152, 4608, None, 1, "gelu"),    # mlp1, ragged rows
    (6, 27, 144, 216, 32, 2, None),           # zero-filled pad rows
    (3, 5, 72, 40, 7, 3, "gelu"),
    (4, 300, 1152, 1152, 400, 2, None),       # a whole pad row tile; modulation rows 0, 0, 1, 1
    (2, 200, 1536, 200, None, 1, "gelu"),     # d_in above the old 1,216 limit, ragged N tile
    (2, 129, 4608, 1152, 130, 2, None)])      # d_in of mlp2's width
def test_k7_matches_plain(dev, b, s, din, dout, rows_out, rep, act):
    x = _rand(dev, b, s, din, scale=2.0, seed=1)
    sc = _rand(dev, b // rep, din, dtype=torch.float32, scale=0.1, seed=2)
    sh = _rand(dev, b // rep, din, dtype=torch.float32, scale=0.1, seed=3)
    w = _rand(dev, dout, din, scale=din ** -0.5, seed=4)
    bias = _rand(dev, dout, scale=0.1, seed=5)
    before = P.lnmod_matmul.launches
    got = P.lnmod_matmul(x, sc, sh, w, bias, act=act, rows_out=rows_out,
                         batch_repeat=rep)
    want = P.lnmod_matmul_plain(x, sc, sh, w, bias, act=act, rows_out=rows_out,
                                batch_repeat=rep)
    assert P.lnmod_matmul.launches == before + 1
    _close(got, want)
    if rows_out is not None:
        assert not got[:, s:].any()


@pytest.mark.parametrize("b,s,din,dout,rows_out,rep,resid", [
    (30, 1590, 1152, 1152, None, 15, True),   # spatial proj + residual: 1,590-row frames
    (3180, 15, 1152, 1152, None, 1590, False),  # temporal proj, flat: T = 15 rows a batch row
    (2, 333, 4608, 1152, None, 1, True),      # mlp2
    (4, 40, 144, 216, 33, 2, False),          # drops rows (3-D)
    (4, 40, 216, 144, 47, 1, True),           # zero-fills rows (3-D)
    (18, 15, 144, 216, None, 9, False),       # flat, 135 rows a gate row: tiles straddle
    (18, 15, 1152, 1152, None, 9, True),      # the same with the residual epilogue
    (4, 1590, 1152, 1152, None, 2, False),    # 3,180 rows a gate row, ragged last tile
    (6, 15, 144, 216, 16, 3, True)])          # one pad row a batch row, residual
def test_k8_matches_plain(dev, b, s, din, dout, rows_out, rep, resid):
    x = _rand(dev, b, s, din, seed=6)
    w = _rand(dev, dout, din, scale=din ** -0.5, seed=7)
    bias = _rand(dev, dout, scale=0.1, seed=8)
    gate = _rand(dev, b // rep, dout, dtype=torch.float32, scale=0.5, seed=9)
    ro = s if rows_out is None else rows_out
    r = _rand(dev, b, ro, dout, seed=10) if resid else None
    before = P.matmul_gated_residual.launches
    got = P.matmul_gated_residual(x, w, bias, gate, r, rows_out=rows_out,
                                  batch_repeat=rep)
    want = P.matmul_gated_residual_plain(x, w, bias, gate, r, rows_out=rows_out,
                                         batch_repeat=rep)
    assert P.matmul_gated_residual.launches == before + 1
    assert got.shape == (b, ro, dout) and got.is_contiguous()
    _close(got, want)
    if ro > s:                                # pad rows: zeros, not gate * bias
        assert not got[:, s:].any()


def test_k8_refuses_what_it_does_not_take(dev):
    x, w = _rand(dev, 4, 40, 144), _rand(dev, 216, 144)
    g, bias = torch.ones(2, 216, device=dev), torch.zeros(216, device=dev)
    with pytest.raises(ValueError, match="gate"):                  # gate rows for rep 1
        P.matmul_gated_residual(x, w, bias, g, batch_repeat=1)
    with pytest.raises(ValueError, match="resid"):                 # resid [B, S_in] for rows_out
        P.matmul_gated_residual(x, w, bias, g, _rand(dev, 4, 40, 216), rows_out=47,
                                batch_repeat=2)
    with pytest.raises(ValueError, match="resid"):                 # a column view
        P.matmul_gated_residual(x, w, bias, g, _rand(dev, 4, 40, 432)[..., :216],
                                batch_repeat=2)
    with pytest.raises(ValueError, match="bias"):                  # bias on the CPU
        P.matmul_gated_residual(x, w, bias.cpu(), g, batch_repeat=2)
    with pytest.raises(ValueError, match="multiples of 8"):
        P.matmul_gated_residual(_rand(dev, 4, 40, 140), _rand(dev, 216, 140), bias, g,
                                batch_repeat=2)


def _grouped_inputs(dev, b, s, heads, group):
    from magcache_tpu_torch.ops.rope import grouped_rope_tables

    qkv = _rand(dev, b, s, 3 * heads * 72, scale=1.5, seed=11)
    gains = (1.0 + _rand(dev, heads, 72, dtype=torch.float32, scale=0.2, seed=12),
             1.0 + _rand(dev, heads, 72, dtype=torch.float32, scale=0.2, seed=13))
    cos, sin = grouped_rope_tables(min(group, 15), group, 72)
    return qkv, gains, (torch.from_numpy(cos).to(dev), torch.from_numpy(sin).to(dev))


@pytest.mark.parametrize("b,s,heads,group,gvalid,rope", [
    (2, 1590, 3, 1590, 1590, False),   # spatial frames, unpadded
    (1, 3180 * 15, 16, 15, 15, True),  # temporal, the slice's shape
    (1, 7 * 15, 2, 15, 15, True),      # groups not a multiple of the block
    (3, 64, 2, 32, 27, False),         # padded groups
    (1, 200, 2, 100, 71, True),        # a group spanning two query tiles
    (1, 48, 2, 8, 5, True),
    (2, 1590, 3, 1590, 1400, False),   # group 1,590, 1,400 valid keys (pre-pass)
    (1, 3180, 2, 1590, 1590, True),    # two groups a batch row, fixed max, RoPE
    (1, 15 * 21, 2, 15, 13, True),     # group 15, 13 valid, 42 tasks: a stage cut
    (1, 16 * 21, 2, 16, 13, True),     # group 16, 13 valid
    (1, 11 * 15, 3, 15, 15, False)])   # 33 tasks: stages cut by n_groups
def test_k5_matches_plain(dev, b, s, heads, group, gvalid, rope):
    qkv, gains, tables = _grouped_inputs(dev, b, s, heads, group)
    kw = dict(group=group, group_valid=gvalid, scale=72 ** -0.5, qk_gains=gains,
              rope_tables=tables if rope else None, true_d=72, eps=1e-6,
              fixed_max=A.QKNORM_FIXED_MAX)
    before = A.grouped_attention_fused_qkv.launches
    got = A.grouped_attention_fused_qkv(qkv, heads, **kw)
    want = A.grouped_attention_fused_qkv_plain(qkv, heads, **kw)
    assert A.grouped_attention_fused_qkv.launches == before + 1
    _close(got, want)


@pytest.mark.parametrize("b,n,heads,dm,L,kv_valid,residual", [
    (2, 2000, 16, 1152, 300, None, True),    # the slice's cross-attention
    (1, 333, 16, 1152, 300, 250, False),     # ragged rows, masked keys
    (2, 70, 2, 144, 36, None, True),         # narrow width
    (1, 64, 4, 200, 77, 65, False),          # d_model not a multiple of 32
    (2, 1000, 16, 1152, 120, 100, True),     # Latte's caption, masked keys
    (2, 300, 17, 1152, 384, 384, True),      # H*D 1,224 > 1,152, three whole key tiles
    (1, 40000, 2, 144, 300, 129, False),     # several query tiles a block
    (2, 23850, 16, 1152, 300, None, False),  # STDiT3 480p x 51 under PAB: the bias epilogue
    (2, 4000, 16, 1152, 512, None, True),    # Open-Sora-Plan's 512 caption keys: 4 tiles
    (1, 333, 16, 1152, 512, 500, False)])    # 512 keys, the last tile masked in part
def test_k6_matches_plain(dev, b, n, heads, dm, L, kv_valid, residual):
    hd = heads * 72
    x = _rand(dev, b, n, dm, seed=14)
    wq = _rand(dev, hd, dm, scale=dm ** -0.5, seed=15)
    bq = _rand(dev, hd, scale=0.05, seed=16)
    k = _rand(dev, b, L, hd, seed=17)
    v = _rand(dev, b, L, hd, seed=18)
    wo = _rand(dev, dm, hd, scale=hd ** -0.5, seed=19)
    bo = _rand(dev, dm, scale=0.05, seed=20)
    kw = dict(scale=72 ** -0.5, kv_valid=kv_valid, true_d=72, residual=residual)
    before = A.fused_cross_attention.launches
    epilogue = "resid" if residual else "bias"
    before_epi = A.fused_cross_attention.epilogues[epilogue]
    got = A.fused_cross_attention(x, wq, bq, k, v, wo, bo, heads, **kw)
    want = A.fused_cross_attention_plain(x, wq, bq, k, v, wo, bo, heads, **kw)
    assert A.fused_cross_attention.launches == before + 1
    assert A.fused_cross_attention.epilogues[epilogue] == before_epi + 1
    _close(got, want)


def test_k5_to_k8_refuse_what_they_do_not_take(dev):
    qkv, gains, _ = _grouped_inputs(dev, 1, 30, 2, 15)
    kw = dict(group=15, qk_gains=gains, fixed_max=16.0)
    with pytest.raises(ValueError, match="head dim"):          # D = 64
        A.grouped_attention_fused_qkv(_rand(dev, 1, 30, 3 * 2 * 64), 2, **kw)
    with pytest.raises(ValueError):                            # f32
        A.grouped_attention_fused_qkv(qkv.float(), 2, **kw)
    with pytest.raises(ValueError):                            # strided view
        A.grouped_attention_fused_qkv(
            _rand(dev, 1, 30, 2 * 3 * 2 * 72)[..., :3 * 2 * 72], 2, **kw)
    x = _rand(dev, 2, 10, 1152)
    kv = _rand(dev, 2, 520, 1152)
    w = _rand(dev, 1152, 1152)
    with pytest.raises(ValueError, match="512 valid keys"):    # K and V stay resident
        A.fused_cross_attention(x, w, None, kv, kv, w, None, 16)
    g = torch.zeros(2, 1152, device=dev)
    with pytest.raises(ValueError):                            # width % 8
        P.lnmod_matmul(_rand(dev, 2, 10, 1150), g[:, :1150], g[:, :1150],
                       _rand(dev, 64, 1150))
    with pytest.raises(ValueError):                            # x not contiguous
        P.lnmod_matmul(_rand(dev, 2, 10, 2304)[..., :1152], g, g, _rand(dev, 64, 1152))
    with pytest.raises(ValueError):                            # w is [d_in, d_out]
        P.matmul_gated_residual(x, _rand(dev, 1152, 64), None, g[:, :64])
    with pytest.raises(ValueError):                            # f32 weight
        P.matmul_gated_residual(x, _rand(dev, 64, 1152, dtype=torch.float32),
                                None, g[:, :64])


# ---- K1q: K1 with the per-head RMS qk-norm fused (head dim 72) ---------------
@pytest.mark.parametrize("b,s,heads,strided,shared_gain", [
    (2, 300, 3, True, True),      # ragged tiles, column views of one projection
    (1, 3600, 16, True, True),    # one 720p frame
    (3, 64, 2, False, False),     # contiguous q/k/v, per-head gains
    (1, 65, 1, True, False)])
def test_k1q_matches_plain(dev, b, s, heads, strided, shared_gain):
    qkv = _rand(dev, b, s, 3 * heads * 72, scale=1.5, seed=21)
    q, k, v = (p.unflatten(-1, (heads, 72)) for p in qkv.chunk(3, dim=-1))
    if not strided:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    shape = (72,) if shared_gain else (heads, 72)
    gains = tuple(1.0 + _rand(dev, *shape, dtype=torch.float32, scale=0.2, seed=22 + i)
                  for i in range(2))
    kw = dict(scale=72 ** -0.5, qk_gains=gains, true_d=72, eps=1e-6,
              fixed_max=A.QKNORM_FIXED_MAX)
    before = (A.flash_attention_bshd.launches, A.flash_attention_bshd.qknorm_launches)
    got = A.flash_attention_bshd(q, k, v, **kw)
    want = A.flash_attention_bshd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (A.flash_attention_bshd.launches,
            A.flash_attention_bshd.qknorm_launches) == (before[0], before[1] + 1)
    assert got.shape == (b, s, heads, 72) and got.is_contiguous()
    # as K1: the same rounding points, f32 sums in another order
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=2e-2)


@pytest.mark.parametrize("s,kv_len", [(3600, 3000), (2304, 300), (500, 129)])
def test_k1q_ragged_kv_len_and_views_equal_copies(dev, s, kv_len):
    heads = 4
    qkv = _rand(dev, 2, s, 3 * heads * 72, scale=1.5, seed=31)
    q, k, v = (p.unflatten(-1, (heads, 72)) for p in qkv.chunk(3, dim=-1))
    gains = tuple(1.0 + _rand(dev, heads, 72, dtype=torch.float32, scale=0.2, seed=32 + i)
                  for i in range(2))
    kw = dict(scale=72 ** -0.5, qk_gains=gains, true_d=72, eps=1e-6, kv_len=kv_len,
              fixed_max=A.QKNORM_FIXED_MAX)
    got = A.flash_attention_bshd(q, k, v, **kw)
    dense = A.flash_attention_bshd(q.contiguous(), k.contiguous(), v.contiguous(), **kw)
    want = A.flash_attention_bshd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, dense)            # strided views read as their copies
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=2e-2)
    # the stages apart: the pre-pass within a bf16 rounding of its plain form
    g = [t.reshape(-1, 72).expand(heads, 72).contiguous() for t in gains]
    qn, kn = A._qk_norm_launch(q, k[:, :kv_len], g, 72 ** -0.5, 1e-6)
    pq, pk = A.qk_norm_plain(q, k[:, :kv_len], gains, scale=72 ** -0.5, true_d=72)
    torch.testing.assert_close(qn.float(), pq.float(), atol=0, rtol=2 ** -7)
    torch.testing.assert_close(kn.float(), pk.float(), atol=0, rtol=2 ** -7)
    o = A._qknorm_attention_launch(qn, kn, v, kv_len, A.QKNORM_FIXED_MAX)
    assert torch.equal(o, got)


def test_k1q_refuses_what_it_does_not_take(dev):
    qkv = _rand(dev, 1, 100, 3 * 2 * 72)
    q, k, v = (p.unflatten(-1, (2, 72)) for p in qkv.chunk(3, dim=-1))
    g = (torch.ones(72, device=dev),) * 2
    with pytest.raises(ValueError, match="fixed_max"):             # running max
        A.flash_attention_bshd(q, k, v, qk_gains=g, true_d=72)
    with pytest.raises(ValueError, match="head dim"):              # D = 128
        x = _rand(dev, 1, 100, 2, 128)
        A.flash_attention_bshd(x, x, x, qk_gains=(torch.ones(128, device=dev),) * 2,
                               fixed_max=16.0)
    with pytest.raises(ValueError):                                # f32
        A.flash_attention_bshd(q.float(), k.float(), v.float(), qk_gains=g, fixed_max=16.0)
    with pytest.raises(ValueError):                                # row not 16-byte aligned
        odd = _rand(dev, 1, 100, 3 * 2 * 72 + 1)[..., 1:]
        qo = odd[..., :144].unflatten(-1, (2, 72))
        A.flash_attention_bshd(qo, qo, qo, qk_gains=g, fixed_max=16.0)
    with pytest.raises(ValueError, match="qg"):                    # gains on the CPU
        A.flash_attention_bshd(q, k, v, qk_gains=(torch.ones(72),) * 2, fixed_max=16.0)
    with pytest.raises(ValueError, match="kg"):                    # gains of 3 heads
        A.flash_attention_bshd(q, k, v, qk_gains=(g[0], torch.ones(3, 72, device=dev)),
                               fixed_max=16.0)


def test_tiny_open_sora_masked_and_large_frames_run_through_the_kernels(dev, tmp_path):
    """Frames of 2,304 tokens (K1q in the spatial blocks), a pinned .npy
    reference and loop=2 through the pipeline on the card."""
    from magcache_tpu_torch.models.stdit3 import STDiT3Config, STDiT3Model
    from magcache_tpu_torch.pipelines.open_sora import (OpenSoraPipeline,
                                                        OpenSoraPipelineConfig)

    cfg = STDiT3Config(hidden=144, heads=2, depth=2, caption_dim=64, freq_dim=64,
                       caption_max_len=20, dtype="bfloat16")
    model = STDiT3Model(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    pipe = OpenSoraPipeline(OpenSoraPipelineConfig(
        height=768, width=768, num_frames=8, num_sampling_steps=6, caption_len=20,
        use_magcache=True, dtype="bfloat16"), dev, model=model)
    ref = str(tmp_path / "ref.npy")
    np.save(ref, np.random.default_rng(0).standard_normal((1, 96, 96, 4)).astype(np.float32))
    before = (A.flash_attention_bshd.qknorm_launches, A.grouped_attention_fused_qkv.launches,
              P.lnmod_matmul.launches)
    out = pipe.generate("a boat", ms="0,0,0,0,1,0", refs=ref, loop=2,
                        condition_frame_length=1, align=None)
    runs = int((~out.skips.all(1)).sum())
    # masked blocks: K1q (spatial) and K5 (temporal) per block pair, no K7
    assert (A.flash_attention_bshd.qknorm_launches - before[0],
            A.grouped_attention_fused_qkv.launches - before[1],
            P.lnmod_matmul.launches - before[2]) == (2 * runs, 2 * runs, 0)
    assert out.latents.shape == (1, 3, 96, 96, 4) and torch.isfinite(out.latents).all()
    np.testing.assert_array_equal(out.latents[0, 0].cpu().numpy(), np.load(ref)[0])


@pytest.mark.parametrize("qk_norm", [True, False])
@pytest.mark.parametrize("route", ["packed", "grouped", "vpu"])
def test_tiny_open_sora_routes_run_through_the_kernels(dev, route, qk_norm):
    """STDiT3 at head dim 72 (frames of 256 tokens, 5 latent frames) through
    the pipeline on each route, with and without qk-norm. Per block pair
    packed: K3 1, K5 (K5r without qk-norm) 2, K6 2, K7 3, K8 4; unpacked: K3
    2, K1 3 (the spatial one at the fixed max with qk-norm, the cross ones at
    the running max), K7 2 and one K4 or K9 on its "stream" route."""
    from magcache_tpu_torch.models.stdit3 import STDiT3Config, STDiT3Model
    from magcache_tpu_torch.ops import tiny_attention as TA
    from magcache_tpu_torch.pipelines.open_sora import (OpenSoraPipeline,
                                                        OpenSoraPipelineConfig)

    cfg = STDiT3Config(hidden=144, heads=2, depth=2, caption_dim=64, freq_dim=64,
                       caption_max_len=20, qk_norm=qk_norm, dtype="bfloat16")
    model = STDiT3Model(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    pipe = OpenSoraPipeline(OpenSoraPipelineConfig(
        height=256, width=256, num_frames=17, num_sampling_steps=6, caption_len=20,
        use_magcache=True, route=route, dtype="bfloat16"), dev, model=model)
    counts = {"K3": (P.layer_norm_mod, "launches"), "K7": (P.lnmod_matmul, "launches"),
              "K8": (P.matmul_gated_residual, "launches"),
              "K5": (A.grouped_attention_fused_qkv, "launches"),
              "K5r": (A.grouped_attention_fused_qkv, "rowmax_launches"),
              "K6": (A.fused_cross_attention, "launches"),
              "K1": (A.flash_attention_bshd, "launches"),
              "K4": (A.grouped_flash_attention_bshd, "launches"),
              "K9": (TA.tiny_temporal_attention, "launches")}

    def read():
        got = {k: getattr(f, attr) for k, (f, attr) in counts.items()}
        got["K1 fixed"] = A.flash_attention_bshd.modes["fixed"]
        got["stream"] = (A._grouped_launch.routes["stream"]
                         + TA.tiny_temporal_attention.routes["stream"])
        return got

    before = read()
    out = pipe.generate("a boat", seed=0)
    got = {k: n - before[k] for k, n in read().items()}
    runs = int((~out.skips.all(1)).sum())
    if route == "packed":
        per_pair = dict(K3=1, K6=2, K7=3, K8=4, stream=1, **{"K5" if qk_norm else "K5r": 2})
    else:
        per_pair = {"K3": 2, "K1": 3, "K7": 2, "K1 fixed": int(qk_norm), "stream": 1,
                    "K4" if route == "grouped" else "K9": 1}
    assert got == {k: 2 * per_pair.get(k, 0) * runs for k in got}
    assert out.skips.any() and runs < 6
    assert out.latents.shape == (1, 5, 32, 32, 4) and torch.isfinite(out.latents).all()


# ---- Latte: K5r (K5 without gains, row max), K4, K9, K1 at padded D ----------
@pytest.mark.parametrize("b,s,heads,group,gvalid,norm,rope", [
    (2, 1024, 3, 1024, 1024, False, False),  # Latte spatial frame (K5r)
    (1, 2048 * 16, 16, 16, 16, False, False),  # Latte temporal (K5r)
    (3, 200, 2, 100, 71, False, True),       # ragged tiles, RoPE without norm
    (1, 64, 2, 32, 27, True, True),          # gains with the row max
    (1, 48, 2, 8, 5, True, False),
    (1, 300, 2, 100, 100, True, True),       # group 100: gains + RoPE + row max
    (2, 1590, 2, 1590, 1400, True, False),   # gains, row max, 1,400 valid keys
    (1, 15 * 21, 2, 15, 13, False, False),   # group 15, 13 valid, a stage cut
    (1, 16 * 21, 2, 16, 13, True, True)])    # group 16, 13 valid, gains + RoPE
def test_k5r_matches_plain(dev, b, s, heads, group, gvalid, norm, rope):
    qkv, gains, tables = _grouped_inputs(dev, b, s, heads, group)
    kw = dict(group=group, group_valid=gvalid, scale=72 ** -0.5,
              qk_gains=gains if norm else None, rope_tables=tables if rope else None)
    before = (A.grouped_attention_fused_qkv.launches,
              A.grouped_attention_fused_qkv.rowmax_launches)
    got = A.grouped_attention_fused_qkv(qkv, heads, **kw)
    want = A.grouped_attention_fused_qkv_plain(qkv, heads, **kw)
    assert (A.grouped_attention_fused_qkv.launches,
            A.grouped_attention_fused_qkv.rowmax_launches) == (before[0], before[1] + 1)
    _close(got, want)


@pytest.mark.parametrize("b,s,heads,group,gvalid,norm,rope,fixed_max", [
    (1, 2048 * 16, 16, 16, 16, False, False, None),  # Latte temporal, grouped mode
    (1, 3180 * 15, 16, 15, 15, True, True, 16.0),    # STDiT3 480p temporal
    (2, 96, 2, 16, 13, True, True, None),
    (1, 300, 2, 100, 77, False, True, None),          # pre-pass groups
    (1, 256, 3, 128, 128, True, False, 16.0),
    (1, 15 * 21, 2, 15, 13, True, True, 16.0),        # group 15, 13 valid
    (1, 3180, 2, 1590, 1400, True, True, 16.0)])      # two groups a row, pre-pass
def test_k4_matches_plain(dev, b, s, heads, group, gvalid, norm, rope, fixed_max):
    qkv, gains, tables = _grouped_inputs(dev, b, s, heads, group)
    q, k, v = qkv.unflatten(-1, (3, heads, 72)).unbind(2)     # strided views
    kw = dict(group=group, group_valid=gvalid, scale=72 ** -0.5,
              qk_gains=gains if norm else None, rope_tables=tables if rope else None,
              fixed_max=fixed_max)
    before = A.grouped_flash_attention_bshd.launches
    got = A.grouped_flash_attention_bshd(q, k, v, **kw)
    want = A.grouped_flash_attention_bshd_plain(q, k, v, **kw)
    assert A.grouped_flash_attention_bshd.launches == before + 1
    assert got.shape == (b, s, heads, 72)
    _close(got, want)
    dense = A.grouped_flash_attention_bshd(q.contiguous(), k.contiguous(), v.contiguous(), **kw)
    assert torch.equal(dense, got)


@pytest.mark.parametrize("group,gvalid,norm,rope,fixed_max", [
    (15, 13, True, True, 16.0), (16, 16, False, False, None), (100, 90, True, True, None),
    (100, 100, False, False, None)])
def test_k4_on_separate_strided_tensors_matches_plain(dev, group, gvalid, norm, rope,
                                                      fixed_max):
    # three tensors, each a view with a padded token stride (and batch stride)
    heads, b, s = 3, 2, 4 * group
    _, gains, tables = _grouped_inputs(dev, b, s, heads, group)
    q, k, v = (_rand(dev, b, s, heads * 72 + 8 * (i + 1), scale=1.5, seed=50 + i)
               [..., :heads * 72].unflatten(-1, (heads, 72)) for i in range(3))
    assert len({t.stride(1) for t in (q, k, v)}) == 3
    kw = dict(group=group, group_valid=gvalid, scale=72 ** -0.5,
              qk_gains=gains if norm else None, rope_tables=tables if rope else None,
              fixed_max=fixed_max)
    before = A.grouped_flash_attention_bshd.launches
    got = A.grouped_flash_attention_bshd(q, k, v, **kw)
    want = A.grouped_flash_attention_bshd_plain(q, k, v, **kw)
    assert A.grouped_flash_attention_bshd.launches == before + 1
    _close(got, want)
    dense = A.grouped_flash_attention_bshd(q.contiguous(), k.contiguous(), v.contiguous(), **kw)
    assert torch.equal(dense, got)


@pytest.mark.parametrize("r,t,heads,d,norm,rope,route", [
    (2048, 16, 16, 72, False, False, "stream"),   # Latte temporal, vpu mode
    (3180, 15, 16, 72, True, True, "stream"),     # STDiT3 480p temporal
    (37, 32, 3, 64, True, False, "general"),
    (50, 5, 2, 128, False, True, "general"),
    (9, 1, 4, 8, True, True, "general"),
    (41, 17, 2, 72, False, True, "general"),      # one frame past the stream boxes
    (300, 16, 2, 64, True, False, "general"),     # 16 frames of another head dim
    (133, 16, 3, 72, True, True, "stream"),       # 3 heads; the last block one stage
    (1000, 15, 20, 72, False, False, "stream"),   # a group's third stage 4 heads
    (7, 9, 11, 72, True, False, "stream"),
    (5, 1, 8, 72, False, True, "stream")])
def test_k9_matches_plain(dev, r, t, heads, d, norm, rope, route):
    from magcache_tpu_torch.ops import tiny_attention as TA
    from magcache_tpu_torch.ops.rope import rope_freqs_1d

    qkv = _rand(dev, r, t, 3 * heads * d, scale=1.5, seed=31)
    gains = tuple(1.0 + _rand(dev, d, dtype=torch.float32, scale=0.2, seed=32 + i)
                  for i in range(2)) if norm else (None, None)
    tabs = tuple(torch.from_numpy(a).to(dev) for a in rope_freqs_1d(np.arange(t), d)) \
        if rope else (None, None)
    before = TA.tiny_temporal_attention.launches
    routes = dict(TA.tiny_temporal_attention.routes)
    got = TA.tiny_temporal_attention(qkv, *gains, *tabs, heads, mode="vpu")
    want = TA.tiny_temporal_attention_plain(qkv, *gains, *tabs, heads)
    assert TA.tiny_temporal_attention.launches == before + 1
    routes[route] += 1
    assert TA.tiny_temporal_attention.routes == routes
    # f32 throughout, rounded once at the store: a bf16 ulp at most
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=1e-2)


def test_stream_store_divides_exactly(dev):
    """The stream route's store (``mc::row_quotient`` in ``csrc/mma_tile.cuh``,
    through the library's test entry) is the correctly rounded acc / l, bit
    for bit: row sums l in [1, 16] (the row max's p is 1) and far outside
    (a fixed shift), reciprocals whose mantissa is all ones, and
    accumulators of every sign over 2^-60 .. 2^60 (the range it is exact
    in reaches about 2^-100 .. 2^100)."""
    from magcache_tpu_torch.ops.build import load_cuda_library

    rng = np.random.default_rng(11)
    n = 1 << 21
    l_vals = np.where(rng.random(n) < 0.5, 1.0 + 15.0 * rng.random(n),
                      2.0 ** rng.uniform(-30, 30, n))
    l_vals[:8] = [1.0, 2.0, 16.0, 3.0, 7.0, np.nextafter(np.float32(2), 0),
                  np.nextafter(np.float32(1), 2), np.nextafter(np.float32(16), 0)]
    ones = np.nextafter(np.float32(2), 0) * 2.0 ** rng.integers(-10, 4, n // 8)
    l_vals[n - n // 8:] = ones                              # 1.11..1 x 2^e
    acc_vals = rng.standard_normal(n) * 2.0 ** rng.uniform(-60, 60, n)
    acc_vals[8:64] = rng.integers(-4096, 4096, 56)           # exact quotients too
    acc_vals[64] = 0.0
    acc = torch.from_numpy(acc_vals.astype(np.float32))
    l_sum = torch.from_numpy(l_vals.astype(np.float32))
    acc_d, l_d = acc.to(dev), l_sum.to(dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    lib = load_cuda_library()
    code = lib.mc_row_quotient(acc_d.data_ptr(), l_d.data_ptr(), out.data_ptr(), n,
                               torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert code == 0
    want = torch.div(acc, l_sum)
    assert torch.equal(out.cpu().view(torch.int32), want.view(torch.int32))
    assert torch.equal(out.cpu().to(torch.bfloat16), want.to(torch.bfloat16))


def test_latte_kernels_refuse_what_they_do_not_take(dev):
    from magcache_tpu_torch.ops import tiny_attention as TA

    q = _rand(dev, 1, 32, 2, 64)
    with pytest.raises(ValueError, match="head dim"):                # D = 64
        A.grouped_flash_attention_bshd(q, q, q, group=16)
    q = _rand(dev, 1, 32, 2, 72)
    with pytest.raises(ValueError):                                  # f32
        A.grouped_flash_attention_bshd(q.float(), q.float(), q.float(), group=16)
    with pytest.raises(ValueError):                                  # row not aligned
        odd = _rand(dev, 1, 32, 2 * 72 + 1)[..., 1:].unflatten(-1, (2, 72))
        A.grouped_flash_attention_bshd(odd, odd, odd, group=16)
    with pytest.raises(ValueError, match="qk_gains"):                # fixed shift, no norm
        A.grouped_flash_attention_bshd(q, q, q, group=16, fixed_max=16.0)
    with pytest.raises(ValueError, match="head dim"):                # D = 12
        TA.tiny_temporal_attention(_rand(dev, 4, 8, 3 * 2 * 12), None, None, None, None,
                                   2, mode="vpu")
    with pytest.raises(ValueError):                                  # strided qkv
        TA.tiny_temporal_attention(_rand(dev, 4, 8, 2 * 3 * 2 * 72)[..., :3 * 2 * 72],
                                   None, None, None, None, 2, mode="vpu")


@pytest.mark.parametrize("sq,skv,fixed_max", [(1024, 1024, None), (2000, 120, None),
                                              (300, 300, 16.0)])
def test_attention_pads_head_dim_72_for_k1(dev, sq, skv, fixed_max):
    q = _rand(dev, 2, sq, 3, 72, seed=41)
    k, v = _rand(dev, 2, skv, 3, 72, seed=42), _rand(dev, 2, skv, 3, 72, seed=43)
    before = A.flash_attention_bshd.launches
    got = A.attention(q, k, v, fixed_max=fixed_max)
    assert A.flash_attention_bshd.launches == before + 1
    want = A.flash_attention_bshd_plain(q, k, v, scale=72 ** -0.5, fixed_max=fixed_max)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=2e-2)


# Vchitect-XL's K1 calls at head dim 64 (padded to 128 by attention()): the
# per-frame joint attention over 1,517 tokens (4 frames of the 80 here; the
# last q and key tiles ragged) and the cross-attention of 2 x 60,680 queries
# to frame 0's 77 keys (one partial key tile)
@pytest.mark.parametrize("b,sq,skv", [(4, 1517, 1517), (2, 60680, 77)])
def test_attention_at_vchitect_shapes_matches_plain(dev, b, sq, skv):
    q = _rand(dev, b, sq, 24, 64, seed=91)
    k, v = _rand(dev, b, skv, 24, 64, seed=92), _rand(dev, b, skv, 24, 64, seed=93)
    before = A.flash_attention_bshd.launches
    got = A.attention(q, k, v)
    assert A.flash_attention_bshd.launches == before + 1
    want = A.flash_attention_bshd_plain(q, k, v, scale=64 ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=2e-2)


@pytest.mark.parametrize("route", ["packed", "grouped", "vpu"])
def test_tiny_latte_pipeline_runs_through_the_kernels(dev, route):
    """Frames of 256 tokens (> 128: K1 on the unpacked routes) through the
    pipeline on the card; per block pair packed: K3 1, K5r 2, K6 1, K7 3,
    K8 4; unpacked: K3 4, K1 2 and one K4 or K9."""
    from magcache_tpu_torch.models.latte import LatteConfig, LatteModel
    from magcache_tpu_torch.ops import tiny_attention as TA
    from magcache_tpu_torch.pipelines.latte import LattePipeline, LattePipelineConfig

    cfg = LatteConfig(hidden=144, heads=2, depth=2, caption_dim=64, time_embed_dim=64,
                      dtype="bfloat16")
    model = LatteModel(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    pipe = LattePipeline(LattePipelineConfig(
        num_frames=4, height=256, width=256, num_sampling_steps=10, caption_len=20,
        use_magcache=True, magcache_ratios=tuple(np.linspace(1.0, 0.96, 9)),
        route=route, dtype="bfloat16"), dev, model=model)
    counts = {"K3": P.layer_norm_mod, "K6": A.fused_cross_attention,
              "K7": P.lnmod_matmul, "K8": P.matmul_gated_residual,
              "K1": A.flash_attention_bshd, "K4": A.grouped_flash_attention_bshd,
              "K9": TA.tiny_temporal_attention}
    before = {k: f.launches for k, f in counts.items()}
    before["K5r"] = A.grouped_attention_fused_qkv.rowmax_launches
    out = pipe.generate("a boat", seed=0)
    got = {k: f.launches - before[k] for k, f in counts.items()}
    got["K5r"] = A.grouped_attention_fused_qkv.rowmax_launches - before["K5r"]
    runs = int((~out.skips.all(1)).sum())
    per_pair = (dict(K3=1, K5r=2, K6=1, K7=3, K8=4) if route == "packed" else
                dict(K3=4, K1=2, **{"K4" if route == "grouped" else "K9": 1}))
    assert got == {k: 2 * per_pair.get(k, 0) * runs for k in got}
    assert out.skips.any() and runs < 10
    assert out.latents.shape == (1, 4, 32, 32, 4) and torch.isfinite(out.latents).all()
    np.testing.assert_array_equal(out.skips, pipe.skip_mask_for())


# ---- K1b, K1c and K3p (the sequence-parallel path's kernels) ---------------

# K1b is K1's kernel body read through (batch, head, token) strides: the
# same tolerance as K1. Contiguous [B, H, S, D] and head-major views of
# [B, S, H, D]; kv_len below the key count; lengths off the 64-row tile.
@pytest.mark.parametrize("fixed_max", [None, 16.0])
@pytest.mark.parametrize("sq,skv,kv_len", [(300, 77, 50), (300, 300, None),
                                           (1000, 512, None), (65, 129, 128)])
@pytest.mark.parametrize("view", [False, True])
def test_k1b_matches_plain(dev, fixed_max, sq, skv, kv_len, view):
    shape = (lambda s: (2, s, 3, 128)) if view else (lambda s: (2, 3, s, 128))
    q, k, v = (_rand(dev, *shape(s), seed=i) for i, s in ((1, sq), (2, skv), (3, skv)))
    if view:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    before = A.flash_attention_bhsd.launches
    got = A.flash_attention_bhsd(q, k, v, kv_len=kv_len, fixed_max=fixed_max)
    want = A.flash_attention_bhsd_plain(q, k, v, kv_len=kv_len, fixed_max=fixed_max)
    torch.cuda.synchronize()
    assert A.flash_attention_bhsd.launches == before + 1
    assert got.shape == q.shape and got.stride() == q.stride()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=2e-2)


def test_k1b_equals_k1_on_the_same_values(dev):
    # one kernel body: bit-equal outputs whatever the layout
    q, k, v = (_rand(dev, 1, 333, 2, 128, seed=i) for i in range(3))
    want = A.flash_attention_bshd(q, k, v, fixed_max=16.0)
    got = A.flash_attention_bhsd(*(t.transpose(1, 2).contiguous() for t in (q, k, v)),
                                 fixed_max=16.0)
    assert torch.equal(got.transpose(1, 2), want)


# K1c: o as K1 (a bf16 ulp or two); m is the max of f32 scores whose
# products sum in another order (|s| < 16 -> 1e-4 covers it); l sums up to
# 512 f32 terms -> 1e-4 relative
@pytest.mark.parametrize("sq,skv,kv_len", [(300, 77, 50), (300, 300, None),
                                           (1000, 512, None), (65, 129, 128)])
@pytest.mark.parametrize("view", [False, True])
def test_k1c_matches_plain(dev, sq, skv, kv_len, view):
    shape = (lambda s: (2, s, 3, 128)) if view else (lambda s: (2, 3, s, 128))
    q, k, v = (_rand(dev, *shape(s), seed=i) for i, s in ((1, sq), (2, skv), (3, skv)))
    if view:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    before = A.flash_attention_bhsd_aux.launches
    o, m, l = A.flash_attention_bhsd_aux(q, k, v, kv_len=kv_len)
    ow, mw, lw = A.flash_attention_bhsd_aux_plain(q, k, v, kv_len=kv_len)
    torch.cuda.synchronize()
    assert A.flash_attention_bhsd_aux.launches == before + 1
    assert m.shape == l.shape == (2, 3, sq) and m.dtype == l.dtype == torch.float32
    torch.testing.assert_close(o.float(), ow.float(), atol=2e-3, rtol=2e-2)
    torch.testing.assert_close(m, mw, atol=1e-4, rtol=0)
    torch.testing.assert_close(l, lw, atol=0, rtol=1e-4)


def test_k1b_k1c_refuse_what_they_do_not_take(dev):
    for fn in (A.flash_attention_bhsd, A.flash_attention_bhsd_aux):
        q = _rand(dev, 1, 2, 200, 64)
        with pytest.raises(ValueError, match="head dim"):
            fn(q, q, q)
        q = _rand(dev, 1, 2, 200, 128, dtype=torch.float32)
        with pytest.raises(ValueError):
            fn(q, q, q)
        q = _rand(dev, 1, 2, 200, 256)[..., ::2]            # channel stride 2
        with pytest.raises(ValueError, match="unit channel stride"):
            fn(q, q, q)


def test_ring_merge_of_k1c_matches_k1(dev):
    # four key shards merged as ring attention merges them, against K1 with
    # the running max on the whole sequence: o is rounded to bf16 at each of
    # the 3 merges, half an ulp of |o| < 0.25 each -> 3 * 2^-11 on top of
    # K1's own 2e-3
    from magcache_tpu_torch.parallel import collectives as C
    from magcache_tpu_torch.parallel.mesh import run_local_ranks

    q, k, v = (_rand(dev, 1, 4 * 250, 2, 128, seed=i) for i in range(3))
    want = A.flash_attention_bshd(q, k, v)
    outs = run_local_ranks(4, lambda plan: C.ring_attention(
        *(C.split_sequence(t, plan) for t in (q, k, v)), plan), device=dev)
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat(outs, 1).float(), want.float(),
                               atol=2e-3 + 3 * 2 ** -11, rtol=2e-2)


# Ulysses and the ring at head dim 72 with no scale given: on the card q, k
# and v are zero-padded to K1b's / K1c's 128 lanes, and the softmax scale
# stays 1/sqrt(72) of the unpadded heads. Tolerances as above: the ring's
# one merge rounds o to bf16 once more (half an ulp of |o| < 0.25)
@pytest.mark.parametrize("impl", ["ulysses", "ring"])
def test_sp_attention_at_head_dim_72_scales_by_the_unpadded_dim(dev, impl):
    from magcache_tpu_torch.parallel import collectives as C
    from magcache_tpu_torch.parallel.mesh import run_local_ranks

    q, k, v = (_rand(dev, 2, 2 * 300, 4, 72, seed=80 + i) for i in range(3))
    want = A.flash_attention_bshd_plain(q, k, v)
    fn = C.ulysses_attention if impl == "ulysses" else C.ring_attention
    outs = run_local_ranks(2, lambda plan: fn(
        *(C.split_sequence(t, plan) for t in (q, k, v)), plan), device=dev)
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat(outs, 1).float(), want.float(),
                               atol=2e-3 + 2 ** -11, rtol=2e-2)


# K3p rounds once, at the store, as its plain version: a tie may flip after
# a differently ordered f32 sum -> one bf16 ulp at |y| < 8
@pytest.mark.parametrize("b,s,d", [(2, 300, 1536), (1, 129, 1152), (3, 7, 104),
                                   (2, 65, 3072), (1, 33, 5120)])
def test_k3p_matches_plain(dev, b, s, d):
    x = _rand(dev, b, s, d, scale=2.0)
    before = (P.layer_norm_mod.launches, P.layer_norm_mod.plain_launches)
    got = P.layer_norm_mod(x, eps=1e-6)
    want = P.layer_norm_mod_plain(x, eps=1e-6)
    torch.cuda.synchronize()
    assert (P.layer_norm_mod.launches, P.layer_norm_mod.plain_launches) == (
        before[0], before[1] + 1)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=1.6e-2)


# ---- the wgmma/TMA body's edges: ragged 128-row tiles, shard views, groups --

# K1 on 128-query, 128-key tiles: lengths off the tile, kv_len inside the
# last key tile; the 7,800-token request shape of Wan at 832x480x17
@pytest.mark.parametrize("fixed_max", [None, 16.0])
@pytest.mark.parametrize("sq,skv,kv_len", [(7800, 7800, None), (1950, 512, 300),
                                           (130, 77, None)])
def test_k1_ragged_tiles_match_plain(dev, fixed_max, sq, skv, kv_len):
    q = _rand(dev, 1, sq, 2, 128, seed=51)
    k, v = _rand(dev, 1, skv, 2, 128, seed=52), _rand(dev, 1, skv, 2, 128, seed=53)
    got = A.flash_attention_bshd(q, k, v, kv_len=kv_len, fixed_max=fixed_max)
    want = A.flash_attention_bshd_plain(q, k, v, kv_len=kv_len, fixed_max=fixed_max)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=2e-2)


# K1b on the head-major views a rank holds after Ulysses' all-to-all at the
# 7,800-token request: sp 2 (6 heads) and sp 4 (3 heads), and the cross
# attention of a 1,950-token shard over 512 keys
@pytest.mark.parametrize("sp", [2, 4])
def test_k1b_on_sp_shard_views_matches_plain(dev, sp):
    q, k, v = (_rand(dev, 2, 7800, 12 // sp, 128, seed=60 + i).transpose(1, 2)
               for i in range(3))
    before = A.flash_attention_bhsd.launches
    got = A.flash_attention_bhsd(q, k, v, fixed_max=16.0)
    want = A.flash_attention_bhsd_plain(q, k, v, fixed_max=16.0)
    assert got.stride() == q.stride()
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=2e-2)
    cq = _rand(dev, 2, 7800 // sp, 12, 128, seed=63).transpose(1, 2)
    ck, cv = (_rand(dev, 2, 512, 12, 128, seed=64 + i).transpose(1, 2) for i in range(2))
    got = A.flash_attention_bhsd(cq, ck, cv, fixed_max=16.0)
    want = A.flash_attention_bhsd_plain(cq, ck, cv, fixed_max=16.0)
    torch.cuda.synchronize()
    assert A.flash_attention_bhsd.launches == before + 2
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=2e-2)


# K1c's m and l on rows of a ragged last query tile (the ring step of a
# 1,950-token shard; 300 queries over 77 keys with kv_len 50)
@pytest.mark.parametrize("sq,skv,kv_len", [(1950, 1950, None), (300, 77, 50)])
def test_k1c_ragged_rows_return_m_and_l(dev, sq, skv, kv_len):
    q = _rand(dev, 2, sq, 3, 128, seed=71).transpose(1, 2)
    k, v = (_rand(dev, 2, skv, 3, 128, seed=72 + i).transpose(1, 2) for i in range(2))
    o, m, l = A.flash_attention_bhsd_aux(q, k, v, kv_len=kv_len)
    ow, mw, lw = A.flash_attention_bhsd_aux_plain(q, k, v, kv_len=kv_len)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), ow.float(), atol=2e-3, rtol=2e-2)
    torch.testing.assert_close(m, mw, atol=1e-4, rtol=0)
    torch.testing.assert_close(l, lw, atol=0, rtol=1e-4)


# the row max without gains or RoPE, groups of more than 16 tokens: the
# wgmma/TMA body, through K5 (K5r) and K4 alike; K5's tolerances
@pytest.mark.parametrize("b,s,heads,group,gvalid", [
    (2, 34, 2, 17, 17), (3, 200, 2, 100, 71), (2, 1024, 3, 1024, 1024),
    (1, 3180, 2, 1590, 1200), (1, 2048, 2, 2048, 2048),
    (1, 2 * 1024 * 17, 16, 17, 17)])   # Open-Sora-Plan v1.1's temporal groups of 17
@pytest.mark.parametrize("through", ["K5", "K4"])
def test_rowmax_tma_path_matches_plain(dev, b, s, heads, group, gvalid, through):
    qkv, _, _ = _grouped_inputs(dev, b, s, heads, group)
    kw = dict(group=group, group_valid=gvalid, scale=72 ** -0.5)
    before = (A._grouped_launch.routes["tma"], A.grouped_attention_fused_qkv.rowmax_launches,
              A.grouped_flash_attention_bshd.launches)
    if through == "K5":
        got = A.grouped_attention_fused_qkv(qkv, heads, **kw)
        want = A.grouped_attention_fused_qkv_plain(qkv, heads, **kw)
        counts = (1, 1, 0)
    else:
        q, k, v = qkv.unflatten(-1, (3, heads, 72)).unbind(2)
        got = A.grouped_flash_attention_bshd(q, k, v, **kw)
        want = A.grouped_flash_attention_bshd_plain(q, k, v, **kw)
        counts = (1, 0, 1)
    after = (A._grouped_launch.routes["tma"], A.grouped_attention_fused_qkv.rowmax_launches,
             A.grouped_flash_attention_bshd.launches)
    assert tuple(x - y for x, y in zip(after, before)) == counts
    _close(got, want)


@pytest.mark.parametrize("norm,rope,group,route", [
    (True, False, 32, "prepass"), (False, True, 100, "prepass"), (False, False, 16, "stream")])
def test_gains_or_rope_take_the_prepass_and_small_groups_stream(dev, norm, rope, group,
                                                                  route):
    qkv, gains, tables = _grouped_inputs(dev, 1, 4 * group, 2, group)
    before = dict(A._grouped_launch.routes)
    got = A.grouped_attention_fused_qkv(qkv, 2, group=group, scale=72 ** -0.5,
                                        qk_gains=gains if norm else None,
                                        rope_tables=tables if rope else None)
    assert {k: n - before[k] for k, n in A._grouped_launch.routes.items()} == dict(
        {"stream": 0, "tma": 0, "prepass": 0}, **{route: 1})
    _close(got, A.grouped_attention_fused_qkv_plain(
        qkv, 2, group=group, scale=72 ** -0.5, qk_gains=gains if norm else None,
        rope_tables=tables if rope else None))


# the SD VAE presets and Open-Sora's composite at test widths (f32 cuDNN
# convs without TF32, as the fixture sets it): the card against the CPU,
# within 1e-4 of the largest pixel
@pytest.mark.parametrize("preset", ["FLUX_VAE", "SD_VAE_FT", "SD3_VAE", "OPEN_SORA"])
def test_vae_decode_on_the_card_matches_cpu(dev, preset):
    import dataclasses

    from magcache_tpu_torch.models import vae as TV
    from magcache_tpu_torch.models import vae_sd as TS
    from magcache_tpu_torch.models import vae_temporal as TT

    torch.backends.cudnn.allow_tf32 = False
    narrow = dict(base=8, ch_mult=(1, 1, 2, 2), blocks_per_level=1, groups=4)

    def build(device):
        if preset == "OPEN_SORA":
            return TV.MicroFrameVAE(
                TS.SDVAE(dataclasses.replace(TS.OPEN_SORA_SPATIAL_VAE, **narrow), device),
                TT.VAETemporal(TT.VAETemporalConfig(filters=8, num_res_blocks=1, groups=4),
                               device))
        return TS.SDVAE(dataclasses.replace(getattr(TS, preset), **narrow), device)

    card = build(dev).init(torch.Generator(device=dev).manual_seed(0))
    cpu = build("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    g = torch.Generator().manual_seed(1)
    if preset == "OPEN_SORA":
        z = torch.randn((1, 7, 6, 10, 4), generator=g)      # 17 + 8 frames
        x = torch.rand((1, 9, 48, 80, 3), generator=g) * 2 - 1
    else:
        c = card.cfg.z_channels
        z = card.to_latent(torch.randn((2, 3, 6, 10, c), generator=g))
        x = torch.rand((2, 48, 80, 3), generator=g) * 2 - 1
    want, got = cpu.decode(z), card.decode(z.to(dev))
    assert got.device.type == dev.type and got.shape == want.shape
    assert float((got.cpu() - want).abs().max() / want.abs().max()) < 1e-4
    enc = (lambda m, v: m.encode(v)) if preset == "OPEN_SORA" else (
        lambda m, v: m.encode(v)[0])
    want, got = enc(cpu, x), enc(card, x.to(dev))
    assert float((got.cpu() - want).abs().max() / want.abs().max()) < 1e-4
