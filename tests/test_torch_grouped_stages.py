"""K5's "prepass" route (groups of more than 16 tokens with gains or RoPE)
as its two stages, in plain PyTorch on the CPU, against the JAX package's
Pallas kernel (``interpret=True``) and the port's one-stage plain version.

On a CUDA tensor such a call is two launches: ``qk_norm_kernel`` writes q^
(RMS-normed with the gains, rotated at the in-group position, times
scale*log2(e), rounded once) and k^ (normed, rotated, rounded), then the
wgmma/TMA body runs at q_scale 1 with v read in place. Their plain versions
are ``qk_norm_plain`` (with ``rope_tables`` and ``group``) and
``grouped_attention_prescaled_plain``. Composed, they must keep the rounding
points of ``magcache_tpu/ops/attention.py:_grouped_kernel`` (norm, RoPE in
f32, q * scale_log2e rounded once, k rounded): within the JAX K5 parity
tests' own bound of the Pallas kernel (``tests/test_torch_stdit3_ops.py``:
2e-2 in bf16, 1e-5 in f32), and equal to ``grouped_attention_fused_qkv_plain``
in f32. Sizes are small: 2 heads of 72, groups of 40 with 40 or 33 valid
keys.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu_torch.ops import attention as TA
from magcache_tpu_torch.ops.rope import grouped_rope_tables

JA = importlib.import_module("magcache_tpu.ops.attention")

D, DP = 72, 128
HEADS, GROUP, ROWS = 2, 40, 3
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (gains, rope, fixed max): the fixed shift needs the norm's bound
CASES = [(True, False, JA.QKNORM_FIXED_MAX),   # K5 spatial: gains, fixed max
         (True, True, None),                   # gains + RoPE, row max
         (False, True, None)]                  # RoPE without gains


def _inputs(seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((ROWS, GROUP, 3 * HEADS * D)) * 1.5
    gains = (1.0 + 0.2 * rng.standard_normal((HEADS, D)),
             1.0 + 0.2 * rng.standard_normal((HEADS, D)))
    return qkv, gains


def _jax(qkv, gains, rope, gvalid, fixed_max, jd):
    """The Pallas kernel on heads zero-padded to 128 lanes (true_d 72),
    one group a block."""
    lead = qkv.shape[:-1]
    padded = np.pad(qkv.reshape(lead + (3 * HEADS, D)), [(0, 0), (0, 0), (0, 0), (0, DP - D)])
    tables = None
    if rope:
        cos, sin = grouped_rope_tables(GROUP, GROUP, D)
        cp, sp = np.ones((GROUP, DP), np.float32), np.zeros((GROUP, DP), np.float32)
        cp[:, :D], sp[:, :D] = np.repeat(cos, 2, -1), np.repeat(sin, 2, -1)
        tables = (jnp.asarray(cp), jnp.asarray(sp))
    jg = None
    if gains is not None:
        jg = tuple(jnp.asarray(np.pad(g, ((0, 0), (0, DP - D))), jnp.float32) for g in gains)
    out = JA.grouped_attention_fused_qkv(
        jnp.asarray(padded.reshape(1, ROWS * GROUP, -1).astype(np.float32), jd), HEADS,
        group=GROUP, group_valid=gvalid, block=GROUP, scale=1.0 / np.sqrt(D), qk_gains=jg,
        rope_tables=tables, true_d=D, eps=1e-6, fixed_max=fixed_max, interpret=True)
    out = np.asarray(out, np.float32).reshape(ROWS, GROUP, HEADS, DP)[..., :D]
    return out.reshape(ROWS, GROUP, HEADS * D)


def _stages(qkv, gains, rope, gvalid, fixed_max, td):
    """The two stages as the card runs them, on column views of one fused
    ``[B, S, 3*H*72]`` projection; one group a batch row."""
    t = torch.from_numpy(qkv.astype(np.float32)).to(td)
    q, k, v = TA.split_qkv(t, HEADS)
    tables = tuple(torch.from_numpy(a) for a in grouped_rope_tables(GROUP, GROUP, D)) \
        if rope else None
    tg = tuple(torch.from_numpy(g.astype(np.float32)) for g in gains) \
        if gains is not None else None
    qn, kn = TA.qk_norm_plain(q, k, tg, scale=1.0 / np.sqrt(D), true_d=D, eps=1e-6,
                              dtype=v.dtype, rope_tables=tables, group=GROUP)
    assert qn.is_contiguous() and kn.is_contiguous() and qn.dtype == td
    out = TA.grouped_attention_prescaled_plain(qn, kn, v, group=GROUP, group_valid=gvalid,
                                               fixed_max=fixed_max)
    return out.reshape(ROWS, GROUP, HEADS * D), (t, tg, tables)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("gvalid", [GROUP, 33])
@pytest.mark.parametrize("with_gains,rope,fixed_max", CASES)
def test_k5_prepass_stages_match_jax_kernel(dtype, gvalid, with_gains, rope, fixed_max):
    jd, td = DTYPES[dtype]
    qkv, gains = _inputs(41)
    gains = gains if with_gains else None
    want = _jax(qkv, gains, rope, gvalid, fixed_max, jd)
    got, _ = _stages(qkv, gains, rope, gvalid, fixed_max, td)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


@pytest.mark.parametrize("gvalid", [GROUP, 33])
@pytest.mark.parametrize("with_gains,rope,fixed_max", CASES)
def test_k5_prepass_stages_compose_to_the_one_stage_plain(gvalid, with_gains, rope,
                                                          fixed_max):
    """f32: the split keeps the one-stage version's rounding points and
    operations, so the two agree to the last bit."""
    qkv, gains = _inputs(42)
    gains = gains if with_gains else None
    got, (t, tg, tables) = _stages(qkv, gains, rope, gvalid, fixed_max, torch.float32)
    want = TA.grouped_attention_fused_qkv_plain(
        t.reshape(1, ROWS * GROUP, -1), HEADS, group=GROUP, group_valid=gvalid,
        scale=1.0 / np.sqrt(D), qk_gains=tg, rope_tables=tables, true_d=D, eps=1e-6,
        fixed_max=fixed_max)
    torch.testing.assert_close(got, want.reshape(got.shape), atol=0, rtol=0)


def test_prepass_rope_positions_restart_every_group():
    """q^ of a token at in-group position p equals the rotation by p of its
    normed value, whatever the group it sits in."""
    qkv, gains = _inputs(43)
    t = torch.from_numpy(qkv.astype(np.float32))
    q, k, _ = TA.split_qkv(t.reshape(1, ROWS * GROUP, -1), HEADS)
    tables = tuple(torch.from_numpy(a) for a in grouped_rope_tables(GROUP, GROUP, D))
    tg = tuple(torch.from_numpy(g.astype(np.float32)) for g in gains)
    qn, _ = TA.qk_norm_plain(q, k, tg, scale=1.0, true_d=D, rope_tables=tables, group=GROUP)
    for r in range(ROWS):
        one, _ = TA.qk_norm_plain(q[:, r * GROUP:(r + 1) * GROUP], k[:, :GROUP], tg,
                                  scale=1.0, true_d=D, rope_tables=tables, group=GROUP)
        assert torch.equal(qn[:, r * GROUP:(r + 1) * GROUP], one)
