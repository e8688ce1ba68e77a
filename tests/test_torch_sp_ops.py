"""The sequence-parallel layer of the port against the JAX package, on the
CPU: the plain versions of K1b, K1c and K3p against the Pallas kernels in
interpret mode, the collectives under local ranks (threads of this process)
against the JAX functions on the virtual-device mesh, ``attention()``'s
choice of strategy, and the error paths (a failing rank ends the run).
Same seeded numpy inputs on both sides.
"""

import importlib
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.ops import fused_prologue as jfp
from magcache_tpu.parallel import collectives as jcoll
from magcache_tpu.parallel.mesh import build_mesh
from magcache_tpu_torch.ops import attention as tattn
from magcache_tpu_torch.ops import fused_prologue as tfp
from magcache_tpu_torch.parallel import collectives as tcoll
from magcache_tpu_torch.parallel.mesh import (LocalGroup, MeshPlan, init_distributed,
                                              run_local_ranks)

jattn = importlib.import_module("magcache_tpu.ops.attention")


def _both(a: np.ndarray, dtype: str):
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _qkv(rng, shape_q, shape_kv, dtype="float32"):
    return [_both(rng.standard_normal(s), dtype) for s in (shape_q, shape_kv, shape_kv)]


# f32: the same rounding points on both sides, only the f32 summation order
# differs (blocked online softmax against whole rows) -> the JAX test's own
# 2e-5. bf16: a rounding of p or of the output may flip at a tie -> 1e-2.
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("fixed_max", [None, 8.0])
def test_k1b_plain_matches_pallas_interpret(dtype, tol, fixed_max):
    rng = np.random.default_rng(0)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, (1, 2, 96, 64), (1, 2, 80, 64), dtype)
    want = jattn.flash_attention_bhsd(qj, kj, vj, kv_len=70, fixed_max=fixed_max,
                                      interpret=True)
    got = tattn.flash_attention_bhsd(qt, kt, vt, kv_len=70, fixed_max=fixed_max)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_k1b_plain_reads_head_major_views_and_equals_k1_plain():
    # the layout is the only difference between K1 and K1b
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 150, 3, 32, generator=g) for _ in range(3))
    want = tattn.flash_attention_bshd_plain(q, k, v, fixed_max=16.0)
    got = tattn.flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), fixed_max=16.0)
    torch.testing.assert_close(got.transpose(1, 2), want, atol=0, rtol=0)


# o as K1b; m is a max (exact up to the f32 product's summation order), l a
# sum of at most 128 terms -> the JAX test's own 2e-5 / 1e-5 / 1e-5. bf16:
# o rounds to bf16 (1e-2); m and l stay f32 but see bf16-rounded inputs on
# both sides alike.
@pytest.mark.parametrize("dtype,otol", [("float32", 2e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("kv_len", [None, 100])
def test_k1c_plain_matches_pallas_interpret(dtype, otol, kv_len):
    rng = np.random.default_rng(6)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, (1, 2, 128, 32), (1, 2, 128, 32), dtype)
    o_j, m_j, l_j = jattn.flash_attention_bhsd_aux(qj, kj, vj, kv_len=kv_len,
                                                  interpret=True)
    o, m, l = tattn.flash_attention_bhsd_aux(qt, kt, vt, kv_len=kv_len)
    assert o.dtype == qt.dtype and m.dtype == l.dtype == torch.float32
    assert m.shape == l.shape == (1, 2, 128)
    np.testing.assert_allclose(_np(o), _np(o_j), atol=otol, rtol=otol)
    np.testing.assert_allclose(_np(m), _np(m_j), atol=1e-5)
    np.testing.assert_allclose(_np(l), _np(l_j), rtol=1e-5)


def test_k1c_state_reproduces_the_softmax():
    # (m, l) are the natural-base max and normaliser of the scaled scores
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 40, 16)).astype(np.float32))
               for _ in range(3))
    o, m, l = tattn.flash_attention_bhsd_aux(q, k, v)
    s = (q @ k.transpose(2, 3)) * 16 ** -0.5
    torch.testing.assert_close(m, s.amax(-1), atol=1e-5, rtol=0)
    torch.testing.assert_close(l, torch.exp(s - s.amax(-1, keepdim=True)).sum(-1),
                               atol=0, rtol=1e-5)
    torch.testing.assert_close(o, torch.softmax(s, -1) @ v, atol=2e-5, rtol=0)


# K3p: the two-pass f32 LayerNorm, one rounding at the store on both sides.
# bf16: a tie may round differently after a differently ordered f32 sum
# (K3's own 2e-2); f32: summation order only, 1e-5.
@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 1e-5)])
def test_k3p_plain_matches_pallas_interpret(dtype, tol):
    rng = np.random.default_rng(4)
    xj, xt = _both(rng.standard_normal((2, 300, 256)) * 2, dtype)
    want = jfp.layer_norm_mod(xj, eps=1e-6, interpret=True, block_s=128)
    got = tfp.layer_norm_mod(xt, eps=1e-6)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0)


def test_layer_norm_mod_refuses_both_modes_at_once():
    x = torch.zeros(1, 4, 8)
    w = torch.ones(8)
    with pytest.raises(ValueError, match="separate modes"):
        tfp.layer_norm_mod(x, weight=w, bias=w, scale=w[None], shift=w[None])


def _shard(x, sp, dim=1):
    return list(torch.from_numpy(np.asarray(x)).chunk(sp, dim=dim))


def _local(sp, fn):
    """Runs ``fn(plan)`` on ``sp`` local ranks with a short barrier timeout."""
    return run_local_ranks(sp, fn, timeout=30.0)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("kv_replicated", [False, True])
def test_ulysses_attention_matches_jax_mesh_and_single_rank(sp, kv_replicated):
    rng = np.random.default_rng(0)
    b, s, h, d = 2, 16, 4, 32
    skv = 8 if kv_replicated else s
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((b, s, h, d), (b, skv, h, d), (b, skv, h, d)))
    want = jcoll.ulysses_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   build_mesh(dp=1, sp=sp, tp=1),
                                   kv_replicated=kv_replicated, kv_len=skv - 1)
    single = tattn.flash_attention_bshd_plain(*(torch.from_numpy(t) for t in (q, k, v)),
                                              kv_len=skv - 1)

    def rank(plan):
        ql = tcoll.split_sequence(torch.from_numpy(q), plan)
        kl, vl = (torch.from_numpy(t) if kv_replicated
                  else tcoll.split_sequence(torch.from_numpy(t), plan) for t in (k, v))
        out = tcoll.ulysses_attention(ql, kl, vl, plan, kv_replicated=kv_replicated,
                                      kv_len=skv - 1)
        assert out.shape == (b, s // sp, h, d)
        return out

    got = torch.cat(_local(sp, rank), dim=1)
    # f32, summation order only: the JAX collectives test's own 2e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), single.numpy(), atol=2e-5)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_matches_jax_mesh_and_single_rank(sp):
    rng = np.random.default_rng(5)
    b, s, h, d = 1, 32, 4, 16
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    want = jcoll.ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                build_mesh(dp=1, sp=sp, tp=1))
    single = tattn.flash_attention_bshd_plain(*(torch.from_numpy(t) for t in (q, k, v)))

    def rank(plan):
        return tcoll.ring_attention(
            *(tcoll.split_sequence(torch.from_numpy(t), plan) for t in (q, k, v)), plan)

    got = torch.cat(_local(sp, rank), dim=1)
    # f32 partials merged in f32: the JAX ring test's own 3e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)
    np.testing.assert_allclose(got.numpy(), single.numpy(), atol=3e-5)


def test_ring_attention_bf16_merge_error_is_bounded():
    # o is rounded to bf16 at each of the sp - 1 merges: each costs at most
    # half a bf16 ulp of |o| < 1 -> within (sp - 1) * 2^-9 + K1's own 1e-2
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 64, 2, 32)).astype(np.float32))
               .bfloat16() for _ in range(3))
    single = tattn.flash_attention_bshd_plain(q, k, v)
    got = torch.cat(_local(4, lambda plan: tcoll.ring_attention(
        *(tcoll.split_sequence(t, plan) for t in (q, k, v)), plan)), dim=1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(single), atol=1e-2 + 3 * 2 ** -9)


def test_all_to_all_switch_roundtrip_and_layout():
    sp = 4
    x = torch.arange(4 * 8 * 16 * 6, dtype=torch.float32).reshape(4, 8, 16, 6)

    def rank(plan):
        xs = tcoll.split_sequence(x, plan, 1)                   # [4, 2, 16, 6]
        y = tcoll.all_to_all_switch(xs, plan, scatter_dim=2, gather_dim=1)
        # now sharded along dim 2, whole along dim 1, as the JAX switch leaves it
        torch.testing.assert_close(y, tcoll.split_sequence(x, plan, 2), atol=0, rtol=0)
        z = tcoll.all_to_all_switch(y, plan, scatter_dim=1, gather_dim=2)
        torch.testing.assert_close(z, xs, atol=0, rtol=0)
        return z

    np.testing.assert_array_equal(torch.cat(_local(sp, rank), dim=1).numpy(), x.numpy())


def test_split_gather_sequence_identity_and_group_collectives():
    x = torch.arange(2 * 16 * 8, dtype=torch.float32).reshape(2, 16, 8)

    def rank(plan):
        xs = tcoll.split_sequence(x, plan)
        assert xs.shape == (2, 4, 8)
        g = plan.group
        shifted = g.ring_shift(torch.tensor([float(plan.rank)]))
        total = g.all_reduce_sum(torch.tensor([1.0, float(plan.rank)]))
        return tcoll.gather_sequence(xs, plan), float(shifted), total

    for r, (xg, shifted, total) in enumerate(_local(4, rank)):
        np.testing.assert_array_equal(xg.numpy(), x.numpy())
        assert shifted == (r - 1) % 4                 # shard j goes to rank j + 1
        assert total.tolist() == [4.0, 6.0]


def _spy_plan_calls(monkeypatch):
    calls = {"ring": 0, "ulysses": 0}
    lock = threading.Lock()
    for name in calls:
        orig = getattr(tcoll, f"{name}_attention")

        def spy(*a, _name=name, _orig=orig, **kw):
            with lock:
                calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(tcoll, f"{name}_attention", spy)
    return calls


def test_attention_selects_ring_and_ulysses_as_jax_does(monkeypatch):
    calls = _spy_plan_calls(monkeypatch)
    rng = np.random.default_rng(0)
    sp = 4
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 128, 8, 16)).astype(np.float32))
               for _ in range(3))
    ctx = torch.from_numpy(rng.standard_normal((1, 24, 8, 16)).astype(np.float32))

    def run(**kw):
        def rank(plan):
            ql, kl, vl = (tcoll.split_sequence(t, plan) for t in (q, k, v))
            return tattn.attention(ql, kl, vl, plan=plan, **kw)
        return torch.cat(_local(sp, rank), dim=1)

    out_ring = run(ring_threshold=64)              # 128 global tokens >= 64 -> ring
    assert calls == {"ring": sp, "ulysses": 0}
    out_uly = run(ring_threshold=100000)           # below the threshold -> Ulysses
    assert calls == {"ring": sp, "ulysses": sp}
    run(sp_impl="ring", ring_threshold=100000)     # forced
    assert calls["ring"] == 2 * sp
    run(sp_impl="ulysses", ring_threshold=1)       # forced the other way
    assert calls["ulysses"] == 2 * sp
    np.testing.assert_allclose(out_ring.numpy(), out_uly.numpy(), rtol=2e-4, atol=2e-4)

    # replicated k/v (cross-attention) never takes the ring, even when forced
    def cross(plan):
        return tattn.attention(tcoll.split_sequence(q, plan), ctx, ctx, plan=plan,
                               sp_impl="ring")
    got = torch.cat(_local(sp, cross), dim=1)
    assert calls == {"ring": 2 * sp, "ulysses": 3 * sp}
    np.testing.assert_allclose(
        got.numpy(), tattn.flash_attention_bshd_plain(q, ctx, ctx).numpy(), atol=2e-5)


def test_attention_sp_impl_needs_a_plan():
    q = torch.zeros(1, 8, 2, 4)
    for impl in ("ring", "ulysses"):
        with pytest.raises(ValueError, match="needs a mesh plan"):
            tattn.attention(q, q, q, sp_impl=impl)
    with pytest.raises(ValueError, match="sp_impl must be one of"):
        tattn.attention(q, q, q, sp_impl="tree")


def test_uneven_shards_raise():
    q3 = torch.zeros(1, 8, 3, 4)            # 3 heads over sp = 2
    with pytest.raises(ValueError, match="heads do not divide"):
        _local(2, lambda plan: tcoll.ulysses_attention(q3, q3, q3, plan))
    x = torch.zeros(1, 9, 4)                # 9 tokens over sp = 2
    with pytest.raises(ValueError, match="does not divide by sp"):
        _local(2, lambda plan: tcoll.split_sequence(x, plan))
    with pytest.raises(ValueError, match="does not divide by the group size"):
        _local(2, lambda plan: plan.group.all_to_all(x, 1, 2))


def test_a_failing_rank_ends_the_run_with_its_exception():
    x = torch.ones(2, 4)

    def rank(plan):
        plan.group.all_gather(x, 0)
        if plan.rank == 1:
            raise RuntimeError("rank 1 broke")
        for _ in range(3):                   # the others would wait here for ever
            plan.group.all_gather(x, 0)
        return True

    t0 = time.time()
    with pytest.raises(RuntimeError, match="rank 1 broke"):
        run_local_ranks(4, rank, timeout=60.0)
    assert time.time() - t0 < 30.0           # aborted, not timed out


def test_a_stuck_rank_times_out():
    x = torch.ones(1)

    def rank(plan):
        if plan.rank == 0:
            return None                      # skips the collective the others enter
        return plan.group.all_gather(x, 0)

    t0 = time.time()
    with pytest.raises(TimeoutError, match="waited longer"):
        run_local_ranks(2, rank, timeout=1.0)
    assert time.time() - t0 < 30.0


def test_plan_and_group_surface():
    plan = run_local_ranks(1, lambda p: p)[0]
    assert isinstance(plan, MeshPlan) and isinstance(plan.group, LocalGroup)
    assert (plan.sp, plan.rank) == (1, 0)
    assert plan.shard_len(12) == 12
    x = torch.arange(6.0).reshape(1, 6, 1)
    # one rank: every collective is the identity
    torch.testing.assert_close(plan.group.all_to_all(x, 1, 2), x)
    torch.testing.assert_close(plan.group.ring_shift(x), x)
    with pytest.raises(ValueError, match="needs world_size and rank"):
        init_distributed("tcp://localhost:1")
