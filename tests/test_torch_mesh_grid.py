"""The port's (dp, sp, tp) rank grid on the CPU: local ranks (threads taking
turns over the whole grid) with a group per axis line, the world order of
JAX ``build_mesh`` (tp innermost), every collective on sub-groups, sp and tp
collectives interleaved, a deadlock named, a raising rank and the timeout.
"""

import threading
import time

import numpy as np
import pytest
import torch

from magcache_tpu_torch.parallel.mesh import MeshPlan, SoloGroup, grid_rank, run_local_ranks

DP, SP, TP = 2, 2, 2


def _coords(world_rank):
    t = world_rank % TP
    s = (world_rank // TP) % SP
    return world_rank // (SP * TP), s, t


def test_world_order_is_the_jax_mesh_reshape():
    jax_order = np.arange(DP * SP * TP).reshape(DP, SP, TP)
    outs = run_local_ranks(SP, lambda plan: (plan.world_rank, plan.dp_rank, plan.rank,
                                             plan.tp_rank, plan.describe()), dp=DP, tp=TP)
    for w, (rank, d, s, t, desc) in enumerate(outs):
        assert rank == w == jax_order[d, s, t] == grid_rank(d, s, t, SP, TP)
        assert desc == "dp 2 x sp 2 x tp 2"


def test_sub_group_collectives_on_the_2x2x2_grid():
    def rank(plan):
        w = plan.world_rank
        x = torch.full((2, 3), float(w))
        return (plan.tp_group.all_gather(x, 0), plan.group.all_gather(x, 1),
                plan.dp_group.all_reduce_sum(x.to(torch.bfloat16)),
                plan.tp_group.all_to_all(torch.arange(4.0)[:, None] + 10 * w, 0, 1),
                plan.group.ring_shift(x))

    outs = run_local_ranks(SP, rank, dp=DP, tp=TP, timeout=30.0)
    for w, (tp_g, sp_g, dp_sum, a2a, ring) in enumerate(outs):
        d, s, t = _coords(w)
        tp_peers = [grid_rank(d, s, j, SP, TP) for j in range(TP)]
        sp_peers = [grid_rank(d, j, t, SP, TP) for j in range(SP)]
        dp_peers = [grid_rank(j, s, t, SP, TP) for j in range(DP)]
        torch.testing.assert_close(tp_g, torch.cat([torch.full((2, 3), float(p))
                                                    for p in tp_peers]))
        torch.testing.assert_close(sp_g, torch.cat([torch.full((2, 3), float(p))
                                                    for p in sp_peers], 1))
        assert dp_sum.dtype == torch.float32        # summed in one f32 buffer
        torch.testing.assert_close(dp_sum, torch.full((2, 3), float(sum(dp_peers))))
        want = torch.cat([torch.arange(4.0)[2 * t:2 * t + 2, None] + 10 * p
                          for p in tp_peers], 1)
        torch.testing.assert_close(a2a, want)
        torch.testing.assert_close(ring, torch.full((2, 3), float(sp_peers[(s - 1) % SP])))


def test_sp_only_call_and_solo_axes_keep_working():
    outs = run_local_ranks(2, lambda plan: (plan.sp, plan.tp, plan.dp,
                                            plan.group.all_gather(torch.ones(1), 0).sum()))
    assert outs == [(2, 1, 1, torch.tensor(2.0))] * 2
    plan = run_local_ranks(1, lambda p: p)[0]      # every axis a local group of one
    assert (plan.world, plan.world_rank, plan.tp_group.size) == (1, 0, 1)
    plan = MeshPlan(SoloGroup())
    assert (plan.world, plan.world_rank) == (1, 0)
    torch.testing.assert_close(plan.tp_group.all_reduce_sum(torch.ones(2)), torch.ones(2))


def test_tp_and_sp_collectives_interleave_without_deadlock():
    """Ranks alternate tp all-reduces and sp all-gathers for many rounds,
    the order of calls differing by tp rank: each group's rounds stay its
    own, and a rank whose round is incomplete hands the turn on."""
    def rank(plan):
        acc = torch.zeros(1)
        for i in range(12):
            x = torch.tensor([float(plan.world_rank + i)])
            if plan.tp_rank == 0:
                acc += plan.tp_group.all_reduce_sum(x) + plan.group.all_gather(x, 0).sum()
            else:
                acc += plan.group.all_gather(x, 0).sum() + plan.tp_group.all_reduce_sum(x)
        return float(acc)

    outs = run_local_ranks(SP, rank, dp=DP, tp=TP, timeout=30.0)
    for w, got in enumerate(outs):
        d, s, t = _coords(w)
        tp_peers = [grid_rank(d, s, j, SP, TP) for j in range(TP)]
        sp_peers = [grid_rank(d, j, t, SP, TP) for j in range(SP)]
        assert got == sum(sum(p + i for p in tp_peers) + sum(p + i for p in sp_peers)
                          for i in range(12))


def test_mismatched_collectives_time_out_naming_each_wait():
    """Ranks 0 and 2 enter a tp collective their tp peers never join: the
    turn goes round with no rank able to move, and the run ends at the
    timeout (no spinning meanwhile) naming where each rank waits."""
    def rank(plan):
        if plan.tp_rank == 0:
            return plan.tp_group.all_gather(torch.zeros(1), 0)
        return plan.group.all_gather(torch.zeros(1), 0)

    t0 = time.process_time()
    with pytest.raises(TimeoutError, match=r"no rank could move: rank 0: tp group "
                                           r"\(dp 0, sp 0\) round 0; rank 2: tp group"):
        run_local_ranks(2, rank, tp=2, timeout=1.0)
    assert time.process_time() - t0 < 0.5  # the ranks waited; they did not spin


def test_a_raising_rank_ends_every_rank_of_the_grid():
    def rank(plan):
        plan.tp_group.all_reduce_sum(torch.ones(1))
        if plan.world_rank == 5:
            raise KeyError("rank 5 failed")
        for _ in range(4):
            plan.dp_group.all_gather(torch.ones(1), 0)
        return plan.world_rank

    with pytest.raises(KeyError, match="rank 5 failed"):
        run_local_ranks(SP, rank, dp=DP, tp=TP, timeout=30.0)
    assert threading.active_count() < 4     # no rank left behind


def test_a_rank_that_holds_the_turn_past_the_timeout_ends_the_run():
    def rank(plan):
        if plan.world_rank == 1:
            time.sleep(1.5)
        return plan.tp_group.all_reduce_sum(torch.ones(1))

    with pytest.raises(TimeoutError, match="longer than 0.5 s"):
        run_local_ranks(1, rank, tp=2, dp=2, timeout=0.5)
