"""Every Wan task, solver and cache policy under sequence parallelism on the
CPU, in f32, at tiny widths: 2 and 4 local ranks (threads of this process),
Ulysses and ring, each held against the port's single-rank run.

- i2v (the CLIP branch and the ``y`` concat) and flf2v forwards;
- VACE forwards, and an R2V request (a reference frame lengthens the grid);
- the per-token timestep's t = 0 prefix on rank 0 only, spanning two ranks
  and covering a whole rank (each rank's share of it is checked);
- the A14B two-expert MoE request;
- dpm++, Euler, rolling and TeaCache requests, dpm++ and Euler calibration,
  and the per-request overrides;
- ``generate_batch`` under sp, and the refusal that stays: a token count
  with R2V frames that does not divide by ``sp``.

One case per model construct (i2v, VACE, the prefix, the MoE, TeaCache) is
also held against the JAX package under ``use_mesh`` with the same ``sp``,
on the conftest's virtual CPU devices. The JAX side's shapes are pinned with
``WanConfig.tiny`` and ``model_cfg_override``.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.models import wan as jwan
from magcache_tpu.parallel.mesh import (MeshPlan as JMeshPlan, activation_sharding,
                                        build_mesh, shard_params, use_mesh)
from magcache_tpu.pipelines import wan as jpipe
from magcache_tpu.utils.misc import set_seed as j_set_seed
from magcache_tpu_torch.models import wan as twan
from magcache_tpu_torch.models.convert import wan_params_from_numpy
from magcache_tpu_torch.parallel.mesh import run_local_ranks
from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

# f32 on both sides; the sharded attentions and the smaller GEMMs only
# reorder f32 sums (tests/test_torch_sp_wan.py's tolerance)
TOL = 2e-4
# calibration statistics from all-reduced f32 sums; cos distances near 0
# need an absolute floor (tests/test_torch_sp_wan.py's calibration tolerance)
CAL_ATOL, CAL_RTOL = 1e-5, 1e-4
PLANS = [(2, "ulysses"), (2, "ring"), (4, "ulysses"), (4, "ring")]
PLAN_IDS = [f"sp{sp}-{impl}" for sp, impl in PLANS]
I2V = dict(model_type="i2v", in_channels=36, clip_dim=32, clip_tokens=17)
VACE = dict(vace_layers=(0, 1))
PROMPT = "a corgi surfs a wave"


def _rng(seed):
    return np.random.default_rng(seed)


def _numpy_params(cfg, seed):
    """A JAX Wan tree drawn with numpy: kernels ``N(0, 1/fan_in)``, vectors
    ``1 + 0.1 N(0, 1)``."""
    rng = _rng(seed)

    def draw(s):
        if len(s.shape) <= 1:
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree.map(draw, jax.eval_shape(lambda k: jwan.init_wan_params(k, cfg),
                                             jax.random.PRNGKey(0)))


def _models(cfg_kw, seed=0):
    jcfg, tcfg = jwan.WanConfig.tiny(**cfg_kw), twan.WanConfig.tiny(**cfg_kw)
    params = _numpy_params(jcfg, seed)
    model = twan.WanModel(tcfg, "cpu")
    model.load_state_dict(wan_params_from_numpy(params, tcfg, "cpu"))
    return jcfg, params, model


def _ranks(sp, fn):
    """``fn(plan)`` on ``sp`` local ranks; every rank's tensor output is
    the same bits (each gathers the whole sequence). Returns rank 0's."""
    outs = run_local_ranks(sp, fn, timeout=60.0)
    for r, out in enumerate(outs[1:], 1):
        assert torch.equal(out, outs[0]), f"rank {r} differs from rank 0"
    return outs[0]


def _forward(model, grid, x, t, cond, plan=None, sp_impl="auto"):
    core = twan.make_wan_core(model, grid, plan, sp_impl=sp_impl)
    hidden, ctx = core.prepare(x, t, cond)
    if plan is not None:
        assert hidden.shape[1] == grid[0] * grid[1] * grid[2] // plan.sp
    return core.head(core.trunk(hidden, ctx), ctx)


def _jax_forward(jcfg, params, grid, x, t, cond, sp):
    """The JAX forward under ``use_mesh`` on an ``sp``-way mesh, its inputs
    placed as the JAX pipeline places them."""
    core = jwan.make_wan_core(jcfg, grid)

    def fwd(p, xx, cc):
        hidden, ctx = core.prepare(p, xx, jnp.asarray(t), cc)
        return core.head(p, core.trunk(p, hidden, ctx), ctx)

    mesh = build_mesh(dp=1, sp=sp, tp=1)
    xs = jax.device_put(jnp.asarray(x), activation_sharding(mesh, "latents", x.ndim))
    cs = {k: (jax.device_put(jnp.asarray(v), activation_sharding(mesh, "context", v.ndim))
              if v.ndim >= 3 else jnp.asarray(v)) for k, v in cond.items()}
    with use_mesh(JMeshPlan(mesh)):
        return np.asarray(jax.jit(fwd)(shard_params(params, mesh), xs, cs))


def _image_inputs(cfg, grid, seed):
    rng = _rng(seed)
    f, h, w = grid
    lat = (2, f, 2 * h, 2 * w)
    x = rng.standard_normal(lat + (16,)).astype(np.float32)
    cond = {"context": rng.standard_normal((2, cfg.text_len, cfg.text_dim)).astype(np.float32),
            "y": rng.standard_normal(lat + (20,)).astype(np.float32),
            "clip_fea": rng.standard_normal((2, cfg.clip_tokens, cfg.clip_dim)
                                            ).astype(np.float32)}
    return x, np.array([900.0, 250.0], np.float32), cond


def _vace_inputs(cfg, grid, seed):
    rng = _rng(seed)
    f, h, w = grid
    lat = (2, f, 2 * h, 2 * w)
    return (rng.standard_normal(lat + (16,)).astype(np.float32),
            np.array([900.0, 250.0], np.float32),
            {"context": rng.standard_normal((2, cfg.text_len, cfg.text_dim)).astype(np.float32),
             "vace_context": rng.standard_normal(lat + (96,)).astype(np.float32)})


def _ti2v_inputs(cfg, grid, seed):
    rng = _rng(seed)
    f, h, w = grid
    x = rng.standard_normal((2, f, 2 * h, 2 * w, 16)).astype(np.float32)
    ctx = rng.standard_normal((2, cfg.text_len, cfg.text_dim)).astype(np.float32)
    return x, np.array([700.0, 700.0], np.float32), {"context": ctx, "ti2v_img": np.zeros(())}


def _torch(cond):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in cond.items()}


def _check_forward(model, grid, inputs, sp, impl, want=None):
    x, t, cond = inputs
    xt, tt, ct = torch.from_numpy(x), torch.from_numpy(t), _torch(cond)
    single = _forward(model, grid, xt, tt, ct)
    got = _ranks(sp, lambda plan: _forward(model, grid, xt, tt, ct, plan, impl))
    assert got.shape == x.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), single.numpy(), atol=TOL, rtol=TOL)
    if want is not None:
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


# ------------------------------------------------------------- model level
@pytest.mark.parametrize("task", ["i2v", "flf2v"])
@pytest.mark.parametrize("sp,impl", PLANS, ids=PLAN_IDS)
def test_image_task_forwards_under_sp_match_single_rank(task, sp, impl):
    """``y`` rides x's channels into the patchify, so the rank's rows carry
    it; the [image; text] context stays whole on every rank."""
    kw = dict(I2V, clip_tokens=34) if task == "flf2v" else I2V
    _, _, model = _models(kw, seed=1)
    _check_forward(model, (2, 4, 4), _image_inputs(model.cfg, (2, 4, 4), 2), sp, impl)


@pytest.mark.parametrize("refs", [0, 1], ids=["plain", "r2v-frame"])
@pytest.mark.parametrize("sp,impl", PLANS, ids=PLAN_IDS)
def test_vace_forwards_under_sp_match_single_rank(refs, sp, impl):
    """The VACE context is embedded on the rank's rows and its blocks run
    on the trunk's plan; an R2V reference is one more leading latent frame."""
    _, _, model = _models(VACE, seed=3)
    grid = (2 + refs, 4, 4)
    _check_forward(model, grid, _vace_inputs(model.cfg, grid, 4), sp, impl)


# (grid, sp): the t = 0 prefix is latent frame 0's H*W tokens
PREFIX_CASES = {
    "rank-0-only": ((3, 2, 4), 2),            # 8 of rank 0's 12 rows
    "rank-0-only-sp4": ((5, 2, 4), 4),        # 8 of rank 0's 10 rows
    "spans-two-ranks": ((3, 2, 4), 4),        # rank 0's 6 rows and 2 of rank 1's
    "covers-a-whole-rank": ((2, 4, 4), 2),    # exactly rank 0's 16 rows
}


@pytest.mark.parametrize("impl", ["ulysses", "ring"])
@pytest.mark.parametrize("case", list(PREFIX_CASES))
def test_per_token_timestep_under_sp_matches_single_rank(case, impl, monkeypatch):
    grid, sp = PREFIX_CASES[case]
    _, _, model = _models({}, seed=5)
    rows = grid[0] * grid[1] * grid[2] // sp
    n0 = grid[1] * grid[2]
    seen = {}
    forward = twan.WanBlock.forward

    def spy(self, x, e0, context, cos, sin, sp_args=None, n0_local=0):
        seen.setdefault(threading.current_thread().name, set()).add(n0_local)
        return forward(self, x, e0, context, cos, sin, sp_args, n0_local)

    monkeypatch.setattr(twan.WanBlock, "forward", spy)
    _check_forward(model, grid, _ti2v_inputs(model.cfg, grid, 6), sp, impl)
    # each rank's blocks take its own share of the global prefix
    for r in range(sp):
        assert seen[f"sp-rank-{r}"] == {min(max(n0 - r * rows, 0), rows)}, (r, seen)


@pytest.mark.parametrize("construct", ["i2v", "vace", "prefix"])
def test_model_constructs_under_sp_match_jax_mesh(construct):
    """Rank 0's output under 2 local ranks against the JAX forward under
    ``use_mesh`` on a 2-way ``sp`` mesh, the same weights and inputs (the
    prefix at a grid where it spans two ranks)."""
    if construct == "i2v":
        cfg_kw, grid, make = I2V, (2, 4, 4), _image_inputs
    elif construct == "vace":
        cfg_kw, grid, make = VACE, (3, 4, 4), _vace_inputs
    else:
        cfg_kw, grid, make = {}, (3, 2, 4), _ti2v_inputs
    jcfg, params, model = _models(cfg_kw, seed=7)
    x, t, cond = make(model.cfg, grid, 8)
    sp = 2 if construct != "prefix" else 4
    want = _jax_forward(jcfg, params, grid, x, t, cond, sp)
    _check_forward(model, grid, (x, t, cond), sp, "ulysses", want)


# ---------------------------------------------------------- pipeline level
def _pipe_kw(**kw):
    base = dict(tiny=True, size=(64, 32), frame_num=9, sample_steps=8, sample_shift=5.0,
                guide_scale=5.0, dtype="float32")
    base.update(kw)
    return base


def _noise(shape, seed=3):
    return np.asarray(jax.random.normal(j_set_seed(seed), (1,) + shape, jnp.float32))


def _port_pipes(cfg_kw, dit, dit_low=None, **kw):
    """``make(plan)``: the port's pipeline of ``kw`` on one rank (no plan)
    or on the plan's, all on one DiT (and low-noise expert)."""
    override = twan.WanConfig.tiny(**cfg_kw)

    def make(plan=None, sp_impl="auto"):
        sp = 1 if plan is None else plan.sp
        cfg = WanPipelineConfig(model_cfg_override=override, sp=sp, sp_impl=sp_impl, **kw)
        return WanPipeline(cfg, "cpu", model=dit, model_low=dit_low, plan=plan)
    return make


def _generate(pipe, x0, **gen_kw):
    pipe._initial_noise = lambda gen: torch.from_numpy(x0.copy())
    return pipe.generate(PROMPT, seed=3, **gen_kw)


def _check_request(make, x0, sp, impl, want_skips=None, **gen_kw):
    """The request on one rank and on ``sp`` ranks: latents within TOL,
    identical on every rank, realized skip bits equal on every rank and to
    the single rank's (and to ``want_skips``). Returns the single-rank
    output."""
    single = _generate(make(), x0, **gen_kw)
    outs = run_local_ranks(sp, lambda plan: _generate(make(plan, impl), x0, **gen_kw),
                           timeout=60.0)
    for r, out in enumerate(outs):
        assert torch.equal(out.latents, outs[0].latents), f"rank {r}'s latents differ"
        if single.skips is None:
            assert out.skips is None
        else:
            np.testing.assert_array_equal(out.skips, single.skips)
    if want_skips is not None:
        np.testing.assert_array_equal(single.skips, want_skips)
    np.testing.assert_allclose(outs[0].latents.numpy(), single.latents.numpy(),
                               atol=TOL, rtol=TOL)
    return single, outs


def _moe_models(cfg_kw):
    jcfg = jwan.WanConfig.tiny(**cfg_kw)
    trees = [_numpy_params(jcfg, s) for s in (20, 21)]
    experts = []
    for tree in trees:
        m = twan.WanModel(twan.WanConfig.tiny(**cfg_kw), "cpu")
        m.load_state_dict(wan_params_from_numpy(tree, m.cfg, "cpu"))
        experts.append(m)
    return jcfg, trees, experts


MOE_KW = _pipe_kw(model="wan2.2-t2v-A14B", task="t2v", guide_scale=(3.0, 4.0),
                  use_magcache=True)


@pytest.mark.parametrize("sp,impl", PLANS, ids=PLAN_IDS)
def test_moe_request_under_sp_matches_single_rank(sp, impl):
    """Both experts' cores are built on the plan; one carry crosses the
    switch on every rank."""
    _, _, (hi, lo) = _moe_models({})
    make = _port_pipes({}, hi, lo, **MOE_KW)
    x0 = _noise(make().latent_shape)
    single, _ = _check_request(make, x0, sp, impl)
    assert single.skips.sum() > 0


def test_moe_request_under_sp_matches_jax_mesh():
    jcfg, (hi_t, lo_t), (hi, lo) = _moe_models({})
    jp = jpipe.WanPipeline(jpipe.WanPipelineConfig(model_cfg_override=jcfg, sp=2, **MOE_KW),
                           params=hi_t, params_low=lo_t)
    assert jp.plan is not None
    want = np.asarray(jp.generate(PROMPT, seed=3).latents)
    make = _port_pipes({}, hi, lo, **MOE_KW)
    got = _ranks(2, lambda plan: _generate(make(plan, "ulysses"),
                                           _noise(jp.latent_shape)).latents)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


SOLVER_POLICIES = {
    "dpm++": dict(sample_solver="dpm++", use_magcache=True, magcache_thresh=0.3,
                  magcache_K=3),
    "euler": dict(sample_solver="euler", use_magcache=True, magcache_thresh=0.3,
                  magcache_K=3),
    "rolling": dict(cache_policy="rolling", use_magcache=True, magcache_thresh=0.12,
                    magcache_K=2, sample_steps=10),
    "teacache": dict(enable_teacache=True, teacache_thresh=1500.0, sample_steps=10),
}


@pytest.mark.parametrize("sp,impl", PLANS, ids=PLAN_IDS)
@pytest.mark.parametrize("kind", list(SOLVER_POLICIES))
def test_solver_and_policy_requests_under_sp_match_single_rank(kind, sp, impl):
    """The static schedules come from the host; TeaCache decides from the
    time embedding, whole and equal on every rank, so the ranks decide
    alike."""
    _, _, model = _models({}, seed=9)
    make = _port_pipes({}, model, **_pipe_kw(**SOLVER_POLICIES[kind]))
    x0 = _noise(make().latent_shape)
    want = None if kind == "teacache" else make().skip_mask_for()
    single, _ = _check_request(make, x0, sp, impl, want)
    assert single.skips.any()


def test_teacache_request_under_sp_matches_jax_mesh():
    kw = _pipe_kw(**SOLVER_POLICIES["teacache"])
    jcfg, params, model = _models({}, seed=9)
    jp = jpipe.WanPipeline(jpipe.WanPipelineConfig(model_cfg_override=jcfg, sp=2, **kw),
                           params=params)
    jp.record_skips = True
    assert jp.plan is not None
    want = jp.generate(PROMPT, seed=3)
    make = _port_pipes({}, model, **kw)
    outs = run_local_ranks(2, lambda plan: _generate(make(plan, "ulysses"),
                                                     _noise(jp.latent_shape)), timeout=60.0)
    for out in outs:
        np.testing.assert_array_equal(out.skips, np.asarray(want.skips))
        np.testing.assert_allclose(out.latents.numpy(), np.asarray(want.latents),
                                   atol=TOL, rtol=TOL)
    assert outs[0].skips.any()


@pytest.mark.parametrize("sp,impl", [(2, "ulysses"), (4, "ring")], ids=["sp2-ulysses", "sp4-ring"])
@pytest.mark.parametrize("solver", ["dpm++", "euler"])
def test_dpm_and_euler_calibration_under_sp_match_single_rank(solver, sp, impl):
    """The statistics' token means all-reduce over the ranks."""
    _, _, model = _models({}, seed=10)
    make = _port_pipes({}, model, **_pipe_kw(sample_solver=solver, magcache_calibration=True))
    single, outs = _check_request(make, _noise(make().latent_shape), sp, impl)
    assert len(single.calibration["norm_ratio"]) == 2 * (8 - 1)
    for out in outs:
        for name, vals in single.calibration.items():
            np.testing.assert_array_equal(out.calibration[name], outs[0].calibration[name])
            np.testing.assert_allclose(out.calibration[name], vals, atol=CAL_ATOL,
                                       rtol=CAL_RTOL)


@pytest.mark.parametrize("sp,impl", [(2, "ring"), (4, "ulysses")], ids=["sp2-ring", "sp4-ulysses"])
def test_request_overrides_under_sp_match_single_rank(sp, impl):
    """``skip_override`` (lane-asymmetric: half-batch trunk runs on the
    rank's rows) and ``mag_ratios_override``."""
    _, _, model = _models({}, seed=11)
    make = _port_pipes({}, model, **_pipe_kw(use_magcache=True))
    x0 = _noise(make().latent_shape)
    mask = np.zeros((8, 2), bool)
    mask[2, 0] = mask[4, 1] = mask[5] = True
    _check_request(make, x0, sp, impl, mask, skip_override=mask)
    ratios = tuple(np.linspace(1.0, 0.9, 2 * 7))
    make = _port_pipes({}, model, **_pipe_kw(use_magcache=True, mag_ratios_override=ratios,
                                             magcache_thresh=0.3))
    single, _ = _check_request(make, x0, sp, impl, make().skip_mask_for())
    assert single.skips.any()


@pytest.mark.parametrize("sp,impl", PLANS, ids=PLAN_IDS)
def test_vace_r2v_request_under_sp_matches_single_rank(sp, impl):
    _, _, model = _models(VACE, seed=12)
    make = _port_pipes(VACE, model, **_pipe_kw(model="wan2.1-vace-1.3B", task="vace",
                                              vace_ref_images=1, use_magcache=True))
    pipe = make()
    assert pipe.grid == (4, 2, 4)          # 3 latent frames and the reference's
    ctx = torch.from_numpy(_rng(13).standard_normal(
        (1,) + pipe.latent_shape[:3] + (96,)).astype(np.float32))
    single, outs = _check_request(make, _noise(pipe.latent_shape), sp, impl,
                                  vace_context=ctx)
    assert outs[0].latents.shape[1] == 3    # the reference frame trimmed


# ---------------------------------------------------------------- refusals
def test_refusals_that_stay_under_sp():
    _, _, model = _models(VACE, seed=12)
    make = _port_pipes(VACE, model, **_pipe_kw(model="wan2.1-vace-1.3B", task="vace",
                                              vace_ref_images=1))
    # 32 tokens (the reference frame included) on 3 ranks
    with pytest.raises(ValueError, match="R2V reference frames included.*does not divide "
                                         "by sp = 3"):
        run_local_ranks(3, lambda plan: make(plan, "ring"), timeout=60.0)
    # generate_batch runs under sp (the dp axis batches prompts over ranks:
    # tests/test_torch_tp_wan.py); its prompts must divide over dp
    plain = _port_pipes({}, _models({}, seed=9)[2], **_pipe_kw())
    want = plain().generate_batch(["a", "b"], seeds=[1, 2]).latents
    got = _ranks(2, lambda plan: plain(plan).generate_batch(["a", "b"], seeds=[1, 2]).latents)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)


def test_thread_launch_tally_counts_each_rank_apart():
    """``ops.build.thread_launches``: each local rank tallies its own
    launches, while the wrapper's count sums them (what the card's phases
    96-103 check rank by rank)."""
    from magcache_tpu_torch.ops.build import count_launch, thread_launches

    def wrapper():
        pass

    wrapper.launches, wrapper.scopes = 0, {"token": 0}

    def rank(plan):
        with thread_launches() as tally:
            for _ in range(plan.rank + 1):
                count_launch(wrapper)
            count_launch(wrapper, "scopes", "token")
        count_launch(wrapper)                  # outside the block: not tallied
        return tally

    tallies = run_local_ranks(3, rank, timeout=60.0)
    assert [t[("wrapper", "launches", None)] for t in tallies] == [1, 2, 3]
    assert all(t[("wrapper", "scopes", "token")] == 1 for t in tallies)
    assert wrapper.launches == 1 + 2 + 3 + 3 and wrapper.scopes == {"token": 3}
