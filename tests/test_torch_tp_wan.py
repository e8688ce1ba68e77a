"""Wan's dp and tp axes on the CPU, in f32, at tiny widths (4 heads), on
local ranks of the (dp, sp, tp) grid (threads of this process).

- the port's tensor-parallel slice classification is the JAX package's
  ``_param_spec``, leaf by leaf, for every published Wan tree;
- K2's plain version with tp-reduced row statistics equals the unsplit one;
- forwards at tp 2, tp 4, dp 2, sp 2 x tp 2 and dp 2 x sp 2 x tp 2 against
  one rank and against the JAX package under ``use_mesh`` of the same mesh
  with ``shard_params`` (the conftest's 8 virtual CPU devices);
- i2v, VACE, the per-token timestep's t = 0 prefix and the A14B MoE at tp 2;
- a MagCache request, a TeaCache request and calibration at dp 2 x tp 2
  (the CFG lanes on two dp ranks) with one rank's skip bits and ratios;
- ``generate_batch`` and the sweep at dp 2 (whole prompts a dp rank);
- the CLI at ``--tp 2`` as two gloo processes against one process;
- the refusals that stay, naming the counts.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.models import wan as jwan
from magcache_tpu.parallel.mesh import (MeshPlan as JMeshPlan, _param_spec,
                                        activation_sharding, build_mesh, shard_params, use_mesh)
from magcache_tpu_torch.eval.sweep import SweepConfig, run_sweep
from magcache_tpu_torch.models import wan as twan
from magcache_tpu_torch.models.convert import wan_params_from_numpy
from magcache_tpu_torch.ops.fused_prologue import rms_norm_rope_plain, row_sumsq_plain
from magcache_tpu_torch.parallel.mesh import run_local_ranks
from magcache_tpu_torch.parallel.shard import COL, ROW, jax_path, param_kind
from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 on both sides: the slices, the f32 all-reduces and the sharded
# attentions only reorder f32 sums (the sp tests' tolerance)
TOL = 2e-4
CAL_ATOL, CAL_RTOL = 1e-5, 1e-4       # the sp tests' calibration tolerance
GRID = (2, 4, 4)                      # 32 tokens
GRIDS = [(1, 1, 2), (1, 1, 4), (2, 1, 1), (1, 2, 2), (2, 2, 2)]
GRID_IDS = [f"dp{d}-sp{s}-tp{t}" for d, s, t in GRIDS]
PROMPT = "a corgi surfs a wave"


def _numpy_params(cfg, seed):
    """A JAX Wan tree drawn with numpy: kernels ``N(0, 1/fan_in)``, vectors
    ``1 + 0.1 N(0, 1)``."""
    rng = np.random.default_rng(seed)

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
    return jcfg, params, model.requires_grad_(False)


def _inputs(cfg, seed, **extra):
    rng = np.random.default_rng(seed)
    f, h, w = GRID
    lat = (2, f, 2 * h, 2 * w)
    cond = {"context": rng.standard_normal((2, cfg.text_len, cfg.text_dim)).astype(np.float32)}
    for k, shape in extra.items():
        cond[k] = rng.standard_normal(lat + shape if k != "clip_fea" else shape
                                      ).astype(np.float32)
    x = rng.standard_normal(lat + (16,)).astype(np.float32)
    return x, np.array([900.0, 250.0], np.float32), cond


def _forward(model, x, t, cond, plan=None):
    """The core's forward; a dp rank runs its lane's rows, gathered over dp."""
    core = twan.make_wan_core(model, GRID, plan)
    rows = slice(None)
    if plan is not None and plan.dp > 1:
        rows = slice(plan.dp_rank, plan.dp_rank + 1)
    cc = {k: (torch.from_numpy(v)[rows] if np.ndim(v) >= 1 else v) for k, v in cond.items()}
    hidden, ctx = core.prepare(torch.from_numpy(x)[rows], torch.from_numpy(t)[rows], cc)
    out = core.head(core.trunk(hidden, ctx), ctx)
    return plan.dp_group.all_gather(out, 0) if plan is not None and plan.dp > 1 else out


def _on_grid(grid, fn):
    """``fn(plan)`` on the grid's local ranks; every rank's tensor is the
    same bits. Returns rank 0's."""
    dp, sp, tp = grid
    outs = run_local_ranks(sp, fn, dp=dp, tp=tp, timeout=60.0)
    for r, out in enumerate(outs[1:], 1):
        assert torch.equal(out, outs[0]), f"rank {r} differs from rank 0"
    return outs[0]


def _jax_forward(jcfg, params, x, t, cond, grid):
    core = jwan.make_wan_core(jcfg, GRID)

    def fwd(p, xx, cc):
        hidden, ctx = core.prepare(p, xx, jnp.asarray(t), cc)
        return core.head(p, core.trunk(p, hidden, ctx), ctx)

    mesh = build_mesh(*grid)
    xs = jax.device_put(jnp.asarray(x), activation_sharding(mesh, "latents", x.ndim))
    cs = {k: (jax.device_put(jnp.asarray(v), activation_sharding(mesh, "context", v.ndim))
              if np.ndim(v) >= 3 else jnp.asarray(v)) for k, v in cond.items()}
    with use_mesh(JMeshPlan(mesh)):
        return np.asarray(jax.jit(fwd)(shard_params(params, mesh), xs, cs))


# ------------------------------------------------------------ weight slices
def _jax_kind(spec) -> object:
    spec = tuple(spec)
    if spec and spec[-1] == "tp":
        return COL
    if len(spec) >= 2 and spec[-2] == "tp":
        return ROW
    assert "tp" not in spec, spec
    return None


TREES = {
    "1.3B": (jwan.WAN_1_3B, twan.WAN_1_3B),
    "14B-i2v-clip": tuple(dataclasses.replace(c, model_type="i2v", in_channels=36)
                          for c in (jwan.WAN_14B, twan.WAN_14B)),
    "vace-1.3B": tuple(dataclasses.replace(c, vace_layers=tuple(range(0, 30, 5)))
                       for c in (jwan.WAN_1_3B, twan.WAN_1_3B)),
    "ti2v-5B": (jwan.WAN_5B, twan.WAN_5B),
}


@pytest.mark.parametrize("name", list(TREES))
def test_slice_classification_is_the_jax_param_spec(name):
    jcfg, tcfg = TREES[name]
    tree = jax.eval_shape(lambda k: jwan.init_wan_params(k, jcfg), jax.random.PRNGKey(0))
    want = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
        want[path] = _jax_kind(_param_spec(path, leaf.ndim))
    seen = set()
    for pname, p in twan.WanModel(tcfg, "meta").named_parameters():
        path = jax_path(pname)
        assert path in want, pname
        assert param_kind(pname, p.ndim) == want[path], pname
        seen.add(path)
    assert seen == set(want)
    kinds = {k for k in want.values() if k}
    assert kinds == {COL, ROW}


@pytest.mark.parametrize("tp", [2, 4])
def test_k2_plain_with_tp_reduced_statistics_equals_the_whole_row(tp):
    rng = np.random.default_rng(tp)
    heads, d, s = 8, 16, 7
    x = torch.from_numpy(rng.standard_normal((2, s, heads * d)).astype(np.float32) * 2)
    gain = torch.from_numpy(1.0 + 0.1 * rng.standard_normal(heads * d).astype(np.float32))
    cos, sin = (torch.from_numpy(rng.standard_normal((s, d // 2)).astype(np.float32))
                for _ in range(2))
    want = rms_norm_rope_plain(x, gain, cos, sin, heads, eps=1e-6)
    w = heads * d // tp
    parts = [x[..., r * w:(r + 1) * w] for r in range(tp)]
    total = sum(row_sumsq_plain(p) for p in parts)
    got = torch.cat([rms_norm_rope_plain(p, gain[r * w:(r + 1) * w], cos, sin, heads // tp,
                                         eps=1e-6, row_sumsq=total, width=heads * d)
                     for r, p in enumerate(parts)], dim=2)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


# ----------------------------------------------------------------- forwards
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_forward_on_the_grid_matches_one_rank_and_jax_mesh(grid):
    jcfg, params, model = _models({}, seed=1)
    x, t, cond = _inputs(model.cfg, 2)
    single = _forward(model, x, t, cond)
    got = _on_grid(grid, lambda plan: _forward(model, x, t, cond, plan))
    want = _jax_forward(jcfg, params, x, t, cond, grid)
    np.testing.assert_allclose(got.numpy(), single.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


TASKS = {
    "i2v": (dict(model_type="i2v", in_channels=36, clip_dim=32, clip_tokens=17),
            dict(y=(20,), clip_fea=(2, 17, 32))),
    "vace": (dict(vace_layers=(0, 1)), dict(vace_context=(96,))),
}


@pytest.mark.parametrize("task", list(TASKS))
def test_i2v_and_vace_forwards_at_tp2_match_one_rank(task):
    cfg_kw, extra = TASKS[task]
    _, _, model = _models(cfg_kw, seed=3)
    x, t, cond = _inputs(model.cfg, 4, **extra)
    single = _forward(model, x, t, cond)
    got = _on_grid((1, 1, 2), lambda plan: _forward(model, x, t, cond, plan))
    np.testing.assert_allclose(got.numpy(), single.numpy(), atol=TOL, rtol=TOL)


def test_t0_prefix_at_sp2_x_tp2_matches_one_rank():
    """The per-token timestep: latent frame 0's 16 tokens lie on sp rank 0;
    each tp rank of both sp ranks modulates whole rows."""
    _, _, model = _models({}, seed=5)
    x, t, cond = _inputs(model.cfg, 6)
    cond["ti2v_img"] = np.zeros(())
    single = _forward(model, x, t, cond)
    got = _on_grid((1, 2, 2), lambda plan: _forward(model, x, t, cond, plan))
    np.testing.assert_allclose(got.numpy(), single.numpy(), atol=TOL, rtol=TOL)


# ----------------------------------------------------------------- requests
def _pipe(dit, grid=(1, 1, 1), plan=None, dit_low=None, **kw):
    base = dict(tiny=True, size=(64, 32), frame_num=9, sample_steps=8, sample_shift=5.0,
                guide_scale=5.0, dtype="float32", model_cfg_override=dit.cfg)
    base.update(kw)
    dp, sp, tp = grid
    return WanPipeline(WanPipelineConfig(dp=dp, sp=sp, tp=tp, **base), "cpu", model=dit,
                       model_low=dit_low, plan=plan)


def _check_request(dit, grid, dit_low=None, **kw):
    """The request on one rank and on the grid: every rank's latents, skip
    bits and calibration equal to rank 0's; rank 0's equal to one rank's."""
    single = _pipe(dit, dit_low=dit_low, **kw).generate(PROMPT, seed=3)
    outs = run_local_ranks(grid[1], lambda plan: _pipe(
        dit, grid, plan, dit_low, **kw).generate(PROMPT, seed=3), dp=grid[0],
        tp=grid[2], timeout=60.0)
    for r, out in enumerate(outs):
        assert torch.equal(out.latents, outs[0].latents), f"rank {r}'s latents differ"
        if single.skips is not None:
            np.testing.assert_array_equal(out.skips, single.skips)
        if single.calibration is not None:
            for k, v in single.calibration.items():
                np.testing.assert_allclose(out.calibration[k], v, atol=CAL_ATOL,
                                           rtol=CAL_RTOL)
    np.testing.assert_allclose(outs[0].latents.numpy(), single.latents.numpy(), atol=TOL,
                               rtol=TOL)
    return single


POLICIES = {
    # a lane-asymmetric schedule: each lane's skip bits ride their own dp rank
    "magcache": dict(use_magcache=True, magcache_thresh=0.3, magcache_K=3),
    "teacache": dict(enable_teacache=True, teacache_thresh=1500.0, sample_steps=10),
    "calibration": dict(magcache_calibration=True, sample_steps=5),
}


@pytest.mark.parametrize("kind", list(POLICIES))
def test_requests_at_dp2_x_tp2_match_one_rank(kind):
    _, _, model = _models({}, seed=9)
    single = _check_request(model, (2, 1, 2), **POLICIES[kind])
    if kind == "calibration":
        assert len(single.calibration["norm_ratio"]) == 2 * (5 - 1)   # both lanes
    else:
        assert single.skips.any()
    if kind == "magcache":
        np.testing.assert_array_equal(single.skips, _pipe(model, **POLICIES[kind]
                                                          ).skip_mask_for())


def test_moe_request_at_tp2_matches_one_rank():
    """Both experts' blocks are sliced; one carry crosses the switch."""
    _, _, hi = _models({}, seed=20)
    _, _, lo = _models({}, seed=21)
    single = _check_request(hi, (1, 1, 2), dit_low=lo, model="wan2.2-t2v-A14B",
                            guide_scale=(3.0, 4.0), use_magcache=True)
    assert single.skips.any()


@pytest.mark.parametrize("grid", [(2, 1, 1), (2, 1, 2)], ids=["dp2", "dp2-tp2"])
def test_generate_batch_at_dp2_gives_each_element_its_own_generate(grid):
    _, _, model = _models({}, seed=11)
    kw = dict(use_magcache=True)
    want = torch.cat([_pipe(model, **kw).generate(p, seed=s).latents
                      for p, s in (("a cat", 5), ("a dog", 8))])
    outs = run_local_ranks(grid[1], lambda plan: _pipe(model, grid, plan, **kw).generate_batch(
        ["a cat", "a dog"], seeds=[5, 8]).latents, dp=grid[0], tp=grid[2], timeout=60.0)
    for out in outs:
        assert torch.equal(out, outs[0])
    np.testing.assert_allclose(outs[0].numpy(), want.numpy(), atol=TOL, rtol=TOL)


def test_sweep_at_dp2_x_tp2_writes_one_rank_s_files(tmp_path):
    _, _, model = _models({}, seed=13)
    kw = dict(variant="magcache", end_index=2, tiny=True, sample_steps=6,
              dtype="float32", dp=2, tp=2)
    one = run_sweep(SweepConfig(out_dir=str(tmp_path / "one"), **dict(kw, tp=1)),
                    pipeline=_pipe(model, sample_steps=6, use_magcache=True))
    out = str(tmp_path / "grid")
    run_local_ranks(1, lambda plan: run_sweep(
        SweepConfig(out_dir=out, **kw),
        pipeline=_pipe(model, (2, 1, 2), plan, sample_steps=6, use_magcache=True)),
        dp=2, tp=2, timeout=60.0)
    assert sorted(os.listdir(out)) == sorted(os.listdir(tmp_path / "one"))
    for i in range(one["count"]):
        np.testing.assert_allclose(np.load(os.path.join(out, f"{i:05d}.npy")),
                                   np.load(tmp_path / "one" / f"{i:05d}.npy"),
                                   atol=TOL, rtol=TOL)


def test_ckpt_dir_gives_each_tp_rank_only_its_slices(tmp_path):
    """Without a shared model a tp rank builds its own from ``ckpt_dir``:
    only its slices of the blocks (and the replicated rest) reach it."""
    import chip_smoke
    from magcache_tpu_torch.models.checkpoint import save_safetensors

    _, _, model = _models({}, seed=15)
    save_safetensors({k: v.contiguous() for k, v in
                      chip_smoke.wan_published(model.state_dict()).items()},
                     str(tmp_path / "diffusion_pytorch_model.safetensors"))
    kw = dict(use_magcache=True, ckpt_dir=str(tmp_path))
    single = _pipe(model, **kw).generate(PROMPT, seed=3).latents
    whole = sum(p.numel() for p in model.parameters())
    block = sum(p.numel() for n, p in model.named_parameters()
                if n.startswith("blocks.") and param_kind(n, p.ndim))

    def rank(plan):
        pipe = _pipe(model, (1, 1, 2), plan, **kw)
        pipe = WanPipeline(pipe.config, "cpu", plan=plan)      # no shared model
        assert pipe.model.tp_slice == (plan.tp_rank, 2)
        assert sum(p.numel() for p in pipe.model.parameters()) == whole - block // 2
        return pipe.generate(PROMPT, seed=3).latents

    got = _on_grid((1, 1, 2), rank)
    np.testing.assert_allclose(got.numpy(), single.numpy(), atol=TOL, rtol=TOL)


def test_refusals_that_stay_name_the_counts():
    _, _, model = _models({}, seed=1)
    # 4 heads over sp 2 x tp 4 = 8 ranks: Ulysses needs heads / (sp * tp)
    with pytest.raises(ValueError, match=r"sp 2 x tp 4: 4 heads over 8 ranks"):
        run_local_ranks(2, lambda plan: twan.make_wan_core(model, GRID, plan,
                                                           sp_impl="ulysses"), tp=4)
    run_local_ranks(2, lambda plan: twan.make_wan_core(model, GRID, plan, sp_impl="ring"),
                    tp=4)                               # the ring needs heads / tp
    with pytest.raises(ValueError, match=r"tp = 8: 4 heads"):
        run_local_ranks(1, lambda plan: twan.make_wan_core(model, GRID, plan), tp=8)
    with pytest.raises(ValueError, match=r"generate\(\) at dp = 4: the CFG batch holds two "
                                         r"rows"):
        run_local_ranks(1, lambda plan: _pipe(model, (4, 1, 1), plan).generate(PROMPT), dp=4)
    with pytest.raises(ValueError, match="3 prompts do not divide over the dp ranks"):
        run_local_ranks(1, lambda plan: _pipe(model, (2, 1, 1), plan).generate_batch(
            ["a", "b", "c"]), dp=2)
    with pytest.raises(ValueError, match="needs a plan of that grid"):
        _pipe(model, (1, 1, 2))


# ----------------------------------------------------------------------- CLI
ARGS = ["--task", "t2v-1.3B", "--tiny", "--device", "cpu", "--dtype", "float32",
        "--sample_steps", "6", "--use_magcache"]


def _cli(args, env_extra):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    env.update(env_extra)
    return subprocess.Popen(
        [sys.executable, "-m", "magcache_tpu_torch.cli.generate", *ARGS, *args],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait(procs, timeout):
    """Waits for every process; on expiry kills all and fails."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a CLI process did not end within {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


def test_cli_tp2_as_two_gloo_processes_matches_one_process(tmp_path):
    from magcache_tpu_torch.cli import generate as G

    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    rdv = "file://" + str(tmp_path / "rendezvous")
    procs = [_cli(["--tp", "2", "--dist_init_method", rdv, "--save_file", two],
                  dict(RANK=str(r), WORLD_SIZE="2")) for r in range(2)]
    G.main(ARGS + ["--save_file", one])              # one process: this one
    outs = _wait(procs, 180)
    assert "skipped 6 of 12" in outs[0]
    assert "latents" in outs[0] and "latents" not in outs[1]   # rank 0 saves
    got, want = np.load(two + "_latents.npy"), np.load(one + "_latents.npy")
    assert got.shape == want.shape == (1, 3, 4, 8, 16)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
