"""The sequence-parallel Wan slice on the CPU, in f32: a MagCache request on
tiny Wan under 2 and 4 local ranks (threads of this process), Ulysses and
ring, against the port's single-rank run and against the JAX package's run
under ``use_mesh`` with the same ``sp`` and the same weights; calibration
under a plan; the pipeline; and the CLI as two real processes on gloo.
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

from magcache_tpu.core import sampler as jsampler
from magcache_tpu.core.presets import make_config as j_make_config
from magcache_tpu.models import wan as jwan
from magcache_tpu.models.text import MockTextEncoder as JMock
from magcache_tpu.parallel.mesh import (MeshPlan as JMeshPlan, activation_sharding,
                                        build_mesh, shard_params, use_mesh)
from magcache_tpu.schedulers.unipc import UniPCSchedule as JUniPC
from magcache_tpu_torch.cli import generate as cli
from magcache_tpu_torch.core import sampler as tsampler
from magcache_tpu_torch.core.calibration import calibration_stats
from magcache_tpu_torch.core.magcache import compute_skip_schedule
from magcache_tpu_torch.core.presets import make_config as t_make_config
from magcache_tpu_torch.models import wan as twan
from magcache_tpu_torch.models.convert import wan_params_from_numpy
from magcache_tpu_torch.parallel.mesh import run_local_ranks
from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig
from magcache_tpu_torch.schedulers.unipc import UniPCSchedule as TUniPC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_KW = dict(heads=4, dim=96)
GRID = (2, 4, 4)                         # 32 tokens: 16 or 8 a rank
# steps: full, all-skip, cond-only skip, uncond-only skip, full, all-skip
MASK = np.array([[0, 0], [1, 1], [1, 0], [0, 1], [0, 0], [1, 1]], bool)
# f32 on both sides over 6 UniPC steps through a 2-block trunk; the sharded
# attentions only reorder f32 sums -> the JAX sharded test's own 2e-4
TOL = 2e-4


def _setup():
    jcfg = jwan.WanConfig.tiny(**CFG_KW)
    tcfg = twan.WanConfig.tiny(**CFG_KW)
    params = jwan.init_wan_params(jax.random.PRNGKey(0), jcfg)
    model = twan.WanModel(tcfg, "cpu")
    model.load_state_dict(wan_params_from_numpy(jax.tree.map(np.asarray, params),
                                                tcfg, "cpu"))
    rng = np.random.default_rng(6)
    f, h, w = GRID
    x = rng.standard_normal((1, f, 2 * h, 2 * w, tcfg.in_channels)).astype(np.float32)
    ctx = np.array(JMock(tcfg.text_len, tcfg.text_dim, scale=0.5)(["a cat", "blurry"]))
    return jcfg, params, model, x, ctx


def _torch_run(model, x, ctx, plan=None, sp_impl="auto", caches=None):
    """One rank's MagCache request; ``caches`` collects the trunk's input
    shapes (the residual cache has the same shape)."""
    core = twan.make_wan_core(model, GRID, plan, sp_impl=sp_impl)
    if caches is not None:
        trunk = core.trunk

        def spy(h, c):
            caches.append((plan.rank if plan else 0, tuple(h.shape)))
            return trunk(h, c)
        core = dataclasses.replace(core, trunk=spy)
    return tsampler.sample_unipc(
        core, torch.from_numpy(x), {"context": torch.from_numpy(ctx)},
        TUniPC.create(len(MASK), shift=5.0),
        cache_cfg=t_make_config("wan2.1-t2v-1.3B", len(MASK)), guidance_scale=5.0,
        skip_mask_override=MASK, return_skips=True)


def _jax_run(jcfg, params, x, ctx, sp):
    core = jwan.make_wan_core(jcfg, GRID)
    sch = JUniPC.create(len(MASK), shift=5.0)

    def run(p, xx, cc):
        return jsampler.sample_unipc(
            core, p, xx, cc, sch, cache_cfg=j_make_config("wan2.1-t2v-1.3B", len(MASK)),
            guidance_scale=5.0, skip_mask_override=jnp.asarray(MASK))

    mesh = build_mesh(dp=1, sp=sp, tp=1)
    x_s = jax.device_put(jnp.asarray(x), activation_sharding(mesh, "latents", x.ndim))
    c_s = {"context": jax.device_put(jnp.asarray(ctx),
                                     activation_sharding(mesh, "context", 3))}
    with use_mesh(JMeshPlan(mesh)):
        return np.asarray(jax.jit(run)(shard_params(params, mesh), x_s, c_s))


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("sp_impl", ["ulysses", "ring"])
def test_sp_request_matches_single_rank_and_jax_mesh(sp, sp_impl, monkeypatch):
    jcfg, params, model, x, ctx = _setup()
    single, single_skips = _torch_run(model, x, ctx)
    monkeypatch.setenv("MAGCACHE_ATTN_IMPL", sp_impl)      # the JAX side's switch
    want = _jax_run(jcfg, params, x, ctx, sp)

    caches = []
    outs = run_local_ranks(
        sp, lambda plan: _torch_run(model, x, ctx, plan, sp_impl, caches), timeout=60.0)
    for lat, skips in outs:
        np.testing.assert_array_equal(skips, MASK)          # the same bits on every rank
        np.testing.assert_array_equal(skips, single_skips)
        torch.testing.assert_close(lat, outs[0][0], atol=0, rtol=0)   # identical latents
    got = outs[0][0].numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, single.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # each rank's trunk (and so its residual cache) holds 1/sp of the 32
    # tokens; 2 full steps of 2 rows and 2 half-batch steps of 1 row per rank
    tokens = GRID[0] * GRID[1] * GRID[2]
    for r in range(sp):
        shapes = [s for rank, s in caches if rank == r]
        assert shapes == [(2, tokens // sp, 96), (1, tokens // sp, 96),
                          (1, tokens // sp, 96), (2, tokens // sp, 96)]


def test_sp_forward_matches_single_rank_core():
    _, _, model, x, ctx = _setup()
    x2 = torch.from_numpy(np.concatenate([x, x[:, ::-1].copy()]))
    t = torch.tensor([900.0, 250.0])
    cond = {"context": torch.from_numpy(ctx)}
    core = twan.make_wan_core(model, GRID)
    hidden, c = core.prepare(x2, t, cond)
    want = core.head(core.trunk(hidden, c), c)

    def rank(plan):
        pc = twan.make_wan_core(model, GRID, plan)
        h, cc = pc.prepare(x2, t, cond)
        assert h.shape == (2, 32 // plan.sp, 96)
        # the rank's rows of the single-rank embedding; the context is whole
        torch.testing.assert_close(h, hidden[:, plan.rank * 8:(plan.rank + 1) * 8],
                                   atol=1e-6, rtol=1e-6)
        assert cc["context"].shape == c["context"].shape
        return pc.head(pc.trunk(h, cc), cc)

    for out in run_local_ranks(4, rank, timeout=60.0):
        assert out.shape == want.shape
        np.testing.assert_allclose(out.numpy(), want.numpy(), atol=TOL, rtol=TOL)


def test_calibration_under_sp_gives_the_single_rank_ratios():
    _, _, model, x, ctx = _setup()
    sch = TUniPC.create(5, shift=5.0)
    args = (torch.from_numpy(x), {"context": torch.from_numpy(ctx)}, sch)
    want_x, want = tsampler.calibrate_unipc(twan.make_wan_core(model, GRID), *args,
                                            lanes=2, guidance_scale=5.0)
    outs = run_local_ranks(2, lambda plan: tsampler.calibrate_unipc(
        twan.make_wan_core(model, GRID, plan), *args, lanes=2, guidance_scale=5.0,
        plan=plan), timeout=60.0)
    for got_x, got in outs:
        assert got.shape == (4, 2, 3)
        # token means from all-reduced f32 sums; cos distances near 0 need an
        # absolute floor (the tolerance of the JAX calibration parity test)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
        np.testing.assert_array_equal(got, outs[0][1])
        np.testing.assert_allclose(got_x.numpy(), want_x.numpy(), atol=TOL, rtol=TOL)


def test_calibration_stats_all_reduce_matches_whole_sequence():
    rng = np.random.default_rng(9)
    r, p = (torch.from_numpy(rng.standard_normal((2, 40, 16)).astype(np.float32))
            for _ in range(2))
    want = calibration_stats(r, p)
    for got in run_local_ranks(4, lambda plan: calibration_stats(
            r[:, plan.rank * 10:(plan.rank + 1) * 10],
            p[:, plan.rank * 10:(plan.rank + 1) * 10], plan)):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


def _pipe_cfg(**kw):
    base = dict(tiny=True, size=(64, 32), frame_num=9, sample_steps=10,
                sample_shift=5.0, guide_scale=5.0, dtype="float32", use_magcache=True)
    base.update(kw)
    return WanPipelineConfig(**base)


@pytest.mark.parametrize("sp,sp_impl", [(2, "auto"), (4, "ring")])
def test_pipeline_under_local_ranks(sp, sp_impl):
    one = WanPipeline(_pipe_cfg(), "cpu")
    want = one.generate("a cat", seed=1)
    outs = run_local_ranks(sp, lambda plan: WanPipeline(
        _pipe_cfg(sp=sp, sp_impl=sp_impl), "cpu", model=one.model, plan=plan
    ).generate("a cat", seed=1), timeout=60.0)
    sched = compute_skip_schedule(one._cache_cfg()).reshape(10, 2)
    for out in outs:
        np.testing.assert_array_equal(out.skips, sched)
        torch.testing.assert_close(out.latents, outs[0].latents, atol=0, rtol=0)
    np.testing.assert_allclose(outs[0].latents.numpy(), want.latents.numpy(),
                               atol=TOL, rtol=TOL)


def test_pipeline_and_core_refuse_bad_plans():
    with pytest.raises(ValueError, match="needs a plan"):
        WanPipeline(_pipe_cfg(sp=2), "cpu")
    _, _, model, _, _ = _setup()
    # 3 ranks: 32 tokens do not divide
    with pytest.raises(ValueError, match="does not divide by sp"):
        run_local_ranks(3, lambda plan: twan.make_wan_core(model, GRID, plan))
    # 8 ranks: 4 heads do not divide (Ulysses); the ring needs no head split
    with pytest.raises(ValueError, match="heads do not divide"):
        run_local_ranks(8, lambda plan: twan.make_wan_core(model, GRID, plan))
    run_local_ranks(8, lambda plan: twan.make_wan_core(model, GRID, plan, sp_impl="ring"))


def test_a_rank_failing_inside_the_model_ends_the_request():
    _, _, model, x, ctx = _setup()

    def rank(plan):
        if plan.rank == 1:
            bad = torch.from_numpy(ctx[:, :, :-1].copy())       # wrong text width
            return _torch_run(model, x, bad.numpy(), plan)
        return _torch_run(model, x, ctx, plan)

    with pytest.raises(RuntimeError):
        run_local_ranks(2, rank, timeout=60.0)


def test_cli_sp_without_ranks_names_torchrun(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="torchrun"):
        cli.main(["--tiny", "--device", "cpu", "--sp", "2"])
    # every Wan task takes --sp; the other families name the roadmap item
    with pytest.raises(SystemExit, match="ROADMAP section 1 item 2"):
        cli.main(["--task", "open-sora", "--tiny", "--device", "cpu", "--ulysses_size", "2"])
    with pytest.raises(SystemExit, match="torchrun"):
        cli.main(["--task", "i2v-14B", "--tiny", "--device", "cpu", "--ulysses_size", "2"])


def _cli(args, env_extra=None, task=("--task", "t2v-1.3B")):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    env.update(env_extra or {})
    return subprocess.Popen(
        [sys.executable, "-m", "magcache_tpu_torch.cli.generate", *task,
         "--tiny", "--device", "cpu", "--dtype", "float32", "--sample_steps", "6",
         "--use_magcache", *args],
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


@pytest.mark.parametrize("flag,task", [("--ulysses_size", "t2v-1.3B"),
                                       ("--ring_size", "t2v-1.3B"),
                                       ("--ulysses_size", "ti2v-5B")])
def test_cli_two_gloo_processes_match_one_process(flag, task, tmp_path):
    """ti2v with an image: every process encodes it alike, and the t = 0
    prefix (latent frame 0's 8 tokens) lies on rank 0's 12."""
    task_args = ("--task", task)
    if task == "ti2v-5B":
        image = str(tmp_path / "img.npy")
        np.save(image, np.random.default_rng(4).random((24, 40, 3)).astype(np.float32))
        task_args += ("--image", image)
    one = str(tmp_path / "one")
    _wait([_cli(["--save_file", one], task=task_args)], 180)
    rdv = "file://" + str(tmp_path / "rendezvous")
    two = str(tmp_path / "two")
    # the children import the port only (torch, never jax: held by
    # test_torch_pipeline.py's import-boundary test, which walks parallel/ too)
    procs = [_cli([flag, "2", "--dist_init_method", rdv, "--save_file", two],
                  dict(RANK=str(r), WORLD_SIZE="2"), task_args) for r in range(2)]
    outs = _wait(procs, 180)
    if task == "t2v-1.3B":
        assert "skipped 6 of 12" in outs[0]
    assert "latents" in outs[0]
    assert "latents" not in outs[1]                  # rank 0 saves, rank 1 is silent
    got, want = np.load(two + "_latents.npy"), np.load(one + "_latents.npy")
    assert got.shape == want.shape == (1, 3, 4, 8, 16)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
