"""FLUX on the (dp, sp, tp) grid on the CPU, in f32, at tiny widths (4
heads), on local ranks (threads of this process).

- the port's FLUX slice classification is the JAX package's
  ``_param_spec``, leaf by leaf, and the per-segment slices of the fused
  projections (``img_qkv`` / ``txt_qkv`` ``[q | k | v]``, ``lin1`` ``[q | k |
  v | mlp]``, ``lin2`` ``[o | mlp]``) reassemble the whole weights;
- ``generate`` at sp 2 x tp 2, sp 2, tp 2 and ring sp 2 against one rank
  and against the JAX ``FluxPipeline`` of the same dp / sp / tp on the
  conftest's 8 virtual CPU devices;
- Kontext, a MagCache request and calibration at sp 2 x tp 2 with one
  rank's skip bits and ratios;
- the refusals, naming the counts; the CLI at ``--tp 2`` as two gloo
  processes against one process.

The JAX pipeline is fed ``t / 1000`` (``tests/test_torch_flux.py``'s module
docstring: the port embeds the scheduler's timestep as it is).
"""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.models import flux as jflux
from magcache_tpu.parallel.mesh import _param_spec
from magcache_tpu.pipelines import flux as jpipe
from magcache_tpu.utils.misc import set_seed as j_set_seed
from magcache_tpu_torch.models import flux as tflux
from magcache_tpu_torch.models.convert import flux_params_from_numpy
from magcache_tpu_torch.parallel.mesh import run_local_ranks
from magcache_tpu_torch.parallel.shard import (COL, ROW, SegmentedLinear, flux_from_state_dict,
                                               flux_segments, param_kind, slice_flux)
from magcache_tpu_torch.pipelines.flux import FluxPipeline, FluxPipelineConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_L2 = 1e-5                 # f32: the slices and collectives reorder f32 sums
TXT, GH, GW = 8, 4, 4
BASE = dict(tiny=True, height=64, width=64, txt_len=TXT, dtype="float32")
PROMPT = "a red fox in snow"


def _numpy_params(cfg, seed=0):
    """A JAX FLUX tree drawn with numpy: kernels ``N(0, 1/fan_in)``, vectors
    (biases, gains) ``0.1 N(0, 1)`` plus 1 for the gains."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if len(s.shape) >= 2 and "qk_scale" not in name:
            return (rng.standard_normal(s.shape)
                    / np.sqrt(s.shape[-2])).astype(np.float32)
        base = 1.0 if "qk_scale" in name else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jflux.init_flux_params(k, cfg), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def weights():
    jcfg = jflux.FluxConfig.tiny(dtype="float32")
    params = _numpy_params(jcfg)
    tcfg = FluxPipelineConfig(**BASE).model_config()
    model = tflux.FluxModel(tcfg, "cpu")
    model.load_state_dict(flux_params_from_numpy(params, tcfg, "cpu"))
    return params, model.requires_grad_(False)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ------------------------------------------------------------------ slices
def test_slice_classification_equals_jax_param_spec(weights):
    params, model = weights
    port = {n: p for n, p in model.named_parameters()}
    seen = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        spec = _param_spec("/".join(keys), np.ndim(leaf))
        axis = [i for i, a in enumerate(spec) if a == "tp"]
        want = None
        if axis:
            want = COL if axis[0] == np.ndim(leaf) - 1 else ROW
        group, rest = keys[0], keys[1:]
        prefix = {"double": "double_blocks.{}.", "single": "single_blocks.{}."}.get(group)
        leafname = {"w": "weight", "b": "bias"}.get(rest[-1] if rest else "", None)
        if prefix is None:                         # embedders and the final layer
            name = ".".join([group, *rest[:-1], leafname]) if leafname else group
        elif leafname:
            name = prefix.format(0) + ".".join([*rest[:-1], leafname])
        else:                                      # the q/k gains
            name = prefix.format(0) + rest[0]
        assert name in port, name
        assert param_kind(name, port[name].ndim) == want, name
        seen += 1
    assert seen == len({re.sub(r"_blocks\.\d+\.", "_blocks.0.", n) for n in port})


@pytest.mark.parametrize("tp", [2, 4])
def test_segment_slices_reassemble_the_whole_weights(weights, tp):
    _, model = weights
    cfg = model.cfg
    ranks = [slice_flux(model, r, tp) for r in range(tp)]
    copies = [slice_flux(model, r, tp, copy=True) for r in range(tp)]
    whole = dict(model.named_parameters())
    for name, dim in (("double_blocks.1.img_qkv", 0), ("double_blocks.0.txt_qkv", 0),
                      ("single_blocks.1.lin1", 0), ("single_blocks.0.lin2", 1)):
        sizes = flux_segments(name + ".weight", cfg)
        segs = [m.get_submodule(name) for m in ranks]
        assert all(isinstance(s, SegmentedLinear) and s.dim == dim for s in segs)
        # views: one a segment, sharing the whole weight's storage
        assert len(segs[0].weights) == len(sizes)
        assert segs[0].weights[0].untyped_storage().data_ptr() == \
            whole[name + ".weight"].untyped_storage().data_ptr()
        parts = [torch.cat([s.weights[i] for s in segs], dim) for i in range(len(sizes))]
        torch.testing.assert_close(torch.cat(parts, dim), whole[name + ".weight"],
                                   rtol=0, atol=0)
        # copies: one contiguous tensor of the rank's segments
        for r, m in enumerate(copies):
            seg = m.get_submodule(name)
            assert len(seg.weights) == 1 and seg.weights[0].is_contiguous()
            torch.testing.assert_close(seg.weights[0],
                                       torch.cat(list(segs[r].weights), dim), rtol=0, atol=0)
        if dim == 0:
            bias = torch.cat([torch.cat([s.biases[i] for s in segs]) for i in range(len(sizes))])
            torch.testing.assert_close(bias, whole[name + ".bias"], rtol=0, atol=0)
        else:
            torch.testing.assert_close(segs[0].bias, whole[name + ".bias"], rtol=0, atol=0)
    # a plain row projection and a replicated table
    w = whole["double_blocks.0.img_proj.weight"]
    torch.testing.assert_close(torch.cat([m.double_blocks[0].img_proj.weight for m in ranks], 1),
                               w, rtol=0, atol=0)
    assert ranks[1].double_blocks[0].img_mod.weight.shape == (6 * cfg.hidden, cfg.hidden)
    # a checkpoint's state dict: only the rank's slices are copied
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    from_sd = flux_from_state_dict(cfg, sd, 1, tp, "cpu")
    torch.testing.assert_close(from_sd.single_blocks[1].lin1.weights[0],
                               copies[1].single_blocks[1].lin1.weights[0], rtol=0, atol=0)
    assert from_sd.tp_slice == (1, tp)


# ---------------------------------------------------------------- pipelines
def _jax_noise():
    return np.array(jax.random.normal(j_set_seed(5), (1, GH * GW, 16), jnp.float32))


def _port_generate(model, grid, cfg_kw, gen_kw=None):
    """Every rank's ``generate`` output on the grid's local ranks, from the
    JAX draw of the noise."""
    dp, sp, tp = grid
    z = torch.from_numpy(_jax_noise())

    def rank(plan):
        cfg = FluxPipelineConfig(**BASE, **cfg_kw, dp=dp, sp=sp, tp=tp)
        pipe = FluxPipeline(cfg, "cpu", model=model, plan=plan if dp * sp * tp > 1 else None)
        pipe._initial_noise = lambda seed: z
        kw = {k: torch.from_numpy(v) for k, v in (gen_kw or {}).items()}
        return pipe.generate(PROMPT, seed=5, **kw), pipe

    if dp * sp * tp == 1:
        return [rank(None)]
    return run_local_ranks(sp, rank, dp=dp, tp=tp, timeout=60.0)


def _jax_generate(params, grid, cfg_kw, gen_kw=None):
    dp, sp, tp = grid
    j = jpipe.FluxPipeline(jpipe.FluxPipelineConfig(**BASE, **cfg_kw, dp=dp, sp=sp, tp=tp),
                           params=params)
    sch = j._schedule()
    j._schedule = lambda: dataclasses.replace(
        sch, timesteps=(sch.timesteps / 1000).astype(np.float32))
    j.record_skips = True
    return j.generate(PROMPT, seed=5, **{k: jnp.asarray(v) for k, v in (gen_kw or {}).items()})


MAG = dict(num_inference_steps=6, use_magcache=True, magcache_thresh=0.5, magcache_K=2)
GRIDS = [(1, 2, 2, "auto"), (1, 2, 1, "auto"), (1, 1, 2, "auto"), (1, 2, 1, "ring")]


@pytest.fixture(scope="module")
def single(weights):
    return _port_generate(weights[1], (1, 1, 1), MAG)[0][0]


@pytest.mark.parametrize("grid", GRIDS, ids=[f"dp{d}-sp{s}-tp{t}-{i}" for d, s, t, i in GRIDS])
def test_generate_on_the_grid_matches_one_rank_and_jax(weights, single, grid, monkeypatch):
    params, model = weights
    *axes, impl = grid
    outs = _port_generate(model, tuple(axes), dict(MAG, sp_impl=impl))
    if impl == "ring":
        monkeypatch.setenv("MAGCACHE_ATTN_IMPL", "ring")
    want = _jax_generate(params, tuple(axes), MAG)
    jlat = np.asarray(want.latents)
    for out, pipe in outs:
        assert out.latents.shape == (1, GH * GW, 16)
        assert torch.equal(out.latents, outs[0][0].latents)   # every rank the same bits
        np.testing.assert_array_equal(out.skips, pipe.skip_mask_for(0.5, 2))
        np.testing.assert_array_equal(out.skips, np.asarray(want.skips))
    got = outs[0][0].latents.numpy()
    assert out.skips.any() and _rel(got, single.latents.numpy()) < REL_L2
    assert _rel(got, jlat) < REL_L2


def test_kontext_magcache_and_calibration_at_sp2_tp2(weights):
    _, model = weights
    cl = np.random.default_rng(6).standard_normal((1, GH * GW, 16)).astype(np.float32)
    kw = dict(model="flux-kontext-dev", num_inference_steps=8, use_magcache=True,
              magcache_thresh=0.3)
    one = _port_generate(model, (1, 1, 1), kw, dict(cond_latents=cl))[0][0]
    outs = _port_generate(model, (1, 2, 2), kw, dict(cond_latents=cl))
    for out, pipe in outs:
        np.testing.assert_array_equal(out.skips, pipe.skip_mask_for())
        assert _rel(out.latents.numpy(), one.latents.numpy()) < REL_L2
    assert outs[0][0].skips.any()
    cal = dict(num_inference_steps=5, magcache_calibration=True)
    one = _port_generate(model, (1, 1, 1), cal)[0][0]
    for out, _ in _port_generate(model, (1, 2, 2), cal):
        assert out.skips is None
        for name, vals in one.calibration.items():
            np.testing.assert_allclose(out.calibration[name], vals, atol=1e-5, rtol=1e-4)


def test_refusals_name_the_counts(weights):
    _, model = weights
    with pytest.raises(ValueError, match="FLUX's batch is 1"):
        FluxPipelineConfig(**BASE, dp=2)
    z = torch.zeros(1, GH * GW, 16)
    cases = [((1, 1, 3), "auto", r"tp = 3: FLUX's 4 heads and MLP of 512"),
             ((1, 4, 2), "auto", r"sp 4 x tp 2: FLUX's 4 heads over 8 ranks leave 0.5"),
             ((1, 3, 1), "ring", r"image stream of 16 tokens length 16 does not divide by "
                                 r"sp = 3"),
             ((1, 2, 1), "ring", None)]
    for (dp, sp, tp), impl, msg in cases:
        def rank(plan, txt=TXT if msg else 7):
            core = tflux.make_flux_core(model, txt, GH, GW, plan=plan, sp_impl=impl)
            return core.prepare(z, torch.ones(1), {"txt": torch.zeros(1, txt, 32)})

        with pytest.raises(ValueError, match=msg or r"ring attention splits the 7 text "
                                                     r"tokens over sp = 2"):
            run_local_ranks(sp, rank, dp=dp, tp=tp, timeout=60.0)
    sliced = slice_flux(model, 1, 2)
    with pytest.raises(ValueError, match=r"tp slice \(1, 2\); pass the plan"):
        tflux.make_flux_core(sliced, TXT, GH, GW)


# ---------------------------------------------------------------------- CLI
ARGS = ["--task", "flux-dev", "--tiny", "--device", "cpu", "--dtype", "float32",
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
    assert "forwards (one per step, embedded guidance)" in outs[0]
    assert "latents" in outs[0] and "latents" not in outs[1]   # rank 0 saves
    got, want = np.load(two + "_latents.npy"), np.load(one + "_latents.npy")
    assert got.shape == want.shape == (1, GH * GW, 16)
    assert _rel(got, want) < REL_L2
    with pytest.raises(SystemExit, match="FLUX's batch is 1"):
        G.main(ARGS + ["--dp", "2"])
