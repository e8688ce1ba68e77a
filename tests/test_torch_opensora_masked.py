"""The port's Open-Sora 1.2 paths beyond plain 480p t2v against the JAX
package on the CPU: frames of more than 2,048 tokens (720p-class, K1q),
masked-frame conditioning (``x_mask``), ``sample_rflow_masked``, the
mask-strategy helpers, and references and looped extension through the
pipeline and the CLI.

Both sides get the same weights (``init_stdit3_params`` converted by
``stdit3_params_from_numpy``) and the same numpy inputs; random draws that
the two frameworks make differently (the initial and re-noise latents) are
made with ``jax.random`` and handed to the port.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.core import sampler as jsampler
from magcache_tpu.core.presets import make_config as j_make_config
from magcache_tpu.models import stdit3 as J
from magcache_tpu.pipelines import open_sora as jpipe
from magcache_tpu.pipelines import open_sora_cond as joc
from magcache_tpu.utils.misc import set_seed as j_set_seed
from magcache_tpu_torch.cli import generate as cli
from magcache_tpu_torch.core.presets import make_config
from magcache_tpu_torch.core.sampler import sample_rflow_masked
from magcache_tpu_torch.models import stdit3 as T
from magcache_tpu_torch.models.convert import stdit3_params_from_numpy
from magcache_tpu_torch.pipelines import open_sora as tpipe
from magcache_tpu_torch.pipelines import open_sora_cond as toc
from magcache_tpu_torch.schedulers.rflow import RFlowSchedule

# f32 on both sides: GEMM and reduction order only (the plain t2v tests
# measure ~3e-6 at |h| < 9)
F32_TOL = 2e-5
# through several RFLOW steps (and two loops) the same order differences
# grow to ~1e-5 in the latents
PIPE_TOL = 1e-4

# head dim 72 as published
NARROW = dict(hidden=144, heads=2, depth=1, caption_dim=24, freq_dim=32,
              caption_max_len=5)
CAP = 5


def _models(dtype="float32", seed=0, **kw):
    cfg_kw = dict(NARROW, dtype=dtype, **kw)
    jcfg, tcfg = J.STDiT3Config(**cfg_kw), T.STDiT3Config(**cfg_kw)
    params = J.init_stdit3_params(jax.random.PRNGKey(seed), jcfg)
    model = T.STDiT3Model(tcfg, "cpu")
    model.load_state_dict(stdit3_params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu"))
    return jcfg, params, model


def _np(a):
    return np.array(a, np.float32)


def _forward_pair(grid, pixels, x_mask, seed=1):
    """The JAX core (packed path, Pallas kernels in interpret mode) and the
    port on the same weights and inputs; returns both trunks' and heads'
    outputs as numpy."""
    jcfg, params, model = _models()
    jcore = J.make_stdit3_core(jcfg, grid, CAP, pixel_size=pixels)
    tcore = T.make_stdit3_core(model, grid, pixel_size=pixels)
    rng = np.random.default_rng(seed)
    t_len, h, w = grid
    x = rng.standard_normal((2, t_len, 2 * h, 2 * w, 4)).astype(np.float32)
    y = rng.standard_normal((2, CAP, NARROW["caption_dim"])).astype(np.float32)
    t = np.array([700.0, 700.0], np.float32)
    jc, tc = {"y": jnp.asarray(y)}, {"y": torch.from_numpy(y)}
    if x_mask is not None:
        jc["x_mask"], tc["x_mask"] = jnp.asarray(x_mask), torch.from_numpy(x_mask)
    hj, cj = jax.jit(jcore.prepare)(params, jnp.asarray(x), jnp.asarray(t), jc)
    trj = jax.jit(jcore.trunk)(params, hj, cj)
    oj = jax.jit(jcore.head)(params, trj, cj)
    ht, ct = tcore.prepare(torch.from_numpy(x), torch.from_numpy(t), tc)
    for key in cj:
        np.testing.assert_allclose(_np(ct[key]), _np(cj[key]), atol=F32_TOL, rtol=F32_TOL)
    trt = tcore.trunk(ht, ct)
    ot = tcore.head(trt, ct)
    return (trt.numpy(), _np(trj)), (ot.numpy(), _np(oj))


# ---------------------------------------------------------------- STDiT3
@pytest.mark.parametrize("grid,pixels,x_mask,jax_path", [
    ((1, 46, 46), (736, 736), None, "interpret"),                    # 2,116 tokens: K1q
    ((1, 46, 46), (736, 736), np.array([[True], [False]]), "0"),     # masked, K1q
    ((3, 3, 5), (48, 80), np.array([[True, False, True], [False, True, True]]),
     "interpret")])
def test_stdit3_forward_matches_jax(grid, pixels, x_mask, jax_path, monkeypatch):
    """Frames above 2,048 tokens take K1q (JAX: ``flash_attention_bshd`` with
    ``qk_gains`` on the packed path, its Pallas kernels in interpret mode);
    masked frames take the unfused block composition and the head's
    per-frame select, at both frame sizes. The JAX package's masked path
    above 2,048 tokens calls its flash kernel without interpret mode, so
    that case holds the port against the JAX package's unpacked
    composition (plain jnp attention with the same qk-norm)."""
    monkeypatch.setenv("MAGCACHE_STDIT3_PACKED", jax_path)
    for got, want in _forward_pair(grid, pixels, x_mask):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_large_frame_routes_through_k1q(monkeypatch):
    """Route by shape only: a 2,116-token frame calls the qk-normed flash
    wrapper (spatial blocks only), a 15-token one the grouped kernel."""
    _, _, model = _models()
    calls = []
    real = T.flash_attention_bshd

    def spy(*a, **kw):
        calls.append(a[0].shape)
        assert kw["qk_gains"] is not None and kw["fixed_max"] == 16.0
        return real(*a, **kw)

    monkeypatch.setattr(T, "flash_attention_bshd", spy)
    x = torch.zeros(2, 1, 92, 92, 4)
    y = torch.zeros(2, CAP, NARROW["caption_dim"])
    for grid, n in (((1, 46, 46), 1), ((3, 3, 5), 0)):
        calls.clear()
        core = T.make_stdit3_core(model, grid)
        xx = x if n else torch.zeros(2, 3, 6, 10, 4)
        core.trunk(*core.prepare(xx, torch.full((2,), 500.0), {"y": y}))
        assert [c[1] for c in calls] == [2116] * n


# ---------------------------------------------------------------- sampler
def _combine(g, c):
    return lambda chunks: chunks[1][..., :c] + g * (chunks[0][..., :c] - chunks[1][..., :c])


def _jax_noise(key):
    """The JAX masked sampler's re-noise draws, for the port's ``noise_fn``."""
    return lambda step, shape: torch.from_numpy(_np(jax.random.normal(
        jax.random.fold_in(key, step), shape, jnp.float32)))


@pytest.mark.parametrize("mask,cached", [
    ([[0.0, 1.0, 1.0]], False),            # a frozen first frame
    ([[1.0, 0.0, 0.0]], True),             # frozen tail, MagCache on
    ([[0.0, 0.5, 1.0]], True),             # an edit ratio: re-noised mid-run
    ([[0.3, 1.0, 0.8]], False)])
def test_sample_rflow_masked_matches_jax(mask, cached):
    steps = 10
    grid, pixels = (3, 3, 5), (48, 80)
    jcfg, params, model = _models(seed=2)
    jcore = J.make_stdit3_core(jcfg, grid, CAP, pixel_size=pixels)
    tcore = T.make_stdit3_core(model, grid, pixel_size=pixels)
    sch = RFlowSchedule.create(steps, use_timestep_transform=True, height=48,
                               width=80, num_frames=9)
    rng = np.random.default_rng(3)
    z = rng.standard_normal((1, 3, 6, 10, 4)).astype(np.float32)
    y = rng.standard_normal((2, CAP, NARROW["caption_dim"])).astype(np.float32)
    fps = np.full((2,), 24.0, np.float32)
    mask = np.asarray(mask, np.float32)
    key = jax.random.PRNGKey(11)
    kw = dict(timesteps=sch.timesteps, dts=sch.dts(), lanes=2,
              num_train_timesteps=sch.num_train_timesteps, return_skips=True)
    ecfg = dict(thresh=0.24, K=3)
    jout = jax.jit(lambda p, z_, c, m: jsampler.sample_rflow_masked(
        jcore, p, z_, c, mask=m, noise_key=key, combine_fn=_combine(7.0, 4),
        cache_cfg=j_make_config("opensora-v1.2", steps, **ecfg) if cached else None,
        **kw))(params, jnp.asarray(z), {"y": jnp.asarray(y), "fps": jnp.asarray(fps)},
               jnp.asarray(mask))
    drawn = []

    def noise_fn(step, shape):
        drawn.append(step)
        return _jax_noise(key)(step, shape)

    tout = sample_rflow_masked(
        tcore, torch.from_numpy(z), {"y": torch.from_numpy(y), "fps": torch.from_numpy(fps)},
        mask=mask, noise_fn=noise_fn, combine_fn=_combine(7.0, 4),
        cache_cfg=make_config("opensora-v1.2", steps, **ecfg) if cached else None, **kw)
    np.testing.assert_allclose(tout[0].numpy(), _np(jout[0]), atol=PIPE_TOL, rtol=PIPE_TOL)
    np.testing.assert_array_equal(tout[1], np.asarray(jout[1]))
    assert tout[1].any() == cached
    # frames with mask 0 are never touched; a mask of only 0 and 1 never draws
    frozen = mask[0] == 0
    np.testing.assert_array_equal(tout[0].numpy()[0, frozen], z[0, frozen])
    assert bool(drawn) == bool(((mask > 0) & (mask < 1)).any())


def test_sample_rflow_masked_refuses_lane_caches():
    with pytest.raises(ValueError, match="one cache lane"):
        sample_rflow_masked(None, torch.zeros(1, 2, 2, 2, 4), {}, timesteps=np.ones(4),
                            dts=np.ones(4), num_train_timesteps=1000,
                            mask=np.ones((1, 2)), noise_fn=None,
                            cache_cfg=make_config("wan2.1-t2v-1.3B", 4))


# ---------------------------------------------------------------- helpers
@pytest.mark.parametrize("ms", ["0", "0,0,0,0,1", "0,0,0,0,1,0.5;0,1,-2,-1,3,0",
                                "1,1,-3,0,3,0.25;0,1,1,2,8,1"])
@pytest.mark.parametrize("align", [None, 5, 2])
def test_mask_strategy_helpers_bit_equal_to_jax(ms, align):
    assert toc.MASK_DEFAULT == joc.MASK_DEFAULT
    assert toc.parse_mask_strategy(ms) == joc.parse_mask_strategy(ms)
    for v, p, mx in ((7, 5, 20), (8, 5, 20), (18, 5, 20), (3, 2, 4), (-3, 5, 2)):
        assert toc.find_nearest_point(v, p, mx) == joc.find_nearest_point(v, p, mx)
    rng = np.random.default_rng(4)
    z = rng.standard_normal((2, 9, 3, 4, 4)).astype(np.float32)
    refs = [[rng.standard_normal((n, 3, 4, 4)).astype(np.float32) for n in (1, 6)]
            for _ in range(2)]
    for loop_i in (0, 1):
        zt, zj = z.copy(), z.copy()
        got = toc.apply_mask_strategy(zt, refs, [ms, ""], loop_i, align=align)
        want = joc.apply_mask_strategy(zj, refs, [ms, ""], loop_i, align=align)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(zt, zj)
    assert toc.apply_mask_strategy(z, refs, [], 0) is None
    prev = [rng.standard_normal((9, 3, 4, 4)).astype(np.float32)] * 2
    got = toc.append_generated(None, prev, [list(r) for r in refs], [ms, ""], 1, 3, 0.2)
    want = joc.append_generated(None, prev, [list(r) for r in refs], [ms, ""], 1, 3, 0.2)
    assert got[1] == want[1]
    for a, b in zip(got[0], want[0]):
        assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------- pipeline
def _pipeline_pair(**kw):
    base = dict(tiny=True, num_frames=17, height=32, width=32, num_sampling_steps=6,
                caption_len=6, dtype="float32")
    base.update(kw)
    j = jpipe.OpenSoraPipeline(jpipe.OpenSoraPipelineConfig(**base))
    tcfg = tpipe.OpenSoraPipelineConfig(**base)
    model = T.STDiT3Model(tcfg.model_config(), "cpu")
    model.load_state_dict(stdit3_params_from_numpy(
        jax.tree.map(np.asarray, j.params), tcfg.model_config(), "cpu"))
    return j, tpipe.OpenSoraPipeline(tcfg, "cpu", model=model)


def _feed_jax_draws(monkeypatch, pipe, seed, shape):
    """The port's pipeline draws the JAX pipeline's per-loop noise: key,
    zkey, nkey = split(key, 3) each loop; z from zkey, re-noise from
    fold_in(nkey, step)."""
    state = {"key": j_set_seed(seed)}

    def initial(gen):
        state["key"], zkey, state["nkey"] = jax.random.split(state["key"], 3)
        return torch.from_numpy(_np(jax.random.normal(zkey, (1,) + shape, jnp.float32)))

    monkeypatch.setattr(pipe, "_initial_noise", initial)
    monkeypatch.setattr(pipe, "_renoise_fn", lambda gen: _jax_noise(state["nkey"]))


@pytest.mark.parametrize("kw", [
    dict(ms="0,0,0,0,1,0;0,0,0,4,1,0.5", align=None),           # pin frame 0, edit the last
    dict(ms="0,0,0,0,1,0;0,0,0,4,1,0.5"),                       # align 5 snaps 4 to 0
    dict(ms="0,0,0,0,2,0", loop=2, condition_frame_length=2, align=None),
    dict(loop=2, condition_frame_length=1, condition_frame_edit=0.4, align=None),
    dict(ms="0,0,0,0,5,1.0")])                                  # all ones: the plain loop
@pytest.mark.parametrize("cached", [False, True])
def test_pipeline_references_and_loops_match_jax(kw, cached, tmp_path, monkeypatch):
    jp, tp = _pipeline_pair(use_magcache=cached)
    assert tp.latent_shape == jp.latent_shape == (5, 4, 4, 4)
    rng = np.random.default_rng(8)
    ref = str(tmp_path / "ref.npy")
    np.save(ref, rng.standard_normal((3, 4, 4, 4)).astype(np.float32))
    if "ms" in kw:
        kw = dict(kw, refs=ref)
    _feed_jax_draws(monkeypatch, tp, 5, tp.latent_shape)
    want = jp.generate("a red boat at dawn", seed=5, **kw)
    got = tp.generate("a red boat at dawn", seed=5, **kw)
    loop, cfl = kw.get("loop", 1), kw.get("condition_frame_length", 5)
    assert got.latents.shape == (1, 5 + (loop - 1) * (5 - cfl), 4, 4, 4)
    np.testing.assert_allclose(got.latents.numpy(), _np(want.latents),
                               atol=PIPE_TOL, rtol=PIPE_TOL)
    sched = tp.skip_mask_for()
    np.testing.assert_array_equal(got.skips, np.concatenate([sched] * loop))
    assert got.skips.any() == cached


def test_pipeline_json_prompt_references_match_jax(tmp_path, monkeypatch):
    jp, tp = _pipeline_pair()
    ref = str(tmp_path / "ref.npy")
    np.save(ref, np.random.default_rng(9).standard_normal((2, 4, 4, 4)).astype(np.float32))
    prompt = ("a red boat " + json.dumps({"reference_path": ref,
                                          "mask_strategy": "0,0,0,1,2,0"}))
    _feed_jax_draws(monkeypatch, tp, 2, tp.latent_shape)
    want = jp.generate(prompt, seed=2, align=None)
    got = tp.generate(prompt, seed=2, align=None)
    np.testing.assert_allclose(got.latents.numpy(), _np(want.latents),
                               atol=PIPE_TOL, rtol=PIPE_TOL)
    np.testing.assert_array_equal(got.latents.numpy()[0, 1:3], np.load(ref))


def test_pipeline_refuses_what_needs_the_vae_or_the_plain_trajectory(tmp_path):
    _, tp = _pipeline_pair()
    # a pipeline without vae= cannot encode an image reference
    with pytest.raises(ValueError, match="VAE"):
        tp.generate("a boat", ms="0,0,0,0,1,0", refs=str(tmp_path / "frame.png"))
    _, cal = _pipeline_pair(magcache_calibration=True)
    ref = str(tmp_path / "ref.npy")
    np.save(ref, np.zeros((1, 4, 4, 4), np.float32))
    with pytest.raises(ValueError, match="calibration"):
        cal.generate("a boat", ms="0,0,0,0,1,0", refs=ref)


# ---------------------------------------------------------------- CLI
def test_cli_open_sora_references_and_loop(tmp_path, capsys):
    ref = str(tmp_path / "ref.npy")
    np.save(ref, np.random.default_rng(10).standard_normal((1, 4, 4, 4)).astype(np.float32))
    out = str(tmp_path / "gen")
    cli.main(["--task", "open-sora", "--tiny", "--device", "cpu", "--use_magcache",
              "--sample_steps", "10", "--ms", "0,0,0,0,1,0", "--refs", ref,
              "--loop", "2", "--condition_frame_length", "1", "--align", "1",
              "--save_file", out])
    lat = np.load(out + "_latents.npy")
    assert lat.shape == (1, 3, 4, 4, 4) and np.isfinite(lat).all()
    np.testing.assert_array_equal(lat[0, 0], np.load(ref)[0])
    assert "of 20 forwards" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="VAE"):
        cli.main(["--task", "open-sora", "--tiny", "--device", "cpu",
                  "--ms", "0", "--refs", str(tmp_path / "x.mp4"), "--save_file", out])
