"""The port's TeaCache against the JAX package: the Wan pipeline's per-lane
policy (both signals) and ``sample_euler_teacache``, in f32 with the same
weights and inputs. The realized skip bits must be identical; each test's
threshold sits far from every accumulator value it is compared with (the
test checks the margin), so summation order cannot flip a decision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.core import teacache as jtea
from magcache_tpu.schedulers.flow_match import FlowMatchSchedule as JFlow
from magcache_tpu_torch.cli import generate as cli
from magcache_tpu_torch.core import teacache as ttea
from magcache_tpu_torch.pipelines import wan as tpipe
from tests.test_torch_sampler import _sampler_setup
from tests.test_torch_solvers import TOL, run_wan_pair


def test_wan_coefficients_and_settings_match_jax():
    assert ttea.WAN_TEA_COEFFS == jtea.WAN_TEA_COEFFS
    assert ttea.OPEN_SORA_TEA_COEFFS == jtea.OPEN_SORA_TEA_COEFFS
    assert ttea.FRAMEPACK_TEA_COEFFS == jtea.FRAMEPACK_TEA_COEFFS
    assert ttea.FRAMEPACK_TEA_THRESH == jtea.FRAMEPACK_TEA_THRESH
    for key in ttea.WAN_TEA_COEFFS:
        for steps in (10, 50):
            assert (ttea.wan_teacache_settings(key[0], steps, key[1])
                    == jtea.wan_teacache_settings(key[0], steps, key[1]))
    kw = dict(thresh=0.2, coefficients=(1.0, 2.0), ret_steps=4, cutoff_steps=14)
    np.testing.assert_array_equal(ttea.TeaCacheLanes(**kw).forced_mask(8),
                                  jtea.TeaCacheLanes(**kw).forced_mask(8))


def test_polyval_is_jax_horner_in_f32():
    # XLA may fuse a step into one FMA: one f32 rounding of the largest
    # term apart, at most
    x = np.linspace(-3, 3, 101).astype(np.float32)
    for c in ttea.WAN_TEA_COEFFS.values():
        want = np.asarray(jnp.polyval(jnp.asarray(c, jnp.float32), x))
        np.testing.assert_allclose(ttea._polyval(np.asarray(c, np.float32), x), want,
                                   rtol=2e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("steps,thresh,ret", [(10, 1500.0, False), (12, 0.2, True)])
def test_wan_teacache_matches_jax(steps, thresh, ret, monkeypatch):
    """Without ret steps the tiny model's accumulators run from ~150 to
    ~13,000 (the t2v-1.3B polynomial off its fitted range), so 1,500 skips a
    few steps and resets; with them every unforced value is below -9,000, so
    the published 0.2 skips every step past the 10-step window."""
    tried = []
    decide = ttea.TeaCacheLanes.decide

    def spy(self, hidden, ctx, state, forced):
        sig = self.signal_fn(hidden, ctx)
        acc = state[1] + ttea._polyval(np.asarray(self.coefficients, np.float32),
                                       ttea._rel_l1(sig, state[0], self.lanes))
        tried.append(acc[~forced])
        return decide(self, hidden, ctx, state, forced)

    monkeypatch.setattr(ttea.TeaCacheLanes, "decide", spy)
    want, got, tp = run_wan_pair(monkeypatch, sample_steps=steps, enable_teacache=True,
                                 teacache_thresh=thresh, use_ret_steps=ret)
    np.testing.assert_array_equal(got.skips, np.asarray(want.skips))
    forced = tp._teacache_lanes().forced_mask(steps)
    assert got.skips.any() and not (got.skips & forced).any()
    margin = np.abs(np.concatenate(tried) - thresh).min()
    assert margin > 0.05 * abs(thresh), margin
    np.testing.assert_allclose(got.latents.numpy(), np.asarray(want.latents),
                               atol=TOL, rtol=TOL)


def test_wan_teacache_refusals():
    base = dict(tiny=True, size=(64, 32), frame_num=9, sample_steps=4,
                dtype="float32", enable_teacache=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tpipe.WanPipeline(tpipe.WanPipelineConfig(use_magcache=True, **base),
                          "cpu").generate("a")
    with pytest.raises(ValueError, match="unipc"):
        tpipe.WanPipeline(tpipe.WanPipelineConfig(sample_solver="dpm++", **base),
                          "cpu").generate("a")
    # TeaCache runs under sequence parallelism (tests/test_torch_sp_wan_tasks.py)
    assert tpipe.WanPipelineConfig(sp=2, **base).enable_teacache


def test_sample_euler_teacache_matches_jax():
    jcore, params, tcore, x, ctx = _sampler_setup()
    sch = JFlow.create(8, shift=5.0)
    kw = dict(timesteps=sch.timesteps, dts=np.diff(sch.sigmas), guidance_scale=5.0)
    # the trunk input as the signal: the Open-Sora polynomial gives 0.079,
    # 0.092, 0.119, 0.160, ... a step, so steps 1 and 3 skip and every
    # accumulator sits >= 0.02 from the threshold 0.15
    want = jtea.sample_euler_teacache(jcore, params, jnp.asarray(x),
                                      {"context": jnp.asarray(ctx)},
                                      tea_cfg=jtea.TeaCacheConfig(0.15), **kw)
    got = ttea.sample_euler_teacache(tcore, torch.from_numpy(x),
                                     {"context": torch.from_numpy(ctx)},
                                     tea_cfg=ttea.TeaCacheConfig(0.15), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("ret", [False, True])
def test_cli_teacache_flags(ret, tmp_path, capsys):
    out = str(tmp_path / "out")
    cli.main(["--tiny", "--device", "cpu", "--sample_steps", "12", "--enable_teacache",
              "--teacache_thresh", "1e9", "--save_file", out]
             + (["--use_ret_steps"] if ret else []))
    assert np.isfinite(np.load(out + "_latents.npy")).all()
    text = capsys.readouterr().out
    # forced window: 1 step a lane and the last without ret steps, 10 with
    skipped = int([l for l in text.splitlines() if l.startswith("skipped")][-1].split()[1])
    assert skipped == (4 if ret else 20) and "mode=teacache" in text
    with pytest.raises(SystemExit, match="does not apply"):
        cli.main(["--task", "latte", "--tiny", "--device", "cpu", "--enable_teacache"])
