"""The port's TaylorSeer against the JAX package on the CPU: the host
schedule, ``taylor_update`` and ``taylor_forecast``, the generic sampler on
OmniGen2's text-to-image core and the edit route of the pipeline (f32), and
the reference's bf16 edit stack, which the port does not inherit.

The JAX side is pinned to OmniGen2's tiny widths at 32 x 32 pixels (a 2 x 2
token grid), the shape of ``tests/test_torch_omnigen2.py``'s pipelines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.core import taylorseer as JT
from magcache_tpu.models import omnigen2 as J
from magcache_tpu.pipelines import omnigen2 as jpipe
from magcache_tpu.schedulers.flow_match import FlowMatchSchedule as JSchedule
from magcache_tpu.utils.misc import set_seed as j_set_seed
from magcache_tpu_torch.core import taylorseer as TT
from magcache_tpu_torch.core.sampler import DiTCore
from magcache_tpu_torch.models import omnigen2 as T
from magcache_tpu_torch.models.convert import omnigen2_params_from_numpy
from magcache_tpu_torch.pipelines import omnigen2 as tpipe
from magcache_tpu_torch.schedulers.flow_match import FlowMatchSchedule

F32_TOL = 1e-4
TXT = 6


def _np(a):
    return np.array(a, np.float32)


@pytest.mark.parametrize("n, interval, order, warmup",
                         [(50, 4, 2, 3), (20, 4, 2, 3), (28, 3, 3, 1), (7, 5, 1, 0)])
def test_schedule_matches_jax(n, interval, order, warmup):
    cfg = dict(num_steps=n, interval=interval, order=order, warmup=warmup)
    got = TT.taylorseer_schedule(TT.TaylorSeerConfig(**cfg))
    want = JT.taylorseer_schedule(JT.TaylorSeerConfig(**cfg))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    fresh = got[0]
    assert {(50, 4): 15, (20, 4): 7}.get((n, interval), int(fresh.sum())) == fresh.sum()


@pytest.mark.parametrize("order", [1, 2, 3])
def test_update_and_forecast_match_jax(order):
    rng = np.random.default_rng(order)
    derivs = rng.standard_normal((order + 1, 2, 5, 8)).astype(np.float32)
    y = rng.standard_normal((2, 5, 8)).astype(np.float32)
    for ud, hs in ((3.0, 0), (1.0, 1), (4.0, 5)):
        got = TT.taylor_update(torch.from_numpy(derivs), torch.from_numpy(y), ud, hs, order)
        want = JT.taylor_update(jnp.asarray(derivs), jnp.asarray(y), jnp.float32(ud),
                                jnp.int32(hs), order)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), _np(want))
        for xf in (1.0, 2.0, 3.0):
            np.testing.assert_allclose(
                TT.taylor_forecast(got, xf, order).numpy(),
                _np(JT.taylor_forecast(want, jnp.float32(xf), order)), rtol=1e-6, atol=1e-6)
    # a bf16 feature goes into the f32 stack
    stack = TT.taylor_update(torch.zeros(order + 1, 3), torch.ones(3).bfloat16(), 1.0, 0, order)
    assert stack.dtype == torch.float32


def _tree(seed=0):
    params = J.init_omnigen2_params(jax.random.PRNGKey(seed), J.OmniGen2Config.tiny())
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed + 9)
    for grp in ("noise_refiner", "layers"):
        tree[grp]["mod"]["b"] = (rng.standard_normal(tree[grp]["mod"]["b"].shape)
                                 * 0.05).astype(np.float32)
    return tree


def test_generic_sampler_matches_jax_on_the_t2i_core():
    tree = _tree()
    params = jax.tree.map(jnp.asarray, tree)
    cfg = T.OmniGen2Config.tiny()
    model = T.OmniGen2Model(cfg, "cpu")
    model.load_state_dict(omnigen2_params_from_numpy(tree, cfg, "cpu"))
    model.requires_grad_(False)
    n = 9
    ts_kw = dict(num_steps=n, interval=3, order=2, warmup=2)
    sch = FlowMatchSchedule.create(n)
    jsch = JSchedule.create(n)
    np.testing.assert_array_equal(sch.sigmas, jsch.sigmas)
    jcore = J.make_omnigen2_core(J.OmniGen2Config.tiny(), TXT, (2, 2))
    tcore = T.make_omnigen2_core(model, TXT, (2, 2))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 4, 4, 16)).astype(np.float32)
    txt = rng.standard_normal((2, TXT, 24)).astype(np.float32)

    def combine(outs, i):
        return outs[1] + (3.0 + i) * (outs[0] - outs[1])

    want = JT.sample_euler_taylorseer(
        jcore, params, jnp.asarray(x), {"txt": jnp.asarray(txt)}, timesteps=jsch.timesteps,
        dts=np.diff(jsch.sigmas), ts_cfg=JT.TaylorSeerConfig(**ts_kw), lanes=2,
        combine_fn=combine)
    got, skips = TT.sample_euler_taylorseer(
        tcore, torch.from_numpy(x), {"txt": torch.from_numpy(txt)}, timesteps=sch.timesteps,
        dts=np.diff(sch.sigmas), ts_cfg=TT.TaylorSeerConfig(**ts_kw), lanes=2,
        combine_fn=combine, return_skips=True)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=F32_TOL, rtol=F32_TOL)
    fresh = TT.taylorseer_schedule(TT.TaylorSeerConfig(**ts_kw))[0]
    np.testing.assert_array_equal(skips, np.repeat(~fresh[:, None], 2, axis=1))
    # only the fresh steps run the trunk
    runs = []
    spy = DiTCore(tcore.prepare, lambda h, c: runs.append(1) or tcore.trunk(h, c), tcore.head)
    TT.sample_euler_taylorseer(spy, torch.from_numpy(x), {"txt": torch.from_numpy(txt)},
                               timesteps=sch.timesteps, dts=np.diff(sch.sigmas),
                               ts_cfg=TT.TaylorSeerConfig(**ts_kw), lanes=2,
                               combine_fn=combine)
    assert len(runs) == fresh.sum()


def test_sampler_refusals():
    core = DiTCore(lambda x, t, c: (x, {}), lambda h, c, s, i: (h, s), lambda h, c: h,
                   init_state=lambda h, c: None)
    kw = dict(timesteps=np.ones(4, np.float32), dts=np.ones(4, np.float32),
              ts_cfg=TT.TaylorSeerConfig(num_steps=4))
    with pytest.raises(ValueError, match="stateless"):
        TT.sample_euler_taylorseer(core, torch.zeros(1, 2), None, **kw)
    plain = DiTCore(core.prepare, lambda h, c: h, core.head)
    with pytest.raises(ValueError, match="schedule of 5 steps"):
        TT.sample_euler_taylorseer(plain, torch.zeros(1, 2), None, **dict(
            kw, ts_cfg=TT.TaylorSeerConfig(num_steps=5)))


def _pipelines(mode, dtype, monkeypatch, steps=8):
    base = dict(mode=mode, tiny=True, height=32, width=32, num_inference_steps=steps,
                txt_len=TXT, dtype=dtype, enable_taylorseer=True, taylorseer_warmup=2,
                taylorseer_interval=3)
    tree = _tree()
    if dtype == "bfloat16":
        tree = jax.tree.map(np.asarray, J.init_omnigen2_params(
            jax.random.PRNGKey(0), J.OmniGen2Config.tiny(dtype=dtype)))
    jp = jpipe.OmniGen2Pipeline(jpipe.OmniGen2PipelineConfig(**base),
                                params=jax.tree.map(jnp.asarray, tree))
    tcfg = tpipe.OmniGen2PipelineConfig(**base)
    model = T.OmniGen2Model(tcfg.model_config(), "cpu")
    model.load_state_dict(omnigen2_params_from_numpy(tree, tcfg.model_config(), "cpu"))
    tp = tpipe.OmniGen2Pipeline(tcfg, "cpu", model=model)
    z = _np(jax.random.normal(j_set_seed(5), (1, 4, 4, 16), jnp.float32))
    monkeypatch.setattr(tp, "_initial_noise", lambda seed: torch.from_numpy(z))
    return jp, tp


@pytest.mark.parametrize("mode", ["t2i", "edit"])
def test_pipeline_taylorseer_matches_jax_in_f32(mode, monkeypatch):
    jp, tp = _pipelines(mode, "float32", monkeypatch)
    ref = np.random.default_rng(6).standard_normal((1, 1, 4, 4, 16)).astype(np.float32)
    gen = dict(ref_latents=ref) if mode == "edit" else {}
    want = jp.generate("a fox", seed=5, **{k: jnp.asarray(v) for k, v in gen.items()})
    got = tp.generate("a fox", seed=5, **{k: torch.from_numpy(v) for k, v in gen.items()})
    np.testing.assert_allclose(got.latents.numpy(), _np(want.latents), atol=F32_TOL,
                               rtol=F32_TOL)
    fresh = TT.taylorseer_schedule(tp._ts_config())[0]
    assert got.skips.shape == (8, tp.lanes) and (got.skips.all(1) == ~fresh).all()


def test_bf16_edit_stack_is_f32_in_the_port_not_in_jax(monkeypatch):
    """The reference's edit route builds its two derivative stacks in the
    trunk's dtype (``pipelines/omnigen2.py:434-435``), bf16 under a bf16
    config, where its generic sampler keeps f32 (``core/taylorseer.py:170``).
    There its forecast promotes to f32 (``taylor_forecast`` divides by f32
    factorials) while the fresh branch stays bf16, and ``lax.cond`` refuses
    the pair: the bf16 edit route raises at trace time. The port keeps f32
    stacks in both modes and runs."""
    seen = {"jax": [], "port": []}
    j_update, t_update = JT.taylor_update, TT.taylor_update

    def j_spy(derivs, *a):
        seen["jax"].append(derivs.dtype)
        return j_update(derivs, *a)

    def t_spy(derivs, *a):
        seen["port"].append(derivs.dtype)
        return t_update(derivs, *a)

    monkeypatch.setattr(JT, "taylor_update", j_spy)
    monkeypatch.setattr(tpipe, "taylor_update", t_spy)
    monkeypatch.setattr(TT, "taylor_update", t_spy)
    for mode in ("edit", "t2i"):
        jp, tp = _pipelines(mode, "bfloat16", monkeypatch, steps=4)
        if mode == "edit":
            with pytest.raises(TypeError, match="cond branches must have equal output types"):
                jp.generate("a fox", seed=5)
        else:
            jp.generate("a fox", seed=5)
        out = tp.generate("a fox", seed=5)
        assert np.isfinite(out.latents.numpy()).all()
        j_dtypes, t_dtypes = set(seen["jax"]), set(seen["port"])
        assert t_dtypes == {torch.float32}
        assert j_dtypes == ({jnp.dtype(jnp.bfloat16)} if mode == "edit"
                            else {jnp.dtype(jnp.float32)})
        seen["jax"].clear()
        seen["port"].clear()
