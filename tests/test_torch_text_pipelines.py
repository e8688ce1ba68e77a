"""The ported text encoders in the pipelines' slots, against the JAX
pipelines given the JAX encoders, on the CPU at tiny widths: FLUX with T5 and
CLIP pooled, Vchitect with the SD3 stack (a context of CLIP length + T5
length tokens, the two CLIP widths zero-padded to the T5 width = the trunk's
``text_dim``, the two projections filling ``vec_dim``), Open-Sora-Plan v1.2
with mT5 and Latte with T5. Each request runs from the same prompt and the
same weights, with MagCache on, to latents; the skip bits are equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from magcache_tpu.core.magcache import compute_skip_schedule as j_skip_schedule
from magcache_tpu.models import clip as JC
from magcache_tpu.models import text as JT
from magcache_tpu.pipelines import flux as jflux
from magcache_tpu.pipelines import latte as jlatte
from magcache_tpu.pipelines import open_sora_plan as josp
from magcache_tpu.pipelines import vchitect as jvch
from magcache_tpu.utils.misc import set_seed as j_set_seed
from magcache_tpu_torch.models import clip as C
from magcache_tpu_torch.models import t5 as T5
from magcache_tpu_torch.models import text as TT
from magcache_tpu_torch.models.convert import (clip_text_params_from_numpy, flux_params_from_numpy,
                                               latte_params_from_numpy, osp_params_from_numpy,
                                               t5_params_from_flax, vchitect_params_from_numpy)
from magcache_tpu_torch.models.flux import FluxModel
from magcache_tpu_torch.models.latte import LatteModel
from magcache_tpu_torch.models.open_sora_plan import OSPModel
from magcache_tpu_torch.models.vchitect import VchitectModel
from magcache_tpu_torch.pipelines import flux as tflux
from magcache_tpu_torch.pipelines import latte as tlatte
from magcache_tpu_torch.pipelines import open_sora_plan as tosp
from magcache_tpu_torch.pipelines import vchitect as tvch
from tests.test_torch_clip_text import _stack_pair
from tests.test_torch_latte import _latents_close
from tests.test_torch_osp import _feed_jax_noise
from tests.test_torch_t5 import _hf

PROMPT = "A red sailboat glides across a calm bay at dawn."


def _np(a):
    return np.array(a, np.float32)


def _t5_pair(d_model, seq_len, hf_cls=transformers.T5Config, vocab=300):
    """A gated-gelu T5 (or mT5) encoder of width ``d_model`` on both sides:
    the JAX one's Flax init, converted."""
    kw = dict(vocab_size=vocab, d_model=d_model, d_kv=8, d_ff=2 * d_model, layers=2,
              heads=d_model // 8, rel_buckets=8, rel_max_distance=16)
    extra = {} if hf_cls is transformers.MT5Config else dict(feed_forward_proj="gated-gelu")
    jenc = JT.JaxT5Encoder(hf_cls(**_hf(kw), **extra), seq_len=seq_len,
                           tokenizer=JT.FallbackHashTokenizer(vocab))
    cfg = T5.T5Config(**kw)
    model = T5.T5Model(cfg, "cpu")
    model.load_state_dict(t5_params_from_flax(jax.tree.map(np.asarray, jenc.params), cfg))
    return jenc, TT.T5Encoder(cfg, seq_len=seq_len, tokenizer=TT.FallbackHashTokenizer(vocab),
                              model=model)


def test_flux_with_t5_and_clip_pooled_matches_jax(monkeypatch, capsys):
    txt = 8
    base = dict(tiny=True, height=64, width=64, num_inference_steps=10, txt_len=txt,
                dtype="float32", model="flux-dev", use_magcache=True, magcache_thresh=0.5,
                magcache_K=2)
    jt5, tt5 = _t5_pair(32, txt)                        # FluxConfig.tiny: text_dim 32
    ccfg = dict(dim=16, heads=2, layers=2)              # vec_dim 16: the un-projected pool
    jcfg = JC.CLIPTextConfig.tiny(**ccfg)
    tree = jax.tree.map(np.asarray, JC.init_clip_text_params(jax.random.PRNGKey(1), jcfg))
    tcfg = C.CLIPTextConfig.tiny(**ccfg)
    clip = C.CLIPTextModel(tcfg, "cpu")
    clip.load_state_dict(clip_text_params_from_numpy(tree, tcfg))
    jclip = JT.ClipTextEncoder(jcfg, params=jax.tree.map(jnp.asarray, tree),
                               tokenizer=JT.FallbackHashTokenizer(96, eos_token_id=95))
    tclip = TT.ClipTextEncoder(tcfg, model=clip)
    jp = jflux.FluxPipeline(jflux.FluxPipelineConfig(**base), text_encoder=jt5,
                            pooled_encoder=jclip)
    pcfg = tflux.FluxPipelineConfig(**base)
    model = FluxModel(pcfg.model_config(), "cpu")
    model.load_state_dict(flux_params_from_numpy(jax.tree.map(np.asarray, jp.params),
                                                 pcfg.model_config(), "cpu"))
    tp = tflux.FluxPipeline(pcfg, "cpu", text_encoder=tt5, pooled_encoder=tclip, model=model)
    # the JAX pipeline fed t / 1000 (tests/test_torch_flux.py); JAX's noise
    sch = jp._schedule()
    fixed = dataclasses.replace(sch, timesteps=(sch.timesteps / 1000).astype(np.float32))
    monkeypatch.setattr(jp, "_schedule", lambda: fixed)
    z = _np(jax.random.normal(j_set_seed(5), (1, 16, 16), jnp.float32))
    monkeypatch.setattr(tp, "_initial_noise", lambda seed: torch.from_numpy(z))
    jp.record_skips = True
    want = jp.generate(PROMPT, seed=5)
    got = tp.generate(PROMPT, seed=5)
    np.testing.assert_allclose(got.latents.numpy(), _np(want.latents), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got.skips, np.asarray(want.skips))
    assert got.skips.any() and got.timings["text_s"] > 0


def test_vchitect_with_the_sd3_stack_matches_jax(monkeypatch, capsys):
    jstack, tstack = _stack_pair(capsys)         # CLIP 2 x 12 (+ proj 2 x 8), T5 24
    txt = tstack.clip_l.seq_len + tstack.t5.seq_len
    base = dict(tiny=True, num_frames=4, height=32, width=32, txt_len=txt,
                num_inference_steps=6, dtype="float32", use_magcache=True,
                magcache_ratios=tuple(np.linspace(1.0, 0.9, 10)))
    jp = jvch.VchitectPipeline(jvch.VchitectPipelineConfig(**base), text_encoder=jstack.context,
                               pooled_encoder=jstack.pooled)
    mcfg = jp.model_cfg
    assert (mcfg.text_dim, mcfg.vec_dim) == (24, 16) and txt == 14
    pcfg = tvch.VchitectPipelineConfig(**base)
    model = VchitectModel(pcfg.model_config(), "cpu")
    model.load_state_dict(vchitect_params_from_numpy(jax.tree.map(np.asarray, jp.params),
                                                     pcfg.model_config(), "cpu"))
    tp = tvch.VchitectPipeline(pcfg, "cpu", text_encoder=tstack.context,
                               pooled_encoder=tstack.pooled, model=model)
    z = _np(jax.random.normal(j_set_seed(5), (1,) + jp.latent_shape, jnp.float32))
    monkeypatch.setattr(tp, "_initial_noise", lambda gen: torch.from_numpy(z))
    want = jp.generate(PROMPT, seed=5)
    got = tp.generate(PROMPT, seed=5)
    _latents_close(got.latents.numpy(), _np(want.latents))
    np.testing.assert_array_equal(got.skips, j_skip_schedule(jp._cache_cfg()).reshape(6, 2))
    assert got.skips.any() and got.timings["text_s"] > 0


def test_open_sora_plan_v120_with_mt5_matches_jax(monkeypatch, capsys):
    monkeypatch.setenv("MAGCACHE_STDIT3_PACKED", "0")
    base = dict(tiny=True, num_frames=5, height=32, width=48, num_inference_steps=4,
                caption_len=6, dtype="float32", use_magcache=True, magcache_thresh=0.3)
    jt5, tt5 = _t5_pair(24, 6, transformers.MT5Config, vocab=500)
    jp = josp.OpenSoraPlanPipeline(josp.OpenSoraPlanPipelineConfig(**base), text_encoder=jt5)
    pcfg = tosp.OpenSoraPlanPipelineConfig(route="unpacked", **base)
    model = OSPModel(pcfg.model_config(), "cpu")
    model.load_state_dict(osp_params_from_numpy(jax.tree.map(np.asarray, jp.params),
                                                pcfg.model_config(), "cpu"))
    tp = tosp.OpenSoraPlanPipeline(pcfg, "cpu", text_encoder=tt5, model=model)
    _feed_jax_noise(jp, tp, 5, monkeypatch)
    want = jp.generate(PROMPT, seed=5)
    got = tp.generate(PROMPT, seed=5)
    _latents_close(got.latents.numpy(), _np(want.latents))
    np.testing.assert_array_equal(got.skips, j_skip_schedule(jp._cache_cfg()).reshape(4, 2))
    assert got.skips.any() and got.timings["text_s"] > 0


def test_latte_with_t5_matches_jax(monkeypatch, capsys):
    monkeypatch.setenv("MAGCACHE_STDIT3_PACKED", "0")
    base = dict(tiny=True, num_frames=4, height=64, width=64, num_sampling_steps=10,
                caption_len=6, dtype="float32", use_magcache=True,
                magcache_ratios=tuple(np.linspace(1.0, 0.96, 9)))
    jt5, tt5 = _t5_pair(24, 6)
    jp = jlatte.LattePipeline(jlatte.LattePipelineConfig(**base), text_encoder=jt5)
    pcfg = tlatte.LattePipelineConfig(route="grouped", **base)
    model = LatteModel(pcfg.model_config(), "cpu")
    model.load_state_dict(latte_params_from_numpy(jax.tree.map(np.asarray, jp.params),
                                                  pcfg.model_config(), "cpu"))
    tp = tlatte.LattePipeline(pcfg, "cpu", text_encoder=tt5, model=model)
    z = _np(jax.random.normal(j_set_seed(5), (1,) + jp.latent_shape, jnp.float32))
    monkeypatch.setattr(tp, "_initial_noise", lambda gen: torch.from_numpy(z))
    want = jp.generate(PROMPT, seed=5)
    got = tp.generate(PROMPT, seed=5)
    _latents_close(got.latents.numpy(), _np(want.latents))
    np.testing.assert_array_equal(got.skips, jp.skip_mask_for(use_magcache=True))
    assert got.skips.any() and got.timings["text_s"] > 0


@pytest.mark.parametrize("family", ["flux", "vchitect", "open-sora-plan", "latte"])
def test_full_size_slots_take_the_ported_encoders(family):
    """Each family's slot at its published length and width (meta tensors:
    shapes only): T5-XXL 4,096 wide, mT5-XXL for Open-Sora-Plan, CLIP-L's
    pooled 768 for FLUX, the SD3 stack's 77 + 256 tokens for Vchitect."""
    from magcache_tpu_torch.models.flux import FluxConfig
    from magcache_tpu_torch.models.latte import LATTE_1
    from magcache_tpu_torch.models.open_sora_plan import OSP_V120
    from magcache_tpu_torch.models.vchitect import VchitectConfig
    txt, width = {"flux": (tflux.FluxPipelineConfig().txt_len, FluxConfig().text_dim),
                  "vchitect": (77 + 256, VchitectConfig().text_dim),
                  "open-sora-plan": (tosp.OpenSoraPlanPipelineConfig().caption_len,
                                     OSP_V120.caption_dim),
                  "latte": (tlatte.LattePipelineConfig().caption_len,
                            LATTE_1.caption_dim)}[family]
    t5 = T5.MT5_XXL if family == "open-sora-plan" else T5.T5_V1_1_XXL
    assert (txt, width) == ({"flux": 512, "vchitect": 333, "open-sora-plan": 512,
                             "latte": 120}[family], t5.d_model)
    if family == "flux":
        assert C.CLIP_L.dim == FluxConfig().vec_dim and C.CLIP_L.projection_dim is None
    if family == "vchitect":
        assert C.CLIP_L_SD3.dim + C.CLIP_BIGG.dim <= t5.d_model
        assert C.CLIP_L_SD3.projection_dim + C.CLIP_BIGG.projection_dim == \
            VchitectConfig().vec_dim
