"""The port's UMT5 encoder and hash tokenizer against the JAX package on the
CPU: ``FallbackHashTokenizer`` ids, ``relative_position_buckets``,
``umt5_encode`` with an attention mask (same weights through
``umt5_params_from_numpy``), and ``UMT5Encoder`` on prompts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.models import text as JT
from magcache_tpu.models import umt5 as JU
from magcache_tpu_torch.models import text as TT
from magcache_tpu_torch.models import umt5 as TU
from magcache_tpu_torch.models.convert import umt5_params_from_numpy

# f32 on both sides: GEMM and reduction order only (measured ~2e-6 at
# |h| < 4)
F32_TOL = 1e-4
PROMPTS = ["Two anthropomorphic cats fight on a stage.", "",
           "色调艳丽，过曝 a b c d e f g h i j k l m n o p q r s t u v w x y z"]


def _pair(cfg_kw, seed=0):
    jcfg, tcfg = JU.UMT5Config.tiny(**cfg_kw), TU.UMT5Config.tiny(**cfg_kw)
    params = JU.init_umt5_params(jax.random.PRNGKey(seed), jcfg)
    model = TU.UMT5Model(tcfg, "cpu")
    model.load_state_dict(umt5_params_from_numpy(jax.tree.map(np.asarray, params), tcfg))
    return jcfg, params, model


@pytest.mark.parametrize("vocab,eos,pad,max_len", [(256384, 1, 0, 512), (128, 1, 0, 16),
                                                   (49408, 49407, 49407, 77), (5, 1, 0, 8)])
def test_hash_tokenizer_ids_equal_jax(vocab, eos, pad, max_len, capsys):
    got = TT.FallbackHashTokenizer(vocab, eos, pad)(PROMPTS, max_length=max_len)
    want = JT.FallbackHashTokenizer(vocab, eos, pad)(PROMPTS, max_length=max_len)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype == np.int64
    assert "WARNING" in capsys.readouterr().out
    with pytest.raises(ValueError, match="too small"):
        TT.FallbackHashTokenizer(4)(["a"])


@pytest.mark.parametrize("q,k,nb,md", [(512, 512, 32, 128), (20, 20, 8, 16),
                                       (7, 300, 32, 128), (1, 1, 32, 128)])
def test_relative_position_buckets_equal_jax(q, k, nb, md):
    got = TU.relative_position_buckets(q, k, nb, md)
    np.testing.assert_array_equal(got, JU.relative_position_buckets(q, k, nb, md))
    assert got.dtype == np.int64 and got.max() < nb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_umt5_encode_with_mask_matches_jax(dtype):
    jcfg, params, model = _pair(dict(dtype=dtype))
    rng = np.random.default_rng(1)
    ids = rng.integers(2, jcfg.vocab_size, (3, 24))
    mask = np.ones((3, 24), np.int64)
    mask[1, 10:] = 0
    mask[2, 1:] = 0
    want = np.asarray(JU.umt5_encode(params, jcfg, jnp.asarray(ids), jnp.asarray(mask)),
                      np.float32)
    got = TU.umt5_encode(model, torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == model.cfg.torch_dtype and got.shape == (3, 24, 32)
    got = got.float().numpy()
    assert (got[1, 10:] == 0).all() and (got[2, 1:] == 0).all()
    if dtype == "bfloat16":     # bf16 GEMMs, reductions in another order
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-2
        return
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    # without a mask: every position counts
    np.testing.assert_allclose(
        TU.umt5_encode(model, torch.from_numpy(ids)).numpy(),
        np.asarray(JU.umt5_encode(params, jcfg, jnp.asarray(ids)), np.float32),
        atol=F32_TOL, rtol=F32_TOL)


def test_umt5_encoder_on_prompts_matches_jax(capsys):
    jcfg, _, model = _pair(dict(d_model=24, heads=4, d_kv=8))
    tok = dict(vocab_size=jcfg.vocab_size, eos_token_id=1, pad_token_id=0)
    jenc = JU.UMT5Encoder(jcfg, seq_len=16, tokenizer=JT.FallbackHashTokenizer(**tok))
    # the JAX encoder's own random weights (PRNGKey 0), converted
    model.load_state_dict(umt5_params_from_numpy(jax.tree.map(np.asarray, jenc.params),
                                                 model.cfg))
    tenc = TU.UMT5Encoder(model.cfg, seq_len=16, model=model,
                          tokenizer=TT.FallbackHashTokenizer(**tok))
    want = np.asarray(jenc(PROMPTS), np.float32)
    got = tenc(PROMPTS, device="cpu")
    assert got.shape == (3, 16, 24)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)
    ids = np.array([[5, 9, 1, 0]])
    np.testing.assert_allclose(tenc.encode_ids(ids).numpy(),
                               np.asarray(jenc.encode_ids(ids), np.float32),
                               atol=F32_TOL, rtol=F32_TOL)
    with pytest.raises(ValueError, match="tokenizer"):
        TU.UMT5Encoder(model.cfg, model=model)(["a"])


def test_umt5_random_init_follows_jax_draws():
    cfg = TU.UMT5Config.tiny(d_model=64, d_ff=128)
    enc = TU.UMT5Encoder(cfg, seq_len=8, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    m = enc.model
    assert not any(p.requires_grad for p in m.parameters())
    assert (m.final_ln == 1).all() and (m.blocks[0].ln2 == 1).all()
    assert abs(float(m.embed.std()) - 1.0) < 0.05
    assert abs(float(m.blocks[1].wi0.weight.std()) - 64 ** -0.5) < 0.1 * 64 ** -0.5
    assert abs(float(m.blocks[2].rel.std()) - 0.1) < 0.05
    out = enc.encode_ids(np.arange(2, 10)[None])
    assert out.shape == (1, 8, 64) and torch.isfinite(out).all()
    assert TU.UMT5_XXL.inner == 4096 and TU.UMT5_XXL.vocab_size == 256384
