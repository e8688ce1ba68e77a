"""The port's T5-family encoder (``models/t5.py``, ``models.text.T5Encoder``,
``make_t5_encoder``, ``t5_params_from_flax``) against the JAX package on the
CPU: classic T5 (relu), T5 v1.1 (gated-gelu) and mT5 against
``JaxT5Encoder`` (HF Flax) with padded masks and on prompts, UMT5 through
the same code against ``magcache_tpu.models.umt5``, the shared versus
per-layer relative bias, the routing of configs, the random init's scales
and the presets' sizes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from magcache_tpu.models import text as JT
from magcache_tpu.models import umt5 as JU
from magcache_tpu_torch.models import t5 as T
from magcache_tpu_torch.models import text as TT
from magcache_tpu_torch.models import umt5 as TU
from magcache_tpu_torch.models.convert import t5_params_from_flax, umt5_params_from_numpy

# f32 on both sides: GEMM and reduction order only, held against the
# largest value (the JAX package's tests hold Flax against HF at 2e-4)
F32_TOL = 1e-4
PROMPTS = ["Two anthropomorphic cats fight on a stage.", "",
           "a b c d e f g h i j k l m n o p q r s t u v w x y z"]
TINY = dict(vocab_size=300, d_model=32, d_kv=8, d_ff=64, layers=3, heads=4, rel_buckets=8,
            rel_max_distance=16)
# the transformers configs the JAX package's JaxT5Encoder takes
HF = {"t5-relu": lambda: transformers.T5Config(**_hf(TINY)),
      "t5-gated": lambda: transformers.T5Config(feed_forward_proj="gated-gelu", **_hf(TINY)),
      "mt5": lambda: transformers.MT5Config(**_hf(TINY))}
FEED_FORWARD = {"t5-relu": "relu", "t5-gated": "gated-gelu", "mt5": "gated-gelu"}


def _hf(kw):
    return dict(vocab_size=kw["vocab_size"], d_model=kw["d_model"], d_kv=kw["d_kv"],
                d_ff=kw["d_ff"], num_layers=kw["layers"], num_heads=kw["heads"],
                relative_attention_num_buckets=kw["rel_buckets"],
                relative_attention_max_distance=kw["rel_max_distance"])


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()


def _pair(family, seq_len=16, tokenizer=None):
    """The JAX encoder of ``family`` (its Flax init) and the port's with its
    weights."""
    jenc = JT.JaxT5Encoder(HF[family](), seq_len=seq_len, tokenizer=tokenizer)
    cfg = T.T5Config.tiny(**TINY, feed_forward=FEED_FORWARD[family])
    model = T.T5Model(cfg, "cpu")
    model.load_state_dict(t5_params_from_flax(jax.tree.map(np.asarray, jenc.params), cfg))
    return jenc, TT.T5Encoder(cfg, seq_len=seq_len, tokenizer=tokenizer, model=model)


@pytest.mark.parametrize("family", list(HF))
def test_t5_encode_with_mask_matches_flax(family):
    jenc, tenc = _pair(family)
    rng = np.random.default_rng(1)
    ids = rng.integers(2, TINY["vocab_size"], (3, 24))
    mask = np.ones((3, 24), np.int64)
    mask[1, 10:] = 0
    mask[2, 1:] = 0
    got = tenc.encode_ids(ids, mask)
    assert got.dtype == torch.float32 and got.shape == (3, 24, 32)
    _close(got, jenc.encode_ids(ids, mask))
    assert (got[1, 10:] == 0).all() and (got[2, 1:] == 0).all()
    _close(tenc.encode_ids(ids), jenc.encode_ids(ids))       # no mask: every key counts


@pytest.mark.parametrize("family", ["t5-gated", "mt5"])
def test_t5_encoder_on_prompts_matches_flax(family, capsys):
    tok = TT.FallbackHashTokenizer(TINY["vocab_size"])
    jenc, tenc = _pair(family, seq_len=20, tokenizer=JT.FallbackHashTokenizer(TINY["vocab_size"]))
    tenc.tokenizer = tok
    got = tenc(PROMPTS, device="cpu")
    _close(got, jenc(PROMPTS))
    mask = torch.from_numpy(tok(PROMPTS, max_length=20)["attention_mask"])
    assert (got[mask == 0] == 0).all() and (got[mask == 1] != 0).any(-1).all()
    with pytest.raises(ValueError, match="tokenizer"):
        TT.T5Encoder(tenc.cfg, model=tenc.model)(["a"])


def test_umt5_config_runs_the_same_encoder_and_matches_jax():
    cfg = T.UMT5Config.tiny(d_model=24, heads=3, d_kv=8)
    params = JU.init_umt5_params(jax.random.PRNGKey(2), JU.UMT5Config.tiny(
        d_model=24, heads=3, d_kv=8))
    enc = TT.make_t5_encoder(cfg, model=T.T5Model(cfg, "cpu"))
    enc.model.load_state_dict(umt5_params_from_numpy(jax.tree.map(np.asarray, params), cfg))
    ids = np.random.default_rng(3).integers(2, 128, (2, 20))
    mask = np.ones_like(ids)
    mask[0, 12:] = 0
    want = JU.umt5_encode(params, JU.UMT5Config.tiny(d_model=24, heads=3, d_kv=8),
                          jnp.asarray(ids), jnp.asarray(mask))
    _close(enc.encode_ids(ids, mask), want)
    # one encoder function: the UMT5 names are the T5 ones
    assert TU.umt5_encode is T.t5_encode and TU.UMT5Encoder is TT.T5Encoder
    assert TU.UMT5Model is T.T5Model and type(enc) is TT.T5Encoder


def _bias_tables(model):
    return [blk.rel is not None for blk in model.blocks]


def test_shared_and_per_layer_bias():
    """T5 and mT5 keep block 0's table for every layer; UMT5 a table a
    layer. With every UMT5 table equal to block 0's, the two encoders agree;
    with its own tables, UMT5 differs."""
    shared_cfg = T.T5Config.tiny(**TINY)
    umt5_cfg = T.UMT5Config.tiny(**TINY)
    shared = T.T5Model(shared_cfg, "cpu").init(torch.Generator().manual_seed(4))
    per_layer = T.T5Model(umt5_cfg, "cpu").init(torch.Generator().manual_seed(5))
    assert _bias_tables(shared) == [True, False, False]
    assert _bias_tables(per_layer) == [True, True, True]
    sd = dict(shared.state_dict())
    own = {k: v for k, v in per_layer.state_dict().items() if ".rel" in k}
    ids = torch.from_numpy(np.random.default_rng(6).integers(2, 300, (2, 40)))
    want = T.t5_encode(shared, ids)
    copied = T.T5Model(umt5_cfg, "cpu")
    copied.load_state_dict({**sd, **{k: sd["blocks.0.rel"] for k in own}})
    torch.testing.assert_close(T.t5_encode(copied, ids), want, atol=0, rtol=0)
    distinct = T.T5Model(umt5_cfg, "cpu")
    distinct.load_state_dict({**sd, **own, "blocks.0.rel": sd["blocks.0.rel"]})
    assert (T.t5_encode(distinct, ids) - want).abs().max() > 1e-3
    with pytest.raises(ValueError, match="per-layer"):
        t5_params_from_flax({}, umt5_cfg)


def test_make_t5_encoder_routes_configs_as_jax():
    for cfg, tables in ((T.UMT5Config.tiny(), [True] * 3), (T.T5Config.tiny(), [True, False,
                                                                                False]),
                        (T.T5Config.tiny(feed_forward="relu"), [True, False, False])):
        enc = TT.make_t5_encoder(cfg, seq_len=12, device="cpu")
        assert _bias_tables(enc.model) == tables and enc.seq_len == 12
        assert enc.model.blocks[0].relu == (cfg.feed_forward == "relu")
    # the JAX routing: a UMT5 config takes the per-layer-bias encoder, a
    # transformers T5 config the Flax one (block 0's bias)
    assert isinstance(JT.make_t5_encoder(JU.UMT5Config.tiny(), seq_len=8), JU.UMT5Encoder)
    assert isinstance(JT.make_t5_encoder(HF["t5-relu"](), seq_len=8), JT.JaxT5Encoder)
    with pytest.raises(ValueError, match="feed_forward"):
        T.T5Config(feed_forward="swiglu")


def test_random_init_follows_the_flax_scales():
    kw = dict(vocab_size=512, d_model=128, d_kv=32, d_ff=256, layers=2, heads=4,
              rel_buckets=32, rel_max_distance=128)
    hf = transformers.T5Config(feed_forward_proj="gated-gelu", **_hf(kw))
    flax = jax.tree.map(np.asarray, JT.JaxT5Encoder(hf, seq_len=8).params)
    cfg = T.T5Config(**kw)
    enc = TT.T5Encoder(cfg, seq_len=8, device="cpu", generator=torch.Generator().manual_seed(7))
    m = enc.model
    blk0 = flax["encoder"]["block"]["1"]["layer"]
    pairs = {"embed": (m.embed, flax["shared"]["embedding"]),
             "q": (m.blocks[1].q.weight, blk0["0"]["SelfAttention"]["q"]["kernel"]),
             "o": (m.blocks[1].o.weight, blk0["0"]["SelfAttention"]["o"]["kernel"]),
             "wi0": (m.blocks[1].wi0.weight, blk0["1"]["DenseReluDense"]["wi_0"]["kernel"]),
             "wo": (m.blocks[1].wo.weight, blk0["1"]["DenseReluDense"]["wo"]["kernel"])}
    for name, (got, want) in pairs.items():
        assert abs(float(got.std()) / float(np.std(want)) - 1) < 0.1, name
    rel = flax["encoder"]["block"]["0"]["layer"]["0"]["SelfAttention"][
        "relative_attention_bias"]["embedding"]
    assert abs(float(m.blocks[0].rel.std()) / float(np.std(rel)) - 1) < 0.35
    assert abs(float(m.blocks[1].q.weight.std()) * (128 * 32) ** 0.5 - 1) < 0.1
    assert (m.final_ln == 1).all() and not any(p.requires_grad for p in m.parameters())
    out = enc.encode_ids(np.arange(2, 10)[None])
    assert out.shape == (1, 8, 128) and torch.isfinite(out).all()


@pytest.mark.parametrize("cfg,billions", [(T.T5_V1_1_XXL, 4.76), (T.MT5_XXL, 5.65),
                                          (T.UMT5_XXL, 5.68)])
def test_presets_have_the_published_sizes(cfg, billions):
    model = T.T5Model(cfg, "meta")
    n = sum(p.numel() for p in model.parameters())
    assert abs(n / 1e9 - billions) < 0.01
    assert (cfg.d_model, cfg.layers, cfg.heads, cfg.d_ff, cfg.feed_forward) == (
        4096, 24, 64, 10240, "gated-gelu")
    assert cfg.per_layer_bias == (cfg is T.UMT5_XXL)
