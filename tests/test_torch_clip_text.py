"""The port's CLIP text tower (``models/clip.py``), its wrapper
``ClipTextEncoder`` and the SD3 stack ``Sd3TextStack`` against the JAX
package on the CPU: ``clip_text_forward`` at ``hidden_skip`` 0 and 1, with
and without projection, quick-gelu and gelu, padded masks, the legacy-EOS
branch; the legacy-EOS pooling fault of the reference's hash tokenizer,
shown and not inherited; the wrappers on prompts with the same weights, the
stack's length check and memo; the random init and the presets' sizes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.models import clip as JC
from magcache_tpu.models import text as JT
from magcache_tpu_torch.models import clip as C
from magcache_tpu_torch.models import t5 as T5
from magcache_tpu_torch.models import text as TT
from magcache_tpu_torch.models.convert import clip_text_params_from_numpy

# f32 on both sides: GEMM and reduction order only, held against the
# largest value
F32_TOL = 1e-4
PROMPTS = ["a photo of a cat on a mat", "", "Two anthropomorphic cats fight on a stage."]


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()


def _tree(cfg_kw, seed=0, proj=None):
    """The JAX init's tree (numpy) with a ``text_proj [dim, proj]`` added by
    hand (the JAX init draws none; a checkpoint carries it)."""
    jcfg = JC.CLIPTextConfig.tiny(**cfg_kw)
    tree = jax.tree.map(np.asarray, JC.init_clip_text_params(jax.random.PRNGKey(seed), jcfg))
    if proj:
        rng = np.random.default_rng(seed + 100)
        tree["text_proj"] = (rng.standard_normal((jcfg.dim, proj)) / np.sqrt(jcfg.dim)
                             ).astype(np.float32)
    return jcfg, tree


def _port(cfg_kw, tree, proj=None):
    cfg = C.CLIPTextConfig.tiny(**cfg_kw, projection_dim=proj)
    model = C.CLIPTextModel(cfg, "cpu")
    model.load_state_dict(clip_text_params_from_numpy(tree, cfg))
    return model


def _ids(vocab, eos, rows=((5, 9, 17), (3,), (11, 40, 7, 2, 60, 31))):
    """Ids padded with 0 to 12 tokens, each row's words then its EOS."""
    ids = np.zeros((len(rows), 12), np.int64)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = np.asarray(r) % (vocab - 3) + 1
        ids[i, len(r)] = eos
    return ids, (ids != 0).astype(np.int64)


@pytest.mark.parametrize("hidden_skip", [0, 1])
@pytest.mark.parametrize("project", [False, True])
@pytest.mark.parametrize("quick_gelu", [True, False])
def test_clip_text_forward_matches_jax(hidden_skip, project, quick_gelu):
    kw = dict(layers=3, quick_gelu=quick_gelu)
    proj = 24 if project else None
    jcfg, tree = _tree(kw, seed=hidden_skip, proj=proj)
    model = _port(kw, tree, proj)
    ids, mask = _ids(jcfg.vocab_size, jcfg.eos_token_id)
    want_h, want_p = JC.clip_text_forward(jax.tree.map(jnp.asarray, tree), jcfg,
                                          jnp.asarray(ids), jnp.asarray(mask),
                                          hidden_skip=hidden_skip, project=project)
    got_h, got_p = C.clip_text_forward(model, torch.from_numpy(ids), torch.from_numpy(mask),
                                       hidden_skip=hidden_skip, project=project)
    assert got_h.dtype == got_p.dtype == torch.float32
    assert got_p.shape == (3, proj or jcfg.dim)
    _close(got_h, want_h)
    _close(got_p, want_p)


def test_hidden_skip_is_the_unnormed_output_of_block_layers_minus_1_minus_k():
    kw = dict(layers=3)
    _, tree = _tree(kw)
    model = _port(kw, tree)
    ids, mask = (torch.from_numpy(a) for a in _ids(96, 95))
    full, _ = C.clip_text_forward(model, ids, mask)
    for k in (1, 2):
        # the tower cut after block 2 - k: its final-normed state is the
        # normed hidden_skip=k state
        head = C.CLIPTextModel(dataclasses.replace(model.cfg, layers=3 - k), "cpu")
        head.load_state_dict({n: v for n, v in model.state_dict().items()
                              if not any(n.startswith(f"blocks.{j}.") for j in range(3 - k, 3))})
        got, _ = C.clip_text_forward(model, ids, mask, hidden_skip=k)
        want, _ = C.clip_text_forward(head, ids, mask)
        with torch.no_grad():
            normed = torch.nn.functional.layer_norm(got, (32,), model.final_norm.weight,
                                                    model.final_norm.bias, eps=1e-5)
        torch.testing.assert_close(normed, want, atol=1e-5, rtol=1e-5)
        assert (got - full).abs().max() > 1e-3
    for bad in (-1, 3):
        with pytest.raises(ValueError, match="hidden_skip"):
            C.clip_text_forward(model, ids, hidden_skip=bad)
    with pytest.raises(ValueError, match="text_proj"):
        C.clip_text_forward(model, ids, project=True)
    with pytest.raises(ValueError, match="text_proj"):
        TT.ClipTextEncoder(model.cfg, project=True, model=model)
    with pytest.raises(ValueError, match="text_proj"):
        clip_text_params_from_numpy(tree, dataclasses.replace(model.cfg, projection_dim=8))


def test_legacy_eos_branch_pools_at_the_largest_id():
    kw = dict(vocab_size=49408, eos_token_id=2)       # openai/clip-vit-large-patch14's EOS rule
    jcfg, tree = _tree(kw)
    model = _port(kw, tree)
    assert model.cfg.legacy_eos
    ids, mask = _ids(49408, 49407)
    want_h, want_p = JC.clip_text_forward(jax.tree.map(jnp.asarray, tree), jcfg,
                                          jnp.asarray(ids), jnp.asarray(mask))
    got_h, got_p = C.clip_text_forward(model, torch.from_numpy(ids), torch.from_numpy(mask))
    _close(got_p, want_p)
    eos = (ids == 49407).argmax(1)
    torch.testing.assert_close(got_p, got_h[torch.arange(3), torch.from_numpy(eos)])


def test_legacy_eos_fault_of_the_reference_is_not_inherited(capsys):
    """The JAX wrapper's hash tokenizer writes a legacy config's EOS as id 2,
    so ``argmax(ids)`` pools at the largest hashed word; the port's writes
    49,407 (vocab - 1) and pools at the EOS."""
    kw = dict(vocab_size=49408, eos_token_id=2)
    jcfg, tree = _tree(kw, seed=3)
    model = _port(kw, tree)
    # the reference's fallback tokenizer for a checkpoint without tokenizer
    # files (magcache_tpu/models/text.py:313-315)
    jtok = JT.FallbackHashTokenizer(jcfg.vocab_size, eos_token_id=jcfg.eos_token_id)
    jenc = JT.ClipTextEncoder(jcfg, params=jax.tree.map(jnp.asarray, tree), tokenizer=jtok)
    tenc = TT.ClipTextEncoder(model.cfg, model=model)
    prompt = [PROMPTS[0]]
    jids = jtok(prompt, max_length=16)["input_ids"][0]
    tids = tenc.tokenizer(prompt, max_length=16)["input_ids"][0]
    assert (jids[jids != 2] == tids[tids != 49407]).all()       # the same words
    assert int(np.argmax(jids)) == 2 and int(np.argmax(tids)) == 8 == int((jids == 2).argmax())
    states = TT.ClipTextEncoder(model.cfg, model=model, states=True)(prompt)
    got = tenc(prompt)
    torch.testing.assert_close(got, states[:, 8])
    want = np.asarray(jenc(prompt))
    assert np.abs(got.numpy() - want).max() > 1e-2          # JAX pools at row 2
    _close(want, np.asarray(jenc.encode_ids(jids[None], (jids != 0)[None])[0])[:, 2])


def _wrapper_pair(kw, proj, hidden_skip, seq_len=10, seed=0):
    jcfg, tree = _tree(kw, seed=seed, proj=proj)
    model = _port(kw, tree, proj)
    tok = dict(vocab_size=jcfg.vocab_size, eos_token_id=jcfg.eos_token_id)
    opts = dict(seq_len=seq_len, hidden_skip=hidden_skip, project=bool(proj))
    jenc = JT.ClipTextEncoder(jcfg, params=jax.tree.map(jnp.asarray, tree),
                              tokenizer=JT.FallbackHashTokenizer(**tok), **opts)
    tenc = TT.ClipTextEncoder(model.cfg, tokenizer=TT.FallbackHashTokenizer(**tok), model=model,
                              **opts)
    return jcfg, tree, jenc, tenc


@pytest.mark.parametrize("states", [False, True])
def test_clip_text_encoder_on_prompts_matches_jax(states, capsys):
    _, _, jenc, tenc = _wrapper_pair(dict(layers=3), 24, 1)
    jenc.states = tenc.states = states
    got = tenc(PROMPTS, device="cpu")
    assert got.shape == ((3, 10, 32) if states else (3, 24))
    _close(got, jenc(PROMPTS))
    ids = np.array([[5, 9, 95, 0]])
    for g, w in zip(tenc.encode_ids(ids), jenc.encode_ids(ids)):
        _close(g, w)


def _stack_pair(capsys, clip_len=(8, 8), t5_dim=None):
    """The JAX and port SD3 stacks on the same weights: CLIP towers 12 wide
    (quick-gelu and gelu, projections of 8), a gated T5 24 wide."""
    import transformers

    from magcache_tpu_torch.models.convert import t5_params_from_flax
    from tests.test_torch_t5 import _hf
    towers = []
    for i, (kw, n) in enumerate(((dict(dim=12, heads=3, layers=3), clip_len[0]),
                                 (dict(dim=12, heads=2, layers=2, quick_gelu=False),
                                  clip_len[1]))):
        kw = dict(kw, max_len=max(clip_len))
        towers.append(_wrapper_pair(kw, 8, 1, seq_len=n, seed=i)[2:])
    t5_kw = dict(vocab_size=200, d_model=24, d_kv=6, d_ff=48, layers=2, heads=4,
                 rel_buckets=8, rel_max_distance=16)
    jt5 = JT.JaxT5Encoder(transformers.T5Config(feed_forward_proj="gated-gelu", **_hf(t5_kw)),
                          seq_len=6, tokenizer=JT.FallbackHashTokenizer(200))
    cfg = T5.T5Config(**t5_kw)
    model = T5.T5Model(cfg, "cpu")
    model.load_state_dict(t5_params_from_flax(jax.tree.map(np.asarray, jt5.params), cfg))
    tt5 = TT.T5Encoder(cfg, seq_len=6, tokenizer=TT.FallbackHashTokenizer(200), model=model)
    jstack = JT.Sd3TextStack(towers[0][0], towers[1][0], jt5, t5_dim=t5_dim)
    tstack = TT.Sd3TextStack(towers[0][1], towers[1][1], tt5, t5_dim=t5_dim)
    return jstack, tstack


def test_sd3_stack_matches_jax_and_memoizes(capsys):
    jstack, tstack = _stack_pair(capsys)
    ctx = tstack.context(PROMPTS, device="cpu")
    pooled = tstack.pooled(PROMPTS, device="cpu")
    assert ctx.shape == (3, 8 + 6, 24) and pooled.shape == (3, 16)
    assert (ctx[:, :8, 24:] == 0).all() and (ctx[:, :8, 2 * 12:] == 0).all()
    _close(ctx, jstack.context(PROMPTS))
    _close(pooled, jstack.pooled(PROMPTS))
    # the memo: one encode per prompt batch, a new batch encodes again
    calls = []
    t5 = tstack.t5
    tstack.t5 = lambda p: calls.append(p) or t5(p)
    assert tstack.context(PROMPTS) is ctx and tstack.pooled(PROMPTS) is pooled and not calls
    tstack.context(PROMPTS[:2])
    assert len(calls) == 1 and tstack.pooled(PROMPTS[:2]).shape == (2, 16) and len(calls) == 1


def test_sd3_stack_pads_to_t5_dim_and_refuses_mismatches(capsys):
    jstack, tstack = _stack_pair(capsys, t5_dim=24)
    _close(tstack.context(PROMPTS[:1]), jstack.context(PROMPTS[:1]))
    tstack.t5_dim = 20
    tstack._memo = (None, None)
    with pytest.raises(ValueError, match="t5_dim"):
        tstack.context(PROMPTS[:1])
    jstack, tstack = _stack_pair(capsys, clip_len=(8, 6))
    for stack in (jstack, tstack):
        with pytest.raises(ValueError, match="sequence lengths must match"):
            stack.context(PROMPTS)


def test_random_init_follows_jax_draws():
    cfg = C.CLIPTextConfig.tiny(dim=128, heads=4, vocab_size=4096, projection_dim=64)
    enc = TT.ClipTextEncoder(cfg, device="cpu", generator=torch.Generator().manual_seed(9),
                             project=True)
    m = enc.model
    assert abs(float(m.tok.std()) / 0.02 - 1) < 0.05
    assert abs(float(m.blocks[0].qkv.weight.std()) * 128 ** 0.5 - 1) < 0.05
    assert abs(float(m.text_proj.std()) * 128 ** 0.5 - 1) < 0.05
    assert (m.blocks[1].qkv.bias == 0).all() and (m.final_norm.weight == 1).all()
    assert not any(p.requires_grad for p in m.parameters())
    assert enc.tokenizer.eos == cfg.eos_token_id and enc.seq_len == 16
    out = enc(["a b c"])
    assert out.shape == (1, 64) and torch.isfinite(out).all()


@pytest.mark.parametrize("cfg,millions", [(C.CLIP_L, 123.1), (C.CLIP_L_SD3, 123.7),
                                          (C.CLIP_BIGG, 695.0)])
def test_presets_have_the_published_sizes(cfg, millions):
    n = sum(p.numel() for p in C.CLIPTextModel(cfg, "meta").parameters())
    assert abs(n / 1e6 - millions) < 0.5
    assert cfg.max_len == 77 and cfg.vocab_size == 49408 and cfg.mlp_ratio == 4
    assert cfg.legacy_eos == (cfg is not C.CLIP_BIGG)
    assert cfg.quick_gelu == (cfg is not C.CLIP_BIGG)
