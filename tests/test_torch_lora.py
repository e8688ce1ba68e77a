"""LoRA merging in the port (``models/lora.py``) against the JAX package's
``magcache_tpu.models.lora``: the cases of ``tests/test_lora.py``, and
``load_flux_checkpoint(lora_path=)`` / ``load_omnigen2_checkpoint(
lora_path=)`` against JAX's merged-then-converted trees.

The merge is ``w + scale * (alpha / r) * (B @ A)`` in f32, rounded to the
weight's dtype; the port's product is torch's f32 matmul and JAX's numpy's,
whose summation orders may differ, so merged weights are held to JAX's
within one f32 ulp and to the port's formula bit for bit; every other
tensor is bit-equal.
"""

import numpy as np
import pytest
import torch

from magcache_tpu.models import convert as JC
from magcache_tpu.models import lora as JL
from magcache_tpu_torch.models import convert as TC
from magcache_tpu_torch.models import published as P
from magcache_tpu_torch.models.checkpoint import save_safetensors
from magcache_tpu_torch.models.lora import load_lora_file, merge_lora_state_dict
from tests.test_convert import _flux_tiny_sd, make_omnigen2_sd
from tests.test_torch_checkpoint import _np_tree, _torch_sd


def _base_sd():
    rng = np.random.default_rng(0)
    return {"layers.0.attn.to_q.weight": rng.normal(size=(8, 6)).astype(np.float32),
            "layers.0.attn.to_q.bias": np.zeros((8,), np.float32),
            "layers.1.ff.w1.weight": rng.normal(size=(10, 8)).astype(np.float32)}


def _formula(w, a, b, eff):
    return (w.float() + eff * (b.float() @ a.float())).to(w.dtype)


def test_merge_peft_convention_with_alpha_prefix_and_scale():
    sd = _base_sd()
    rng = np.random.default_rng(1)
    A = rng.normal(size=(2, 6)).astype(np.float32)
    B = rng.normal(size=(8, 2)).astype(np.float32)
    lora = {"transformer.layers.0.attn.to_q.lora_A.weight": A,
            "transformer.layers.0.attn.to_q.lora_B.weight": B,
            "transformer.layers.0.attn.to_q.alpha": np.float32(4.0)}
    tsd = _torch_sd(sd)
    merged, n = merge_lora_state_dict(tsd, {k: torch.as_tensor(v) for k, v in lora.items()},
                                      scale=0.5)
    jmerged, jn = JL.merge_lora_state_dict(sd, lora, scale=0.5)
    assert n == jn == 1
    k = "layers.0.attn.to_q.weight"
    assert torch.equal(merged[k], _formula(tsd[k], torch.from_numpy(A), torch.from_numpy(B),
                                           0.5 * 4.0 / 2))
    np.testing.assert_allclose(merged[k].numpy(), jmerged[k], rtol=1e-6, atol=1e-6)
    assert merged["layers.1.ff.w1.weight"] is tsd["layers.1.ff.w1.weight"]


def test_merge_kohya_convention_no_alpha():
    sd = _base_sd()
    rng = np.random.default_rng(2)
    down = rng.normal(size=(3, 8)).astype(np.float32)
    up = rng.normal(size=(10, 3)).astype(np.float32)
    lora = {"layers.1.ff.w1.lora_down.weight": down, "layers.1.ff.w1.lora_up.weight": up}
    merged, n = merge_lora_state_dict(_torch_sd(sd), _torch_sd(lora))
    assert n == 1
    np.testing.assert_allclose(merged["layers.1.ff.w1.weight"].numpy(),
                               JL.merge_lora_state_dict(sd, lora)[0]["layers.1.ff.w1.weight"],
                               rtol=1e-6, atol=1e-6)


def test_merge_strict_raises_on_unknown_target_and_bad_shapes():
    sd = _torch_sd(_base_sd())
    lora = {"nope.lora_A.weight": torch.zeros(2, 4), "nope.lora_B.weight": torch.zeros(4, 2)}
    with pytest.raises(KeyError, match="absent from the checkpoint"):
        merge_lora_state_dict(sd, lora)
    assert merge_lora_state_dict(sd, lora, strict=False)[1] == 0
    with pytest.raises(KeyError, match="up-projection missing"):
        merge_lora_state_dict(sd, {"layers.1.ff.w1.lora_A.weight": torch.zeros(2, 8)})
    with pytest.raises(ValueError, match="do not match"):
        merge_lora_state_dict(sd, {"layers.1.ff.w1.lora_A.weight": torch.zeros(2, 7),
                                   "layers.1.ff.w1.lora_B.weight": torch.zeros(10, 2)})
    with pytest.raises(ValueError, match="no lora_A"):
        merge_lora_state_dict(sd, {"x.weight": torch.zeros(1)})


def test_merge_rounds_to_the_weight_dtype():
    """A bf16 weight merges in f32 and rounds once to bf16 (JAX's
    ``astype(w.dtype)``)."""
    g = torch.Generator().manual_seed(3)
    w = torch.randn(12, 8, generator=g).to(torch.bfloat16)
    a, b = torch.randn(4, 8, generator=g), torch.randn(12, 4, generator=g)
    merged, _ = merge_lora_state_dict({"p.weight": w}, {"p.lora_A.weight": a,
                                                        "p.lora_B.weight": b,
                                                        "p.alpha": torch.tensor(2.0)}, 1.5)
    assert merged["p.weight"].dtype == torch.bfloat16
    assert torch.equal(merged["p.weight"], _formula(w, a, b, 1.5 * 2.0 / 4))


def test_load_lora_file_formats(tmp_path):
    d = {"x.lora_A.weight": torch.ones((2, 3))}
    save_safetensors(d, str(tmp_path / "a.safetensors"))
    out = load_lora_file(str(tmp_path / "a.safetensors"))
    assert torch.equal(out["x.lora_A.weight"], d["x.lora_A.weight"])
    assert "x.lora_A.weight" in load_lora_file(str(tmp_path))    # a directory
    torch.save({"state_dict": d}, tmp_path / "b.pt")
    assert torch.equal(load_lora_file(str(tmp_path / "b.pt"))["x.lora_A.weight"],
                       d["x.lora_A.weight"])
    # JAX's reader reads the port's writer's file
    np.testing.assert_array_equal(
        JL.load_lora_file(str(tmp_path / "a.safetensors"))["x.lora_A.weight"], np.ones((2, 3)))


def _adapter(sd, targets, rank, rng, alpha=None):
    lora = {}
    for t in targets:
        out_dim, in_dim = sd[f"{t}.weight"].shape
        lora[f"transformer.{t}.lora_A.weight"] = rng.normal(0, .1, (rank, in_dim)).astype("f4")
        lora[f"transformer.{t}.lora_B.weight"] = rng.normal(0, .1, (out_dim, rank)).astype("f4")
        if alpha is not None:
            lora[f"transformer.{t}.alpha"] = np.float32(alpha)
    return lora


def _close_or_equal(got, want, merged_keys):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if any(k.startswith(m) for m in merged_keys):
            np.testing.assert_allclose(got[k].float().numpy(), want[k].float().numpy(),
                                       rtol=2e-6, atol=1e-7, err_msg=k)
        else:
            assert torch.equal(got[k], want[k]), k


def test_flux_checkpoint_lora_equal_jax(tmp_path):
    from magcache_tpu.models.flux import FluxConfig as J
    from magcache_tpu_torch.models.flux import FluxConfig as T

    jc, tc = J.tiny(), T.tiny()
    sd = _flux_tiny_sd(jc, np.random.default_rng(3))
    ck = tmp_path / "ckpt"
    ck.mkdir()
    save_safetensors(_torch_sd(sd), str(ck / "flux1-dev.safetensors"))
    targets = ["double_blocks.0.img_attn.qkv", "single_blocks.1.linear2"]
    lora = _adapter(sd, targets, 2, np.random.default_rng(4))
    save_safetensors(_torch_sd(lora), str(tmp_path / "adapter.safetensors"))
    got = P.load_flux_checkpoint(str(ck), tc, lora_path=str(tmp_path / "adapter.safetensors"),
                                 lora_scale=0.7)
    jtree = JC.load_flux_checkpoint(str(ck), jc, lora_path=str(tmp_path / "adapter.safetensors"),
                                    lora_scale=0.7)
    want = TC.flux_params_from_numpy(_np_tree(jtree), tc)
    _close_or_equal(got, want, ("double_blocks.0.img_qkv", "single_blocks.1.lin2"))
    plain = P.load_flux_checkpoint(str(ck), tc)
    assert not torch.equal(got["double_blocks.0.img_qkv.weight"],
                           plain["double_blocks.0.img_qkv.weight"])
    # the pipeline loads the same weights
    from magcache_tpu_torch.pipelines.flux import FluxPipeline, FluxPipelineConfig

    pipe = FluxPipeline(FluxPipelineConfig(tiny=True, dtype="float32", ckpt_dir=str(ck),
                                           lora_path=str(tmp_path / "adapter.safetensors"),
                                           lora_scale=0.7), "cpu")
    for k, v in got.items():
        assert torch.equal(pipe.model.state_dict()[k], v), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_omnigen2_checkpoint_lora_equal_jax(tmp_path, dtype):
    from magcache_tpu.models.omnigen2 import OmniGen2Config as J
    from magcache_tpu_torch.models.omnigen2 import OmniGen2Config as T

    jc, tc = J.tiny(dtype=dtype), T.tiny(dtype=dtype)
    sd = make_omnigen2_sd(jc)
    save_safetensors(_torch_sd(sd), str(tmp_path / "model.safetensors"))
    targets = [f"layers.{i}.attn.{p}" for i in range(jc.layers)
               for p in ("to_q", "to_k", "to_v", "to_out.0")]
    lora = _adapter(sd, targets, 4, np.random.default_rng(5), alpha=8.0)
    adapters = tmp_path.parent / f"{tmp_path.name}_adapters"
    adapters.mkdir()
    save_safetensors(_torch_sd(lora), str(adapters / "lora.safetensors"))
    got, cfg = P.load_omnigen2_checkpoint(str(tmp_path), tc,
                                          lora_path=str(adapters / "lora.safetensors"),
                                          lora_scale=0.5)
    jtree, _ = JC.load_omnigen2_checkpoint(str(tmp_path), jc,
                                           lora_path=str(adapters / "lora.safetensors"),
                                           lora_scale=0.5)
    want = TC.omnigen2_params_from_numpy(_np_tree(jtree), tc)
    merged = tuple(f"layers.{i}.{n}." for i in range(jc.layers) for n in ("q", "kv", "o"))
    _close_or_equal(got, want, merged)
    # bit for bit the formula, the fused kv's halves included
    dk = tc.kv_heads * tc.head_dim
    eff = 0.5 * 8.0 / 4
    for i in range(jc.layers):
        for proj, (name, rows) in {"to_q": ("q", slice(None)), "to_k": ("kv", slice(0, dk)),
                                   "to_v": ("kv", slice(dk, None)),
                                   "to_out.0": ("o", slice(None))}.items():
            base = f"layers.{i}.attn.{proj}"
            # the file's f32 weight merges, then converts to the model's dtype
            w = torch.from_numpy(sd[f"{base}.weight"])
            a, b = (torch.from_numpy(lora[f"transformer.{base}.lora_{x}.weight"])
                    for x in "AB")
            want_w = _formula(w, a, b, eff).to(tc.torch_dtype)
            assert torch.equal(got[f"layers.{i}.{name}.weight"][rows], want_w), base
    # an adapter aimed at a key the checkpoint lacks raises, in the pipeline too
    bad = dict(lora, **{"transformer.layers.9.attn.to_q.lora_A.weight": np.zeros((4, 96), "f4"),
                        "transformer.layers.9.attn.to_q.lora_B.weight": np.zeros((96, 4), "f4")})
    save_safetensors(_torch_sd(bad), str(adapters / "bad.safetensors"))
    from magcache_tpu_torch.pipelines.omnigen2 import OmniGen2Pipeline, OmniGen2PipelineConfig

    with pytest.raises(KeyError, match="absent from the checkpoint"):
        OmniGen2Pipeline(OmniGen2PipelineConfig(
            tiny=True, dtype=dtype, height=32, width=32, txt_len=6, ckpt_dir=str(tmp_path),
            lora_path=str(adapters / "bad.safetensors")), "cpu")
    pipe = OmniGen2Pipeline(OmniGen2PipelineConfig(
        tiny=True, dtype=dtype, height=32, width=32, txt_len=6, ckpt_dir=str(tmp_path),
        lora_path=str(adapters / "lora.safetensors"), lora_scale=0.5), "cpu")
    for k, v in got.items():
        assert torch.equal(pipe.model.state_dict()[k], v), k
