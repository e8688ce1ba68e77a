"""The port's kernels on an NVIDIA card, against their plain versions.

Marked ``cuda``: without a card (and nvcc and triton) these tests skip. On a
card, from the repository root::

    python -m pytest tests/test_torch_cuda.py -q -p no:cacheprovider

The chip smoke run (``python3 chip_smoke.py``) checks the same kernels at the
main path's full shapes; these use ragged small shapes.
"""

import numpy as np
import pytest
import torch

from magcache_tpu_torch.ops import attention as A
from magcache_tpu_torch.ops import fused_prologue as P

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(dev, *shape, dtype=torch.bfloat16, scale=1.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


# the kernel and the plain version round at the same points; the f32 sums
# run in another order -> a bf16 ulp or two of the output
@pytest.mark.parametrize("fixed_max", [None, 16.0])
@pytest.mark.parametrize("sq,skv,kv_len", [(300, 77, 50), (300, 300, None),
                                           (1000, 512, None), (65, 129, 128)])
def test_k1_matches_plain(dev, fixed_max, sq, skv, kv_len):
    q = _rand(dev, 2, sq, 3, 128, seed=1)
    k = _rand(dev, 2, skv, 3, 128, seed=2)
    v = _rand(dev, 2, skv, 3, 128, seed=3)
    before = A.flash_attention_bshd.launches
    got = A.flash_attention_bshd(q, k, v, kv_len=kv_len, fixed_max=fixed_max)
    want = A.flash_attention_bshd_plain(q, k, v, kv_len=kv_len, fixed_max=fixed_max)
    torch.cuda.synchronize()
    assert A.flash_attention_bshd.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=2e-2)


def test_k1_refuses_what_it_does_not_take(dev):
    q = _rand(dev, 1, 200, 2, 64)
    with pytest.raises(ValueError, match="head dim"):
        A.flash_attention_bshd(q, q, q)
    q = _rand(dev, 1, 200, 2, 128, dtype=torch.float32)
    with pytest.raises(ValueError):
        A.flash_attention_bshd(q, q, q)


# a flipped bf16 rounding of the normed value -> one ulp of the pair's
# largest element
@pytest.mark.parametrize("b,s,heads", [(2, 300, 12), (1, 129, 2)])
def test_k2_matches_plain(dev, b, s, heads):
    x = _rand(dev, b, s, heads * 128, scale=2.0)
    gain = 1.0 + _rand(dev, heads * 128, dtype=torch.float32, scale=0.1, seed=4)
    ang = torch.rand(s, 64, device=dev) * 6.28
    cos, sin = torch.cos(ang), torch.sin(ang)
    got = P.rms_norm_rope(x, gain, cos, sin, heads, eps=1e-6)
    want = P.rms_norm_rope_plain(x, gain, cos, sin, heads, eps=1e-6)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=1.6e-2)


@pytest.mark.parametrize("mode", ["mod", "affine"])
@pytest.mark.parametrize("width", [1536, 256, 200])
def test_k3_matches_plain(dev, mode, width):
    b = 2
    x = _rand(dev, b, 300, width, scale=2.0)
    if mode == "mod":
        kw = dict(scale=_rand(dev, b, 1, width, dtype=torch.float32, scale=0.1, seed=5),
                  shift=_rand(dev, b, 1, width, dtype=torch.float32, scale=0.1, seed=6))
    else:
        kw = dict(weight=1.0 + _rand(dev, width, dtype=torch.float32, scale=0.1, seed=5),
                  bias=_rand(dev, width, dtype=torch.float32, scale=0.1, seed=6))
    got = P.layer_norm_mod(x, eps=1e-6, **kw)
    want = P.layer_norm_mod_plain(x, eps=1e-6, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=1.6e-2)


def test_tiny_pipeline_runs_through_the_kernels(dev):
    from magcache_tpu_torch.models.wan import WanConfig
    from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

    cfg = WanPipelineConfig(
        size=(192, 128), frame_num=5, sample_steps=10, sample_shift=5.0,
        guide_scale=5.0, use_magcache=True,
        model_cfg_override=WanConfig.tiny(dim=256, heads=2, ffn_dim=512,
                                          dtype="bfloat16"))
    pipe = WanPipeline(cfg, dev)
    counts = [A.flash_attention_bshd, P.rms_norm_rope, P.layer_norm_mod]
    before = [f.launches for f in counts]
    out = pipe.generate("a cat", seed=0)
    runs = int((~out.skips.all(1)).sum())
    per_run = [2 * 2, 2 * 2, 3 * 2]        # per block x 2 blocks
    assert [f.launches - b for f, b in zip(counts, before)] == [
        n * runs for n in per_run]
    assert torch.isfinite(out.latents).all()
    assert np.asarray(out.skips).sum() == 10
