"""The port's t2v pipeline and CLI on the CPU at ``--tiny`` size, and the
port's import boundary (never jax, never magcache_tpu)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from magcache_tpu.models.text import MockTextEncoder as JMock
from magcache_tpu_torch.cli import generate as cli
from magcache_tpu_torch.core.magcache import compute_skip_schedule
from magcache_tpu_torch.models.text import MockTextEncoder as TMock
from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pipe(**kw):
    base = dict(tiny=True, size=(64, 32), frame_num=9, sample_steps=10,
                sample_shift=5.0, guide_scale=5.0, dtype="float32")
    base.update(kw)
    return WanPipeline(WanPipelineConfig(**base), "cpu")


def test_mock_text_encoder_bit_equal_to_jax():
    prompts = ["Two cats box on a stage.", "", "色调艳丽"]
    np.testing.assert_array_equal(TMock(16, 24, scale=0.5)(prompts).numpy(),
                                  np.asarray(JMock(16, 24, scale=0.5)(prompts)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_magcache_tiny_is_finite_and_follows_schedule(dtype):
    pipe = _pipe(use_magcache=True, dtype=dtype)
    out = pipe.generate("a cat", seed=1)
    assert out.latents.shape == (1,) + pipe.latent_shape
    assert out.latents.dtype == torch.float32
    assert torch.isfinite(out.latents).all()
    want = compute_skip_schedule(pipe._cache_cfg()).reshape(10, 2)
    np.testing.assert_array_equal(out.skips, want)
    assert out.skips.sum() == 10
    # the same seed and prompt give the same latents
    torch.testing.assert_close(pipe.generate("a cat", seed=1).latents,
                               out.latents, atol=0, rtol=0)


def test_generate_skip_override_and_full_compute():
    pipe = _pipe(use_magcache=True)
    mask = pipe.skip_mask_for(thresh=0.24, K=6)
    assert mask.shape == (10, 2) and mask.sum() > 0
    out = pipe.generate("a cat", skip_override=mask)
    np.testing.assert_array_equal(out.skips, mask)
    full = pipe.skip_mask_for(use_magcache=False)
    assert not full.any()
    assert torch.isfinite(pipe.generate("a cat", skip_override=full).latents).all()


def test_unported_configs_raise():
    with pytest.raises(NotImplementedError):
        WanPipelineConfig(task="i2v")
    with pytest.raises(NotImplementedError):
        WanPipelineConfig(sample_solver="dpm++")


def test_cli_calibrate_then_install_ratios(tmp_path, capsys):
    cal = str(tmp_path / "cal")
    cli.main(["--tiny", "--device", "cpu", "--magcache_calibration",
              "--sample_steps", "6", "--save_file", cal])
    ratios = json.load(open(cal + "_mag_ratio.json"))
    assert len(ratios) == 2 * 5 and all(np.isfinite(ratios))
    out = str(tmp_path / "gen")
    cli.main(["--tiny", "--device", "cpu", "--use_magcache", "--sample_steps",
              "6", "--mag_ratios_json", cal + "_mag_ratio.json",
              "--save_file", out])
    lat = np.load(out + "_latents.npy")
    assert lat.shape == (1, 3, 4, 8, 16) and np.isfinite(lat).all()
    assert "skipped" in capsys.readouterr().out


def test_cli_rejects_unknown_task_and_missing_card():
    with pytest.raises(SystemExit, match="matches no model family"):
        cli.main(["--task", "nonsense-1B", "--device", "cpu"])
    with pytest.raises(SystemExit, match="not ported"):
        cli.main(["--task", "flux-dev", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(["--tiny"])


def test_port_never_imports_jax_or_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import magcache_tpu_torch as m\n"
        "for info in pkgutil.walk_packages(m.__path__, 'magcache_tpu_torch.'):\n"
        "    if not info.name.endswith('prologue_triton'):\n"
        "        importlib.import_module(info.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'magcache_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=REPO,
                   timeout=120)
    for root, _, files in os.walk(os.path.join(REPO, "magcache_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(root, f)).read()
                assert "import jax" not in src and "from jax" not in src, f
                assert "from magcache_tpu." not in src, f
                assert "import magcache_tpu\n" not in src, f
    smoke = open(os.path.join(REPO, "chip_smoke.py")).read()
    assert "jax" not in smoke and "magcache_tpu." not in smoke
