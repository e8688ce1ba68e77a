"""The port's Wan sweep on the CPU (``eval/sweep.py``, ``cli/sweep.py``):
the prompt slice, fixed seeds, the manifest, ``dp`` prompts batched through
``generate_batch`` on one device, the VBench loop protocol, and the manifest
and summary keys against the JAX package's ``run_sweep`` for the same
``SweepConfig``."""

import json
import os

import numpy as np
import pytest

from magcache_tpu.eval import sweep as jsweep
from magcache_tpu_torch.eval.sweep import DEFAULT_PROMPTS, SweepConfig, load_prompts, run_sweep


def _cfg(**kw):
    base = dict(variant="full", out_dir=None, size=(64, 32), frame_num=9, sample_steps=2,
                sample_solver="euler", dtype="float32", tiny=True)
    base.update(kw)
    return SweepConfig(**base)


def _rows(out):
    return [json.loads(line) for line in open(os.path.join(out, "manifest.jsonl"))]


def test_sweep_slice_seeds_and_manifest(tmp_path):
    out = str(tmp_path / "s")
    summary = run_sweep(_cfg(out_dir=out, start_index=1, end_index=3, base_seed=7), device="cpu")
    assert summary["count"] == 2 and np.isfinite(summary["sec_per_video_mean"])
    assert {"00001.npy", "00002.npy", "manifest.jsonl", "summary.json"} <= set(os.listdir(out))
    rows = _rows(out)
    assert [r["index"] for r in rows] == [1, 2]
    assert [r["seed"] for r in rows] == [8, 9]          # base_seed + index
    assert rows[0]["prompt"] == DEFAULT_PROMPTS[1] and rows[0]["variant"] == "full"
    out2 = str(tmp_path / "s2")
    run_sweep(_cfg(out_dir=out2, start_index=1, end_index=3, base_seed=7), device="cpu")
    np.testing.assert_array_equal(np.load(os.path.join(out, "00001.npy")),
                                  np.load(os.path.join(out2, "00001.npy")))
    with pytest.raises(ValueError, match="empty prompt slice"):
        run_sweep(_cfg(out_dir=out, start_index=5, end_index=5), device="cpu")


def test_sweep_dp_batches_on_one_device(tmp_path):
    """dp = 2 runs the prompts in pairs through generate_batch, each element
    at the seed the manifest records: the same latents as dp = 1."""
    one, two = str(tmp_path / "dp1"), str(tmp_path / "dp2")
    run_sweep(_cfg(out_dir=one, end_index=3, variant="magcache"), device="cpu")
    summary = run_sweep(_cfg(out_dir=two, end_index=3, variant="magcache", dp=2), device="cpu")
    assert summary["count"] == 3 and summary["config"]["dp"] == 2
    assert [r["seed"] for r in _rows(two)] == [r["seed"] for r in _rows(one)] == [0, 1, 2]
    for i in range(3):                                  # a pair, then one alone
        np.testing.assert_allclose(np.load(os.path.join(two, f"{i:05d}.npy")),
                                   np.load(os.path.join(one, f"{i:05d}.npy")),
                                   atol=1e-6, rtol=1e-6)


def test_sweep_vbench_loop_and_json_prompts(tmp_path):
    pf = tmp_path / "prompts.json"
    pf.write_text(json.dumps([{"prompt_en": "a red fox"}, {"prompt_en": "a blue bird"}]))
    out = str(tmp_path / "s")
    summary = run_sweep(_cfg(out_dir=out, prompts_file=str(pf), loop=2), device="cpu")
    assert summary["count"] == 2
    assert sorted(f for f in os.listdir(out) if f.endswith(".npy")) == [
        "00000-0.npy", "00000-1.npy", "00001-0.npy", "00001-1.npy"]
    rows = _rows(out)
    assert sorted({r["prompt"] for r in rows}) == ["a blue bird", "a red fox"]
    assert {(r["loop"], r["seed"]) for r in rows} == {(0, 0), (1, 1)}   # seed = loop
    assert np.abs(np.load(os.path.join(out, "00000-0.npy"))
                  - np.load(os.path.join(out, "00000-1.npy"))).max() > 1e-4


def test_load_prompts_matches_jax(tmp_path):
    txt = tmp_path / "p.txt"
    txt.write_text("[cinematic] a boat\n\n  a fox  \n")
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([{"prompt": "x"}]))
    for path in (None, str(txt)):
        assert load_prompts(path) == jsweep.load_prompts(path)
    assert load_prompts(str(txt)) == ["[cinematic] a boat", "a fox"]
    with pytest.raises(KeyError, match="prompt_en"):
        load_prompts(str(bad))


def test_manifest_and_summary_keys_equal_jax(tmp_path):
    kw = dict(end_index=2, base_seed=3, variant="magcache")
    t_out, j_out = str(tmp_path / "t"), str(tmp_path / "j")
    got = run_sweep(_cfg(out_dir=t_out, **kw), device="cpu")
    want = jsweep.run_sweep(jsweep.SweepConfig(**dict(
        variant="magcache", out_dir=j_out, size=(64, 32), frame_num=9, sample_steps=2,
        sample_solver="euler", dtype="float32", tiny=True, end_index=2, base_seed=3)))
    assert got.keys() == want.keys()
    assert got["config"].keys() == want["config"].keys()
    assert {k: v for k, v in got["config"].items() if k != "out_dir"} == \
        {k: v for k, v in want["config"].items() if k != "out_dir"}
    assert got["count"] == want["count"] == 2
    t_rows, j_rows = _rows(t_out), _rows(j_out)
    assert [r.keys() for r in t_rows] == [r.keys() for r in j_rows]
    drop = lambda rows: [{k: v for k, v in r.items() if k != "sec_per_video"} for r in rows]
    assert drop(t_rows) == drop(j_rows)
    assert sorted(os.listdir(t_out)) == sorted(os.listdir(j_out))
    assert json.load(open(os.path.join(t_out, "summary.json"))).keys() == got.keys()


def test_sweep_axes_and_checkpoints():
    from magcache_tpu_torch.eval.sweep import sweep_pipeline_config

    with pytest.raises(NotImplementedError, match="item 7"):
        run_sweep(_cfg(out_dir="unused", tp=2), device="cpu")
    # a checkpoint directory reaches the pipeline, which loads it
    assert sweep_pipeline_config(_cfg(ckpt_dir="/nowhere")).ckpt_dir == "/nowhere"
    with pytest.raises(FileNotFoundError, match="/nowhere"):
        run_sweep(_cfg(out_dir="unused", ckpt_dir="/nowhere"), device="cpu")
    assert sweep_pipeline_config(_cfg(sp=2, sample_solver="unipc")).sp == 2
    for variant, kw in (("full", dict(use_magcache=False, enable_teacache=False)),
                        ("rolling", dict(use_magcache=True, cache_policy="rolling")),
                        ("teacache", dict(enable_teacache=True, use_magcache=False))):
        pc = sweep_pipeline_config(_cfg(variant=variant))
        assert all(getattr(pc, k) == v for k, v in kw.items()), variant


def test_cli_sweep_then_compare(tmp_path, capsys):
    from magcache_tpu_torch.cli.sweep import main

    base = ["--tiny", "--device", "cpu", "--dtype", "float32", "--sample_steps", "4",
            "--sample_solver", "euler", "--end_index", "2"]
    full = main(base + ["--variant", "full", "--out_dir", str(tmp_path / "full")])
    assert full["count"] == 2 and full["config"]["size"] == [64, 32]
    cached = main(base + ["--variant", "magcache", "--dp", "2", "--out_dir",
                          str(tmp_path / "mc"), "--compare_to", str(tmp_path / "full")])
    assert set(cached["vs_golden"]) == {"psnr", "ssim"}
    assert np.isfinite(cached["vs_golden"]["psnr"])
    assert os.path.exists(tmp_path / "mc" / "report.txt")
    assert '"variant": "magcache"' in capsys.readouterr().out
