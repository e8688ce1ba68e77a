"""The port's evaluation on the CPU: PSNR, SSIM, ``compare_dirs`` and the
VBench aggregation against the JAX package's on the same arrays (to 1e-6),
LPIPS (the state-dict mapping, the random-backbone warning, loading weights
a test writes), the experiment runner, and the ``cli.evaluate`` self-check
and golden comparison."""

import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from magcache_tpu.eval import compare as jcompare
from magcache_tpu.eval import metrics as jmetrics
from magcache_tpu.eval import vbench as jvbench
from magcache_tpu_torch.eval import compare as tcompare
from magcache_tpu_torch.eval import metrics as tmetrics
from magcache_tpu_torch.eval import vbench as tvbench

_RNG = np.random.default_rng(0)
PAIRS = {
    "noisy": (lambda a: (a, np.clip(a + _RNG.normal(0, 0.05, a.shape), 0, 1)))(
        _RNG.uniform(size=(3, 24, 20, 3))),
    "single frame": (lambda a: (a, np.clip(a * 0.9 + 0.05, 0, 1)))(
        _RNG.uniform(size=(16, 16, 3)).astype(np.float32)),
    "identical": (lambda a: (a, a.copy()))(_RNG.uniform(size=(2, 16, 16, 3))),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_psnr_and_ssim_equal_jax(name):
    a, b = PAIRS[name]
    np.testing.assert_allclose(tmetrics.psnr(a, b), jmetrics.psnr(a, b), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tmetrics.ssim(a, b), jmetrics.ssim(a, b), rtol=1e-6, atol=1e-6)
    if name == "identical":
        assert tmetrics.psnr(a, b) == 100.0 and tmetrics.ssim(a, b) > 0.999


def test_compare_dirs_and_report_equal_jax(tmp_path):
    gold, cached = tmp_path / "gold", tmp_path / "cached"
    gold.mkdir()
    cached.mkdir()
    rng = np.random.default_rng(1)
    for i in range(3):
        v = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
        np.save(gold / f"v{i}.npy", v)
        np.save(cached / f"v{i}.npy", np.clip(v + rng.normal(0, 0.05, v.shape), 0, 1))
    np.save(gold / "u8.npy", (rng.uniform(size=(1, 16, 16, 3)) * 255).astype(np.uint8))
    np.save(cached / "u8.npy", (rng.uniform(size=(1, 16, 16, 3)) * 255).astype(np.uint8))
    np.save(gold / "only_here.npy", np.zeros((1, 16, 16, 3), np.float32))
    got = tcompare.compare_dirs(str(cached), str(gold), metrics=("psnr", "ssim"))
    want = jcompare.compare_dirs(str(cached), str(gold), metrics=("psnr", "ssim"))
    assert got["count"] == want["count"] == 4
    assert [r["name"] for r in got["per_video"]] == [r["name"] for r in want["per_video"]]
    for g, w in zip(got["per_video"] + [got["mean"]], want["per_video"] + [want["mean"]]):
        for m in ("psnr", "ssim"):
            np.testing.assert_allclose(g[m], w[m], rtol=1e-6, atol=1e-6)
    p_t = tcompare.write_report(got, str(tmp_path / "t" / "report.txt"))
    p_j = jcompare.write_report(want, str(tmp_path / "j" / "report.txt"))
    assert open(p_t).read() == open(p_j).read()
    assert "mean psnr" in open(p_t).read()


@pytest.mark.parametrize("value", [0.8, 0.3, None])
def test_vbench_aggregation_equals_jax(value, tmp_path):
    dims = tvbench.QUALITY_LIST + tvbench.SEMANTIC_LIST
    assert dims == jvbench.QUALITY_LIST + jvbench.SEMANTIC_LIST
    rng = np.random.default_rng(2)
    scores = {d: (float(rng.uniform(0.2, 1.0)) if value is None else value) for d in dims}
    if value == 0.3:
        scores.pop("scene")                        # a missing dimension
    got, want = tvbench.aggregate_vbench(scores), jvbench.aggregate_vbench(scores)
    assert got.keys() == want.keys() == {"total score", "quality score", "semantic score"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)
    path = tmp_path / "vbench.json"
    path.write_text(json.dumps({k: [v, []] for k, v in scores.items()}))
    assert tvbench.aggregate_vbench_json(str(path)) == jvbench.aggregate_vbench_json(str(path))


def _lpips_state_dict(seed=0):
    """A synthetic ``lpips.LPIPS(net='alex')`` state dict (numpy)."""
    rng = np.random.default_rng(seed)
    specs = [(11, 64, 3), (5, 192, 64), (3, 384, 192), (3, 256, 384), (3, 256, 256)]
    slices = [(1, 0), (2, 3), (3, 6), (4, 8), (5, 10)]
    sd = {}
    for (k, cout, cin), (sl, idx) in zip(specs, slices):
        sd[f"net.slice{sl}.{idx}.weight"] = rng.normal(0, 0.05, (cout, cin, k, k)).astype(np.float32)
        sd[f"net.slice{sl}.{idx}.bias"] = rng.normal(0, 0.01, cout).astype(np.float32)
    for i, c in enumerate((64, 192, 384, 256, 256)):
        sd[f"lin{i}.model.1.weight"] = np.abs(rng.normal(0, 0.05, (1, c, 1, 1))).astype(np.float32)
    return sd


def test_lpips_state_dict_mapping_matches_jax():
    sd = _lpips_state_dict()
    tm = tmetrics.LPIPSModel.from_torch_state_dict(sd)
    jm = jmetrics.LPIPSModel.from_torch_state_dict(sd)
    assert tm.pretrained and jm.pretrained
    for conv, jc in zip(tm.convs, jm.params["convs"]):
        np.testing.assert_array_equal(conv.weight.numpy(),
                                      np.asarray(jc["w"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(conv.bias.numpy(), np.asarray(jc["b"]))
    for lin, jl in zip(tm.lins, jm.params["lins"]):
        np.testing.assert_array_equal(lin.numpy(), np.asarray(jl))
    rng = np.random.default_rng(3)
    a = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    b = np.roll(a, 3, axis=1)
    got = tmetrics.lpips_distance(a, b, model=tm)
    want = jmetrics.lpips_distance(a, b, model=jm)
    assert got > 0 and np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-4)    # conv summation order
    with pytest.raises(ValueError, match="AlexNet convs"):
        tmetrics.LPIPSModel.from_torch_state_dict({"lin0.model.1.weight": np.ones(64)})


def test_lpips_random_backbone_warns_and_orders():
    rng = np.random.default_rng(4)
    a = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    tmetrics._DEFAULT_LPIPS = None
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert tmetrics.lpips_distance(a, a) < 1e-6
        assert any("RANDOM" in str(x.message) for x in w)
    near = np.clip(a + rng.normal(0, 0.01, a.shape), 0, 1).astype(np.float32)
    far = np.clip(a + rng.normal(0, 0.3, a.shape), 0, 1).astype(np.float32)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert tmetrics.lpips_distance(a, near, allow_random_backbone=True) < \
            tmetrics.lpips_distance(a, far, allow_random_backbone=True)
        assert not any("RANDOM" in str(x.message) for x in w)
    # the seeded random init is reproducible
    torch.testing.assert_close(tmetrics.LPIPSModel().convs[0].weight,
                               tmetrics.LPIPSModel().convs[0].weight, atol=0, rtol=0)


@pytest.mark.parametrize("ext", [".pth", ".safetensors"])
def test_load_lpips_weights_installs_the_default(ext, tmp_path):
    sd = {k: torch.from_numpy(v) for k, v in _lpips_state_dict(5).items()}
    path = str(tmp_path / f"lpips_alex{ext}")
    if ext == ".pth":
        torch.save(sd, path)
    else:
        from safetensors.torch import save_file
        save_file(sd, path)
    try:
        model = tmetrics.load_lpips_weights(path, device="cpu")
        assert model.pretrained and tmetrics._DEFAULT_LPIPS is model
        assert model.shift.device.type == "cpu"
        a = np.random.default_rng(6).random((1, 32, 32, 3)).astype(np.float32)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            d = tmetrics.lpips_distance(a, a[:, ::-1].copy())
            assert not any("RANDOM" in str(x.message) for x in w)
        assert tcompare.compare_videos(a, a[:, ::-1].copy(), metrics=("lpips",),
                                       device="cpu") == {"lpips": d}
        np.testing.assert_allclose(d, jmetrics.lpips_distance(
            a, a[:, ::-1].copy(), model=jmetrics.LPIPSModel.from_torch_state_dict(
                {k: v.numpy() for k, v in sd.items()})), rtol=1e-4)
    finally:
        tmetrics._DEFAULT_LPIPS = None


def test_run_experiment_harness(tmp_path):
    from magcache_tpu_torch.eval.experiments import run_experiment
    from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

    model = []

    def make(variant):
        pipe = WanPipeline(WanPipelineConfig(
            tiny=True, size=(64, 32), frame_num=9, sample_steps=4, sample_solver="euler",
            dtype="float32", use_magcache=variant == "magcache"), "cpu",
            model=model[0] if model else None)
        model[:] = [pipe.model]
        return pipe

    res = run_experiment(make, ["a cat", "a dog"], variants=("base", "magcache"),
                         out_dir=str(tmp_path), metrics=("psnr", "ssim"))
    assert res["magcache"].metrics_vs_base["psnr"] > 5
    assert 0 < res["magcache"].metrics_vs_base["ssim"] <= 1
    assert res["base"].outputs[0].shape == (1, 3, 4, 8, 16)
    summary = json.load(open(tmp_path / "summary.json"))
    assert set(summary) == {"base", "magcache"}
    assert (tmp_path / "base_0.npy").exists() and (tmp_path / "magcache_1.npy").exists()


# the keys the JAX _self_check writes (magcache_tpu/cli/evaluate.py:82-279)
SELF_CHECK_KEYS = {
    "mode": None, "steps": None, "seed": None,
    "wan": {"magcache_vs_full", "teacache_vs_full", "skips"},
    "ti2v": {"magcache_vs_full", "skips"},
    "flux": {"magcache_vs_full", "skips"},
    "framepack": {"teacache_vs_full", "skips"},
    "omnigen2": {"taylorseer_vs_full", "skips"},
    "metrics_magcache_vs_full": {"latent_psnr", "latent_ssim"},
    "metrics_teacache_vs_full": {"latent_psnr", "latent_ssim"},
    "seconds": {f"{fam}_{v}" for fam, vs in (
        ("wan", ("full", "magcache", "teacache")), ("ti2v", ("full", "magcache")),
        ("flux", ("full", "magcache")), ("framepack", ("full", "teacache")),
        ("omnigen2", ("full", "taylorseer"))) for v in vs},
}


def test_evaluate_self_check_keys_and_skips(tmp_path):
    from magcache_tpu_torch.cli.evaluate import main

    out = tmp_path / "EVAL.json"
    res = main(["--self_check", "--steps", "4", "--device", "cpu", "--json", str(out)])
    assert json.load(open(out)) == json.loads(json.dumps(res))
    assert res.keys() == SELF_CHECK_KEYS.keys()
    for key, sub in SELF_CHECK_KEYS.items():
        if sub is not None:
            assert set(res[key]) == sub, key
    assert res["steps"] == 4 and res["seed"] == 42
    for fam, key in (("wan", "magcache"), ("wan", "teacache"), ("ti2v", "magcache"),
                     ("flux", "magcache"), ("framepack", "teacache"),
                     ("omnigen2", "taylorseer")):
        sc = res[fam]["skips"][key]
        assert 0 < sc["skipped"] <= sc["total"], (fam, sc)
        m = res[fam][f"{key}_vs_full"]
        assert np.isfinite(m["latent_psnr"]) and 0 < m["latent_ssim"] <= 1
    assert res["framepack"]["skips"]["teacache"]["sections"] == 2
    assert res["wan"]["skips"].keys() == {"magcache", "teacache"}


def test_evaluate_golden_dirs_cli(tmp_path, capsys):
    from magcache_tpu_torch.cli.evaluate import main

    gold, cached = tmp_path / "gold", tmp_path / "cached"
    gold.mkdir()
    cached.mkdir()
    rng = np.random.default_rng(7)
    v = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    np.save(gold / "00000.npy", v)
    np.save(cached / "00000.npy", np.clip(v + 0.02, 0, 1))
    report = str(tmp_path / "report.txt")
    res = main(["--cached", str(cached), "--golden", str(gold), "--report", report,
                "--json", str(tmp_path / "r.json"), "--device", "cpu"])
    assert "dropping lpips" in capsys.readouterr().out
    assert res["count"] == 1 and set(res["mean"]) == {"psnr", "ssim"}
    np.testing.assert_allclose(res["mean"]["psnr"], jmetrics.psnr(np.clip(v + 0.02, 0, 1), v),
                               rtol=1e-6)
    assert os.path.exists(report)
    with pytest.raises(SystemExit, match="--cached and --golden"):
        main(["--device", "cpu"])


def test_evaluate_runs_on_the_cpu_only_when_asked(tmp_path):
    """``cli.evaluate`` defaults to the card: the self-check refuses any
    device but ``--device cpu``, and without a card the golden comparison
    refuses to fall back to the CPU."""
    from magcache_tpu_torch.cli.evaluate import build_parser, main

    assert build_parser().parse_args([]).device == "cuda"
    for argv in (["--self_check"], ["--self_check", "--device", "cuda:0"]):
        with pytest.raises(SystemExit, match="--device cpu"):
            main(argv)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(["--cached", str(tmp_path), "--golden", str(tmp_path)])
