"""The port's serving layer on the CPU: ``serve/server.py`` (the JAX
``tests/test_serve.py`` cases, at tiny shapes), the request safelist that
refuses what the JAX server forwards, ``WanPipeline.generate_batch`` against
the JAX package's and against single runs, the Engine, the serve CLI as a
subprocess, and the helpers (``utils/{logging,trace,misc}.py``). Every wait
and HTTP call is bounded (120 s at most)."""

import base64
import dataclasses
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.pipelines import wan as jpipe
from magcache_tpu.utils.misc import set_seed as j_set_seed
from magcache_tpu_torch.models.convert import wan_params_from_numpy
from magcache_tpu_torch.pipelines import wan as tpipe
from magcache_tpu_torch.pipelines.flux import FluxPipeline, FluxPipelineConfig
from magcache_tpu_torch.serve import PipelineServer, QueueFullError, make_http_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 120            # every wait and HTTP call in this file, seconds
TOL = 1e-4            # the Wan parity tolerance (test_torch_solvers.py)


def _start(server):
    httpd = make_http_server(server, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, "http://127.0.0.1:%d" % httpd.server_address[1]


def _get(url):
    with urllib.request.urlopen(url, timeout=WAIT) as r:
        return r.status, json.loads(r.read())


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        return r.status, json.loads(r.read())


def _status(fn, *args) -> int:
    """The HTTP status of a call expected to fail."""
    with pytest.raises(urllib.error.HTTPError) as ei:
        fn(*args)
    return ei.value.code


def _latents(rec) -> np.ndarray:
    return np.load(io.BytesIO(base64.b64decode(rec["result"]["latents_b64"])))


def _flux():
    cfg = FluxPipelineConfig(tiny=True, height=64, width=64, txt_len=8,
                             num_inference_steps=4, dtype="float32", use_magcache=True,
                             magcache_thresh=0.3, retention_ratio=0.1)
    return FluxPipeline(cfg, "cpu")


def _wan(**kw):
    base = dict(tiny=True, size=(64, 32), frame_num=9, sample_steps=3,
                sample_solver="euler", dtype="float32")
    base.update(kw)
    return tpipe.WanPipeline(tpipe.WanPipelineConfig(**base), "cpu")


@pytest.fixture(scope="module")
def served():
    pipe = _flux()
    server = PipelineServer(pipe, steps=4)
    httpd, base = _start(server)
    yield pipe, server, base
    httpd.shutdown()
    server.shutdown()


class _Out:
    def __init__(self, image=None):
        self.latents = np.zeros((1, 2, 2))
        self.video = None
        self.image = image
        self.skips = None
        self.timings = None


class _SlowPipe:
    """A stand-in pipeline whose generate() blocks, for the queue, timeout
    and watchdog cases."""

    def __init__(self, delay=0.5, fail=None):
        self.delay = delay
        self.fail = fail

    def generate(self, prompt, **kw):
        if self.fail is not None:
            raise self.fail
        time.sleep(self.delay)
        return _Out()


# ------------------------------------------------------------ the endpoints
def test_healthz_and_info(served):
    _, _, base = served
    code, health = _get(base + "/healthz")
    assert code == 200 and health["ok"] and health["backend"] == "cpu"
    assert "device_name" not in health          # only a card is named
    code, info = _get(base + "/info")
    assert code == 200 and info["pipeline"] == "FluxPipeline" and info["steps"] == 4
    assert info["config"]["use_magcache"] is True and info["overrides_supported"]


def test_sync_generate_returns_latents_and_skips(served):
    pipe, _, base = served
    code, rec = _post(base + "/generate", {"prompt": "a fox", "seed": 3,
                                           "return_latents": True})
    assert code == 200 and rec["status"] == "done"
    res = rec["result"]
    gh, gw = pipe.grid
    assert res["latents_shape"][:2] == [1, gh * gw]
    assert res["skipped_forwards"] > 0 and res["total_forwards"] == 4
    assert rec["wall_s"] is not None and rec["queue_wait_s"] is not None
    lat = _latents(rec)
    assert lat.shape == tuple(res["latents_shape"]) and np.isfinite(lat).all()
    # served latents are the direct run's, bit for bit
    np.testing.assert_array_equal(lat, pipe.generate("a fox", seed=3).latents.numpy())


def test_sync_generate_deterministic_per_seed(served):
    _, _, base = served
    a, b = (_latents(_post(base + "/generate", {"prompt": "a fox", "seed": 7,
                                                "return_latents": True})[1])
            for _ in range(2))
    np.testing.assert_array_equal(a, b)


def test_async_job_lifecycle(served):
    _, server, base = served
    code, sub = _post(base + "/generate", {"prompt": "a cat", "async": True})
    assert code == 202 and "job_id" in sub
    job = server.get(sub["job_id"])
    assert job is not None and job.done_event.wait(WAIT)
    code, rec = _get(base + "/jobs/" + sub["job_id"])
    assert code == 200 and rec["status"] == "done"
    assert rec["result"]["latents_shape"][0] == 1


def test_concurrent_posts_serialize_on_one_executor(served):
    _, server, base = served
    results = []
    threads = [threading.Thread(target=lambda s=s: results.append(
        _post(base + "/generate", {"prompt": "x", "seed": s}))) for s in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert len(results) == 3
    assert all(code == 200 and rec["status"] == "done" for code, rec in results)
    # the jobs never overlapped on the executor: their run windows are disjoint
    done = sorted((j.started_at, j.finished_at) for j in list(server._jobs.values())
                  if j.status == "done")
    for (_, fin), (start, _) in zip(done, done[1:]):
        assert start >= fin - 1e-6


def test_bad_requests_rejected(served):
    _, _, base = served
    for payload in ({}, {"prompt": ""}, {"prompt": "x", "stepz": 3}, [1, 2], "nope"):
        assert _status(_post, base + "/generate", payload) == 400
    assert _status(_get, base + "/jobs/nope") == 404
    assert _status(_get, base + "/nowhere") == 404


def test_bad_timeout_rejected(served):
    _, _, base = served
    for bad in (0, -1, "soon"):
        assert _status(_post, base + "/generate", {"prompt": "x", "timeout_s": bad}) == 400


def test_pipeline_error_surfaces_as_500(served):
    _, _, base = served
    # FLUX's generate takes no negative_prompt: refused up front
    assert _status(_post, base + "/generate", {"prompt": "x", "negative_prompt": "y"}) == 400
    # a value that passes the gate but fails inside generate() -> 500, and
    # the server goes on serving
    assert _status(_post, base + "/generate", {"prompt": "x", "seed": "not-an-int"}) == 500
    code, rec = _post(base + "/generate", {"prompt": "still alive"})
    assert code == 200 and rec["status"] == "done"


def test_job_history_eviction_and_latents_release(served):
    server = PipelineServer(_SlowPipe(delay=0.0), job_history=2)
    try:
        ids = []
        for i in range(3):
            j = server.submit({"prompt": f"p{i}"})
            assert j.done_event.wait(WAIT)
            ids.append(j.job_id)
        assert server.get(ids[0]) is None          # evicted
        assert server.get(ids[1]) is not None and server.get(ids[2]) is not None
    finally:
        server.shutdown()
    # latents_b64 leaves the kept record after its first delivery
    _, _, base = served
    code, rec = _post(base + "/generate", {"prompt": "big", "return_latents": True})
    assert code == 200 and "latents_b64" in rec["result"]
    code, rec2 = _get(base + "/jobs/" + rec["job_id"])
    assert code == 200 and "latents_b64" not in rec2["result"]


# ------------------------------------------------------------ the safelist
def test_request_safelist_refuses_what_jax_forwards():
    """The JAX server lets a request set any generate() keyword
    (``_pipeline_kwargs``, ``serve/server.py:75-83``): Open-Sora's ``refs``
    (';'-separated file paths) and Wan's ``image_latents`` among them. The
    port takes negative_prompt and seed, the override and control keys, and
    answers 400 to anything else."""
    from magcache_tpu.pipelines.open_sora import OpenSoraPipeline as JOpenSora
    from magcache_tpu.pipelines.wan import WanPipeline as JWan
    from magcache_tpu.serve.server import _pipeline_kwargs
    from magcache_tpu_torch.pipelines.open_sora import (OpenSoraPipeline,
                                                        OpenSoraPipelineConfig)

    # the JAX list, read from the generate() signatures alone (no JAX job)
    assert "refs" in _pipeline_kwargs(types.SimpleNamespace(generate=JOpenSora.generate))
    jwan = _pipeline_kwargs(types.SimpleNamespace(generate=JWan.generate))
    assert {"image_latents", "vace_context", "clip_features"} <= set(jwan)

    os_pipe = OpenSoraPipeline(OpenSoraPipelineConfig(
        tiny=True, num_frames=8, height=32, width=32, num_sampling_steps=2,
        caption_len=6, dtype="float32"), "cpu")
    for pipe, field, value in ((os_pipe, "refs", "/etc/passwd;x.npy"),
                               (_wan(), "image_latents", [[0.0]]),
                               (_wan(), "vace_context", [[0.0]])):
        server = PipelineServer(pipe, steps=2)
        httpd, base = _start(server)
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base + "/generate", {"prompt": "x", field: value})
            assert ei.value.code == 400
            assert field in json.loads(ei.value.read())["error"]
            assert server.stats()["served"] == 0   # nothing reached generate()
            code, rec = _post(base + "/generate", {"prompt": "x", "seed": 1,
                                                   "negative_prompt": "blurry"})
            assert code == 200 and rec["status"] == "done"
        finally:
            httpd.shutdown()
            server.shutdown()


def test_override_rejected_for_unsupported_pipeline():
    server = PipelineServer(_SlowPipe(delay=0.0), steps=2)
    httpd, base = _start(server)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/generate", {"prompt": "x", "magcache_thresh": 0.2})
        assert ei.value.code == 400
        assert "skip_mask_for" in json.loads(ei.value.read())["error"]
    finally:
        httpd.shutdown()
        server.shutdown()


# ------------------------------------------------ per-request schedules
@pytest.fixture(scope="module")
def wan_served():
    pipe = _wan(sample_steps=4, use_magcache=True)
    server = PipelineServer(pipe, steps=4)
    httpd, base = _start(server)
    yield pipe, server, base
    httpd.shutdown()
    server.shutdown()


def test_override_requests_follow_their_masks(wan_served):
    """E/K/R and full compute per request, each through skip_mask_for; the
    served latents equal a direct generate with that mask."""
    pipe, _, base = wan_served
    _, info = _get(base + "/info")
    assert info["overrides_supported"] is True
    fast = {"magcache_thresh": 0.5, "magcache_K": 4, "retention_ratio": 0.25}
    _, rec_fast = _post(base + "/generate", {"prompt": "a fox", "seed": 5,
                                             "return_latents": True, **fast})
    _, rec_full = _post(base + "/generate", {"prompt": "a fox", "seed": 5,
                                             "return_latents": True, "use_magcache": False})
    mask = pipe.skip_mask_for(thresh=0.5, K=4, retention_ratio=0.25)
    assert rec_fast["result"]["skipped_forwards"] == int(mask.sum()) > 0
    assert rec_fast["result"]["total_forwards"] == mask.size == 8   # 4 steps x 2 lanes
    assert rec_full["result"]["skipped_forwards"] == 0
    direct = pipe.generate("a fox", seed=5, skip_override=mask)
    np.testing.assert_array_equal(_latents(rec_fast), direct.latents.numpy())
    np.testing.assert_array_equal(
        _latents(rec_full),
        pipe.generate("a fox", seed=5, skip_override=np.zeros_like(mask)).latents.numpy())
    # full compute is the uncached config's run on the same weights, up to
    # where the residual is rounded (h, or hidden + (h - hidden)), as in JAX
    full = tpipe.WanPipeline(dataclasses.replace(pipe.config, use_magcache=False),
                             "cpu", model=pipe.model)
    np.testing.assert_allclose(_latents(rec_full), full.generate("a fox", seed=5).latents.numpy(),
                               rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------- batching
def test_micro_batching_pads_and_matches_single_runs():
    """max_batch 2: concurrent plain requests run as one generate_batch of
    2; a lone one runs at its own size, not padded to max_batch as in JAX
    (eager PyTorch has no shape to keep). Each element's noise is its own
    seed's, and an element equals its single run."""
    pipe = _wan()
    sizes, generate_batch = [], pipe.generate_batch

    def recording_batch(prompts, **kw):
        sizes.append(len(prompts))
        return generate_batch(prompts, **kw)

    pipe.generate_batch = recording_batch
    server = PipelineServer(pipe, steps=3, max_batch=2, batch_window_s=5.0)
    try:
        assert server.warmup(timeout=WAIT)["status"] == "done"   # the largest batch
        jobs = [server.submit({"prompt": p, "seed": s}) for p, s in (("a cat", 1), ("a dog", 2))]
        assert all(j.done_event.wait(WAIT) for j in jobs)
        assert all(j.status == "done" for j in jobs), [j.error for j in jobs]
        assert all(j.result["batched"] == 2 for j in jobs)
        assert jobs[0].started_at == jobs[1].started_at      # one executor pass
        assert jobs[0].result["latents_shape"] == [1] + list(pipe.latent_shape)
        j3 = server.submit({"prompt": "a fox", "seed": 3})   # alone: a batch of 1
        assert j3.done_event.wait(WAIT) and j3.status == "done"
        assert j3.result["batched"] == 1
    finally:
        server.shutdown()
    assert sizes == [2, 2, 1]
    pair = generate_batch(["a cat", "a dog"], seeds=[1, 2]).latents
    solo = generate_batch(["a cat"], seeds=[1]).latents
    np.testing.assert_array_equal(pair[0].numpy(), solo[0].numpy())
    np.testing.assert_array_equal(solo[0].numpy(), pipe.generate("a cat", seed=1).latents[0].numpy())


def test_non_batchable_request_defers_not_drops():
    server = PipelineServer(_wan(sample_steps=2), steps=2, max_batch=2, batch_window_s=5.0)
    try:
        a = server.submit({"prompt": "a", "seed": 0})
        b = server.submit({"prompt": "b", "seed": 0, "negative_prompt": "ugly"})
        c = server.submit({"prompt": "c", "seed": 0})
        assert all(j.done_event.wait(WAIT) for j in (a, b, c))
        assert all(j.status == "done" for j in (a, b, c)), [j.error for j in (a, b, c)]
        assert "batched" not in b.result                   # ran alone
    finally:
        server.shutdown()


def test_max_batch_requires_generate_batch():
    with pytest.raises(ValueError, match="generate_batch"):
        PipelineServer(_SlowPipe(), max_batch=2)


def test_save_dir_disables_micro_batching(tmp_path):
    class BatchPipe:
        def generate(self, prompt, **kw):
            return _Out(image=(np.ones((4, 4, 3)) * 255).astype(np.uint8))

        def generate_batch(self, prompts, seeds=None):
            raise AssertionError("must not batch when save_dir is set")

    server = PipelineServer(BatchPipe(), save_dir=str(tmp_path), max_batch=2,
                            batch_window_s=0.3)
    try:
        jobs = [server.submit({"prompt": p}) for p in ("a", "b")]
        for j in jobs:
            assert j.done_event.wait(WAIT) and j.status == "done", j.error
            assert "batched" not in j.result and j.result["media_path"].endswith(".png")
    finally:
        server.shutdown()


def test_media_saved_when_save_dir_set(tmp_path):
    server = PipelineServer(_flux(), steps=4, save_dir=str(tmp_path))
    try:
        job = server.submit({"prompt": "a fox"})
        assert job.done_event.wait(WAIT) and job.status == "done", job.error
        assert "media_path" not in job.result      # no VAE: no decoded media
    finally:
        server.shutdown()

    class VideoPipe:                               # a pipeline's [1, F, H, W, 3] tensor
        def generate(self, prompt, **kw):
            out = _Out()
            out.video = torch.zeros(1, 3, 8, 8, 3)
            return out

    for pipe, ext in ((types.SimpleNamespace(generate=lambda p, **kw: _Out(
            image=(np.ones((8, 8, 3)) * 255).astype(np.uint8))), ".png"),
                      (VideoPipe(), ".mp4")):
        server = PipelineServer(pipe, save_dir=str(tmp_path))
        try:
            job = server.submit({"prompt": "x"})
            assert job.done_event.wait(WAIT) and job.status == "done", job.error
            path = job.result["media_path"]
            assert path.endswith((ext, ".npy")) and os.path.exists(path)
        finally:
            server.shutdown()


@pytest.fixture(scope="module")
def batch_pair():
    """The JAX and the port's tiny Wan (UniPC, MagCache) on the same weights."""
    base = dict(tiny=True, size=(64, 32), frame_num=9, sample_steps=6, sample_shift=5.0,
                guide_scale=5.0, dtype="float32", use_magcache=True, magcache_thresh=0.3)
    j = jpipe.WanPipeline(jpipe.WanPipelineConfig(**base))
    tcfg = tpipe.WanPipelineConfig(**base)
    model = tpipe.WanModel(tcfg.model_config(), "cpu")
    model.load_state_dict(wan_params_from_numpy(jax.tree.map(np.asarray, j.params),
                                                tcfg.model_config(), "cpu"))
    return j, tpipe.WanPipeline(tcfg, "cpu", model=model)


def test_generate_batch_matches_jax_and_single_runs(batch_pair, monkeypatch):
    jp, tp = batch_pair
    prompts, seeds = ["a red boat", "a blue bird"], [4, 9]
    want = np.asarray(jp.generate_batch(prompts, seeds=seeds).latents)
    draws = [np.asarray(jax.random.normal(j_set_seed(s), (1,) + jp.latent_shape, jnp.float32))
             for s in seeds]
    feed = iter(draws * 2)                     # the batch, then the two single runs
    monkeypatch.setattr(tp, "_initial_noise", lambda gen: torch.from_numpy(next(feed).copy()))
    out = tp.generate_batch(prompts, seeds=seeds)
    assert out.latents.shape == (2,) + tp.latent_shape and out.timings["prompts"] == 2
    np.testing.assert_allclose(out.latents.numpy(), want, atol=TOL, rtol=TOL)
    assert tp.skip_mask_for().any()
    for j, (p, s) in enumerate(zip(prompts, seeds)):
        single = tp.generate(p, seed=s)
        np.testing.assert_array_equal(single.skips, tp.skip_mask_for())
        np.testing.assert_allclose(out.latents[j].numpy(), single.latents[0].numpy(),
                                   atol=1e-6, rtol=1e-6)


def test_generate_batch_draws_and_refusals():
    pipe = _wan(sample_steps=2)
    # without seeds, element j draws from seed + j
    a = pipe.generate_batch(["x", "x"], seed=3).latents
    b = pipe.generate_batch(["x", "x"], seeds=[3, 4]).latents
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="seeds"):
        pipe.generate_batch(["x", "y"], seeds=[1])
    with pytest.raises(ValueError, match="text prompts"):
        tpipe.WanPipeline(tpipe.WanPipelineConfig(
            model="wan2.1-vace-1.3B", task="vace", tiny=True, size=(64, 32), frame_num=9,
            sample_steps=2), "cpu").generate_batch(["x"])
    # the A14B MoE batches through its two-expert sampler
    moe = tpipe.WanPipeline(tpipe.WanPipelineConfig(
        model="wan2.2-t2v-A14B", tiny=True, size=(64, 32), frame_num=9, sample_steps=4,
        dtype="float32"), "cpu")
    got = moe.generate_batch(["x", "y"], seeds=[1, 2]).latents
    np.testing.assert_allclose(got[1].numpy(), moe.generate("y", seed=2).latents[0].numpy(),
                               atol=1e-6, rtol=1e-6)


# ------------------------------------------------------- the watchdog
def test_queue_full_returns_503():
    server = PipelineServer(_SlowPipe(delay=1.0), max_queue=1)
    httpd, base = _start(server)
    try:
        first = server.submit({"prompt": "occupies the executor"})
        time.sleep(0.2)
        server.submit({"prompt": "fills the queue"})
        with pytest.raises(QueueFullError):
            server.submit({"prompt": "bounces"})
        assert _status(_post, base + "/generate", {"prompt": "bounces", "async": True}) == 503
        assert first.done_event.wait(WAIT)
    finally:
        httpd.shutdown()
        server.shutdown()


def test_cancel_queued_job_and_running_job():
    server = PipelineServer(_SlowPipe(delay=0.8))
    httpd, base = _start(server)
    try:
        running = server.submit({"prompt": "runs"})
        queued = server.submit({"prompt": "waits"})
        time.sleep(0.2)
        code, rec = _post(base + f"/jobs/{queued.job_id}/cancel", {})
        assert code == 200 and rec["status"] == "cancelled" and queued.done_event.is_set()
        assert _status(_post, base + f"/jobs/{running.job_id}/cancel", {}) == 409
        assert running.done_event.wait(WAIT) and running.status == "done"
        assert queued.status == "cancelled" and queued.result is None
        assert _status(_post, base + "/jobs/nope/cancel", {}) == 404
    finally:
        httpd.shutdown()
        server.shutdown()


@pytest.mark.parametrize("where", ["request", "server default"])
def test_job_timeout_fails_job_and_server_survives(where):
    kw = dict(default_timeout_s=0.2) if where == "server default" else {}
    req = {} if kw else {"timeout_s": 0.2}
    server = PipelineServer(_SlowPipe(delay=1.5), watchdog_interval_s=0.05, **kw)
    try:
        job = server.submit({"prompt": "too slow", **req})
        assert job.done_event.wait(10)
        assert job.status == "timeout" and "run budget" in job.error
        # the executor finishes the stale run, discards it and serves on
        server.pipeline.delay = 0.0
        nxt = server.submit({"prompt": "still serving", "timeout_s": 30})
        assert nxt.done_event.wait(WAIT) and nxt.status == "done"
    finally:
        server.shutdown()


def test_worker_death_fails_queued_jobs_and_healthz_503():
    server = PipelineServer(_SlowPipe(fail=SystemExit("executor killed")),
                            watchdog_interval_s=0.05)
    httpd, base = _start(server)
    try:
        job = server.submit({"prompt": "kills the worker"})
        assert job.done_event.wait(10)
        deadline = time.time() + 10
        while server._worker.is_alive() and time.time() < deadline:
            time.sleep(0.05)
        assert not server._worker.is_alive()
        assert _status(_get, base + "/healthz") == 503
        assert _status(_post, base + "/generate", {"prompt": "x", "async": True}) == 503
    finally:
        httpd.shutdown()
        server.shutdown()


def test_shutdown_drains_queued_jobs():
    server = PipelineServer(_SlowPipe(delay=0.6))
    jobs = [server.submit({"prompt": f"j{i}"}) for i in range(3)]
    time.sleep(0.1)
    server.shutdown(timeout=5.0)
    for j in jobs:
        assert j.done_event.wait(5), j.job_id
        assert j.status in ("done", "error"), j.status
    assert any(j.status == "error" for j in jobs)


def test_sync_wait_timeout_returns_504_then_pollable():
    server = PipelineServer(_SlowPipe(delay=1.0), sync_wait_s=0.15)
    httpd, base = _start(server)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/generate", {"prompt": "slow"})
        assert ei.value.code == 504
        job_id = json.loads(ei.value.read())["job_id"]
        deadline = time.time() + 30
        while time.time() < deadline:
            _, rec = _get(base + "/jobs/" + job_id)
            if rec["status"] == "done":
                break
            time.sleep(0.1)
        assert rec["status"] == "done"
    finally:
        httpd.shutdown()
        server.shutdown()


def test_executor_runs_jobs_in_inference_mode():
    """Grad mode is thread-local: the executor sets inference mode itself."""
    seen = []

    class Probe:
        def generate(self, prompt, **kw):
            seen.append(torch.is_inference_mode_enabled())
            return _Out()

    server = PipelineServer(Probe())
    try:
        job = server.submit({"prompt": "x"})
        assert job.done_event.wait(WAIT) and job.status == "done"
    finally:
        server.shutdown()
    assert seen == [True] and not torch.is_inference_mode_enabled()


# ------------------------------------------------------- engine, CLI, helpers
def test_engine_builds_serves_and_saves(tmp_path):
    from magcache_tpu_torch.core.engine import Engine

    cfg = FluxPipelineConfig(tiny=True, height=64, width=64, txt_len=8,
                             num_inference_steps=2, dtype="float32")
    engine = Engine(cfg, device="cpu")
    assert isinstance(engine.driver_pipeline, FluxPipeline)
    assert engine.driver_pipeline.device.type == "cpu"
    out = engine.generate("a fox", seed=1)
    assert torch.isfinite(out.latents).all()
    httpd, server = engine.serve(port=0)
    try:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        code, rec = _post("http://127.0.0.1:%d/generate" % httpd.server_address[1],
                          {"prompt": "a fox", "seed": 1, "return_latents": True})
        assert code == 200
        np.testing.assert_array_equal(_latents(rec), out.latents.numpy())
    finally:
        httpd.shutdown()
        server.shutdown()
        engine.shutdown()
    assert engine.save_image(np.zeros((4, 4, 3), np.float32),
                             str(tmp_path / "a.png")).startswith(str(tmp_path))
    with pytest.raises(ValueError, match="pipeline_cls"):
        Engine(object(), device="cpu")


def test_save_falls_back_to_npy_only_without_a_writer(tmp_path, monkeypatch):
    """A format imageio has no backend for (an mp4 without ffmpeg) saves as
    .npy; any other error of the write, such as malformed frames, surfaces."""
    import sys
    import types

    from magcache_tpu_torch.utils.misc import save_image, save_video

    def raising(msg):
        def write(*args, **kwargs):
            raise ValueError(msg)
        return write

    fake = types.ModuleType("imageio")
    fake.mimwrite = raising("Could not find a backend to open `x.mp4` with iomode `wI`.")
    fake.imwrite = raising("Image must be 2D (grayscale, RGB, or RGBA).")
    monkeypatch.setitem(sys.modules, "imageio", fake)
    frames = np.zeros((2, 8, 8, 3), np.float32)
    got = save_video(frames, str(tmp_path / "v" / "a.mp4"))
    assert got == str(tmp_path / "v" / "a.npy") and np.load(got).dtype == np.uint8
    with pytest.raises(ValueError, match="Image must be 2D"):
        save_image(np.zeros((8, 8, 7), np.uint8), str(tmp_path / "b.png"))
    assert not (tmp_path / "b.npy").exists()
    monkeypatch.setitem(sys.modules, "imageio", None)       # not installed
    assert save_image(frames[0], str(tmp_path / "c.png")) == str(tmp_path / "c.npy")


def test_serve_cli_parser_has_flags():
    from magcache_tpu_torch.cli.serve import build_serve_parser

    args = build_serve_parser().parse_args(["--task", "flux-dev", "--tiny", "--port", "0",
                                            "--warmup", "--max_batch", "2"])
    assert args.port == 0 and args.warmup and args.task == "flux-dev"
    assert args.max_batch == 2 and args.device == "cuda"


def test_serve_cli_answers_on_the_cpu():
    """``cli.serve --tiny --device cpu`` as a subprocess: an override's skip
    counts are skip_mask_for's, a field outside the safelist is a 400, and
    SIGINT exits 0."""
    from magcache_tpu_torch.cli.generate import _pipeline
    from magcache_tpu_torch.cli.serve import build_serve_parser

    argv = ["--task", "t2v-1.3B", "--tiny", "--device", "cpu", "--use_magcache",
            "--sample_steps", "8"]
    proc = subprocess.Popen([sys.executable, "-m", "magcache_tpu_torch.cli.serve",
                             *argv, "--port", "0"], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=dict(os.environ, PYTHONPATH=REPO))
    lines = []
    try:
        reader = threading.Thread(target=lambda: [lines.append(l) for l in proc.stdout],
                                  daemon=True)
        reader.start()
        deadline = time.time() + WAIT
        while not any(l.startswith("serving") for l in lines) and time.time() < deadline:
            assert proc.poll() is None, "".join(lines)
            time.sleep(0.1)
        line = next(l for l in lines if l.startswith("serving"))
        assert line.startswith("serving WanPipeline (t2v-1.3B) on http://127.0.0.1:")
        base = line.split(" on ")[1].split()[0]
        code, rec = _post(base + "/generate", {"prompt": "a cat", "seed": 3,
                                               "magcache_thresh": 0.24, "magcache_K": 6})
        mask = _pipeline(build_serve_parser().parse_args(argv))[0].skip_mask_for(
            thresh=0.24, K=6)
        assert code == 200 and rec["result"]["skipped_forwards"] == int(mask.sum()) > 0
        assert rec["result"]["total_forwards"] == mask.size == 16
        assert _status(_post, base + "/generate", {"prompt": "a cat", "image": "x.png"}) == 400
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_helpers_task_fps_seed_logger_trace(tmp_path, caplog):
    from magcache_tpu.utils.misc import task_fps as j_task_fps
    from magcache_tpu_torch.core.presets import make_config
    from magcache_tpu_torch.utils.logging import get_logger
    from magcache_tpu_torch.utils.misc import set_seed, task_fps
    from magcache_tpu_torch.utils.trace import StepTimer, log_skip_schedule, profile_trace

    for task in ("latte", "vchitect", "cogvideox-2b", "ti2v-5B", "hunyuan-t2v",
                 "open-sora", "open-sora-plan", "framepack", "t2v-1.3B", "flux-dev"):
        assert task_fps(task) == j_task_fps(task)
    assert task_fps("framepack") == 30 and task_fps("t2v-1.3B") == 16
    draw = lambda g: torch.randn(3, generator=g)
    torch.testing.assert_close(draw(set_seed(5, dp_rank=2)), draw(set_seed(7)), atol=0, rtol=0)
    log = get_logger("magcache_tpu_torch.test")
    assert get_logger("magcache_tpu_torch.test") is log and len(log.handlers) == 1
    timer = StepTimer()
    with timer.section("a"):
        pass
    assert timer.summary().startswith("a ")
    cfg = make_config("wan2.1-t2v-1.3B", 10)
    assert log_skip_schedule(cfg).sum() > 0
    with profile_trace(None) as prof:
        assert prof is None
    with profile_trace(str(tmp_path / "tr")):
        torch.ones(4).sum()
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
