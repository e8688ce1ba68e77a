"""The port's FramePack demo session (``ui/framepack_demo.py``, no gradio)
on the CPU: the checkbox exclusion, the worker's event stream and growing
files, Stop between sections, the rebuild on changed settings, the F1
variant, the worker's errors, and ``build_ui`` without gradio; the
handlers held against the JAX package's."""

import numpy as np
import pytest
import torch

from magcache_tpu.ui import framepack_demo as J
from magcache_tpu_torch.pipelines.framepack import FramePackPipeline, FramePackPipelineConfig
from magcache_tpu_torch.ui import framepack_demo as T

TINY = dict(tiny=True, pyramid=False, height=64, width=64, txt_len=8, latent_window_size=2,
            steps=3, dtype="float32")


def test_checkbox_mutual_exclusion_matches_jax():
    for a in (False, True):
        for b in (False, True):
            assert T.handle_magcache_change(a, b) == J.handle_magcache_change(a, b)
            assert T.handle_teacache_change(a, b) == J.handle_teacache_change(a, b)
    assert T.handle_magcache_change(True, True) == (True, False)
    assert T.handle_teacache_change(True, True) == (False, True)


def _session(tmp_path, sections=3):
    pipe = FramePackPipeline(FramePackPipelineConfig(total_sections=sections, **TINY), "cpu")
    return T.DemoSession(pipeline=pipe, out_dir=str(tmp_path), device="cpu")


def test_worker_streams_sections_and_files(tmp_path):
    s = _session(tmp_path, sections=3)
    s.start("a cat", seed=0)
    events = list(s.events())
    s.join()
    flags = [f for f, _ in events]
    assert flags[-1] == "end" and flags.count("file") == 3 and "error" not in flags
    pcts = [d[2] for f, d in events if f == "progress" and d[0] is not None]
    assert pcts == [33, 66, 100]
    lens = [np.load(d).shape[1] for f, d in events if f == "file"]
    assert lens == [2, 4, 6]
    # the last file is the pipeline's own output for the request
    want = s.pipeline.generate("a cat", seed=0).latents.numpy()
    np.testing.assert_array_equal(np.load([d for f, d in events if f == "file"][-1]), want)


def test_end_interrupts_after_first_section(tmp_path):
    s = _session(tmp_path, sections=4)
    s.start("a cat", seed=0)
    files = 0
    for flag, _ in s.events():
        if flag == "file":
            files += 1
            s.end()                       # Stop after the first artifact
    s.join()
    assert 1 <= files < 4


def test_settings_change_rebuilds_pipeline_and_start_guards_running(tmp_path):
    s = T.DemoSession(out_dir=str(tmp_path), device="cpu")
    kw = dict(TINY, total_sections=2)
    s.start("a cat", seed=0, **kw)
    with pytest.raises(RuntimeError, match="already running"):
        s.start("a cat", seed=1, **kw)
    list(s.events())
    s.join()
    first = s.pipeline
    assert first.config.use_magcache is False and first.device == torch.device("cpu")
    s.start("a cat", seed=0, use_magcache=True, **kw)
    list(s.events())
    s.join()
    second = s.pipeline
    assert second is not first and second.config.use_magcache
    s.start("a cat", seed=2, use_magcache=True, **kw)
    list(s.events())
    s.join()
    assert s.pipeline is second


def test_f1_variant_start_latent_and_worker_errors(tmp_path):
    s = T.DemoSession(out_dir=str(tmp_path), device="cpu")
    start = np.full((1, 8, 8, 8), 0.1, np.float32)
    s.start("a fox", seed=1, start_latent=start, tiny=True, model="framepack-f1",
            height=64, width=64, txt_len=8, total_sections=2, steps=3, latent_window_size=2,
            use_magcache=True, dtype="float32")
    kinds = [flag for flag, _ in s.events()]
    s.join()
    assert kinds.count("file") == 2 and kinds[-1] == "end" and "error" not in kinds
    # both caches on: the pipeline's ValueError reaches the UI as an event
    s.start("a fox", seed=1, use_magcache=True, use_teacache=True, **dict(TINY, total_sections=1))
    events = list(s.events())
    s.join()
    errors = [d for f, d in events if f == "error"]
    assert len(errors) == 1 and "mutually exclusive" in errors[0]
    with pytest.raises(RuntimeError, match="start"):
        next(T.DemoSession().events())


def test_build_ui_needs_gradio():
    try:
        import gradio  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="gradio is not installed"):
            T.build_ui(T.DemoSession(device="cpu"))
    else:
        assert T.build_ui(T.DemoSession(device="cpu")) is not None
