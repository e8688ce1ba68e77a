"""FramePack's streaming demo: the reference gradio UI's interaction surface
(``MagCache4FramePack/magcache_demo_gradio.py``) over the port's pipeline,
the counterpart of ``magcache_tpu.ui.framepack_demo``.

- A worker thread runs the sectioned generation and pushes ``("progress",
  ...)``, ``("file", path)``, ``("error", repr)`` and ``("end", None)``
  events that the UI drains (reference ``AsyncStream``, ``worker``
  :406-633, ``process`` :637-662).
- Stop sets a flag on the input side; the worker checks it at each section
  boundary (a section is one sampler call).
- Every finished section re-saves the growing latents so the UI's file
  widget refreshes (the reference re-decodes a growing mp4, :595-621;
  HunyuanVideo's VAE is not ported, so the port saves latents).
- The MagCache and TeaCache checkboxes exclude each other (:30-52).

The gradio layer is optional: ``build_ui`` raises a clear error when gradio
is missing; everything under it is plain Python.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["AsyncStream", "DemoSession", "handle_magcache_change",
           "handle_teacache_change", "build_ui", "main"]


def handle_magcache_change(magcache_value: bool, teacache_value: bool):
    """Checking MagCache unchecks TeaCache (``:30-41``); the new (magcache,
    teacache) values."""
    if magcache_value and teacache_value:
        return True, False
    return magcache_value, teacache_value


def handle_teacache_change(magcache_value: bool, teacache_value: bool):
    """Checking TeaCache unchecks MagCache (``:43-52``)."""
    if magcache_value and teacache_value:
        return False, True
    return magcache_value, teacache_value


class AsyncStream:
    """An input flag and an output event queue between the worker and the
    UI (the reference's ``diffusers_helper.thread_utils.AsyncStream``)."""

    def __init__(self):
        self._in_flag: Optional[str] = None
        self._lock = threading.Lock()
        self.output_queue: "queue.Queue[tuple]" = queue.Queue()

    def push_input(self, flag: str):
        with self._lock:
            self._in_flag = flag

    def input_top(self) -> Optional[str]:
        with self._lock:
            return self._in_flag

    def push(self, event: tuple):
        self.output_queue.put(event)

    def next(self, timeout: Optional[float] = None) -> tuple:
        return self.output_queue.get(timeout=timeout)


class _Interrupted(Exception):
    pass


class DemoSession:
    """One generation at a time: builds (or reuses) a ``FramePackPipeline``
    on ``device`` from the UI's settings and streams its sections;
    ``events()`` is the UI-facing generator. Files go to ``out_dir``."""

    def __init__(self, pipeline=None, out_dir: str = os.path.join("build", "framepack_demo"),
                 device="cuda"):
        self.pipeline = pipeline
        self.out_dir = out_dir
        self.device = device
        self.stream: Optional[AsyncStream] = None
        self._thread: Optional[threading.Thread] = None
        self._built_kw: Optional[dict] = None      # the settings it was built from

    def _build_pipeline(self, **cfg_kw):
        from magcache_tpu_torch.pipelines.framepack import (FramePackPipeline,
                                                            FramePackPipelineConfig)

        return FramePackPipeline(FramePackPipelineConfig(**cfg_kw), self.device)

    def _worker(self, prompt: str, seed: int, start_latent, stream: AsyncStream):
        pipe = self.pipeline
        os.makedirs(self.out_dir, exist_ok=True)
        job = f"job_{int(time.time() * 1000)}_{seed}"
        total = pipe.config.total_sections
        stream.push(("progress", (None, "Starting ...", 0)))
        done: list = []

        def on_section(i, sec):
            done.append(sec.cpu().numpy())
            if stream.input_top() == "end":
                raise _Interrupted()
            # sections arrive in generation order (back to front in padded
            # mode); the saved file holds those done so far
            hist = np.concatenate(done, axis=1)
            path = os.path.join(self.out_dir, f"{job}_{hist.shape[1]}.npy")
            np.save(path, hist)
            stream.push(("progress", (sec, f"section {len(done)}/{total}",
                                      int(100 * len(done) / total))))
            stream.push(("file", path))

        try:
            pipe.generate(prompt, seed=seed, on_section=on_section, start_latent=start_latent)
        except _Interrupted:
            pass
        except Exception as e:      # the UI shows the worker's failure
            stream.push(("error", repr(e)))
        stream.push(("end", None))

    def start(self, prompt: str, seed: int = 31337, start_latent=None,
              **cfg_kw) -> AsyncStream:
        """Start Generation: rebuilds the pipeline when the settings changed
        since it was built (a given pipeline is kept); refuses while a run
        is live."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("a generation is already running; press Stop "
                               "(session.end) and wait for it to finish first")
        if self.pipeline is None or (self._built_kw is not None and cfg_kw
                                     and dict(cfg_kw) != self._built_kw):
            self.pipeline = self._build_pipeline(**cfg_kw)
            self._built_kw = dict(cfg_kw)
        if start_latent is not None:
            start_latent = torch.as_tensor(start_latent)
        self.stream = AsyncStream()
        self._thread = threading.Thread(
            target=self._worker, args=(prompt, seed, start_latent, self.stream), daemon=True)
        self._thread.start()
        return self.stream

    def end(self):
        """The Stop button (``end_process``, :665-666)."""
        if self.stream is not None:
            self.stream.push_input("end")

    def events(self, timeout: float = 600.0):
        """Worker events until ``"end"`` (the ``process()`` generator)."""
        if self.stream is None:
            raise RuntimeError("start() first")
        while True:
            flag, data = self.stream.next(timeout=timeout)
            yield flag, data
            if flag == "end":
                return

    def join(self, timeout: float = 600.0):
        if self._thread is not None:
            self._thread.join(timeout=timeout)


def build_ui(session: Optional[DemoSession] = None, **cfg_kw):
    """The gradio Blocks around a ``DemoSession``: prompt, seed, the cache
    checkboxes and sliders, Start and Stop, the growing file. Needs gradio,
    which this package does not depend on."""
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError("gradio is not installed; install it to serve the demo UI. "
                          "The generation worker (DemoSession) runs without it.") from e

    session = session or DemoSession()

    def process(prompt, seed, use_magcache, use_teacache, thresh, K, ret):
        session.start(prompt, seed=int(seed), use_magcache=use_magcache,
                      use_teacache=use_teacache, magcache_thresh=thresh or None,
                      magcache_K=int(K) if K else None, retention_ratio=ret or None,
                      **cfg_kw)
        # outputs: the file, Start, Stop, the status line
        busy = (gr.update(interactive=False), gr.update(interactive=True))
        for flag, data in session.events():
            if flag == "file":
                yield (data,) + busy + (gr.update(),)
            elif flag == "progress":
                yield (gr.update(),) + busy + (f"{data[1]} ({data[2]}%)",)
            elif flag == "error":
                yield (gr.update(),) + busy + (f"**Generation failed:** {data}",)
        yield (gr.update(), gr.update(interactive=True), gr.update(interactive=False),
               gr.update())

    with gr.Blocks(title="FramePack (magcache_tpu_torch)") as block:
        gr.Markdown("# FramePack: sectioned streaming generation")
        with gr.Row():
            with gr.Column():
                prompt = gr.Textbox(label="Prompt")
                seed = gr.Number(label="Seed", value=31337, precision=0)
                use_magcache = gr.Checkbox(label="Use MagCache", value=True)
                use_teacache = gr.Checkbox(label="Use TeaCache", value=False)
                thresh = gr.Slider(0.0, 1.0, value=0.1, label="magcache_thresh")
                K = gr.Slider(0, 10, value=3, step=1, label="magcache_K")
                ret = gr.Slider(0.0, 1.0, value=0.2, label="retention_ratio")
                start_btn = gr.Button("Start Generation")
                end_btn = gr.Button("End Generation", interactive=False)
            with gr.Column():
                out_file = gr.File(label="Output (growing)")
                status = gr.Markdown("")
        use_magcache.change(handle_magcache_change, [use_magcache, use_teacache],
                            [use_magcache, use_teacache])
        use_teacache.change(handle_teacache_change, [use_magcache, use_teacache],
                            [use_magcache, use_teacache])
        start_btn.click(process, [prompt, seed, use_magcache, use_teacache, thresh, K, ret],
                        [out_file, start_btn, end_btn, status])
        end_btn.click(lambda: session.end(), [], [])
    return block


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser("framepack demo server")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    build_ui(DemoSession(device=args.device)).queue().launch(server_port=args.port)


if __name__ == "__main__":
    main()
