"""Engine: build the pipeline a config names and run generations on it
(counterpart of ``magcache_tpu.core.engine``).

The reference's ``VideoSysEngine`` (``videosys/core/engine.py:13-128``)
spawns ``world_size - 1`` worker processes and broadcasts ``generate`` over
IPC queues. One process drives the one card here (sequence-parallel ranks
start as processes of their own, ``cli/generate.py``), so the Engine is a
thin holder of the ``Config -> engine.generate()`` surface, with warmup,
saving and serving.
"""

from __future__ import annotations

import numpy as np

from magcache_tpu_torch.pipelines.base import BasePipeline, PipelineOutput
from magcache_tpu_torch.utils.misc import save_image, save_video


class Engine:
    """Builds ``pipeline_cls(config, device, **pipeline_kwargs)``: the class
    given, else ``config.pipeline_cls``, else the class of a
    ``FluxPipelineConfig`` or ``WanPipelineConfig`` (the reference's
    ``config.pipeline_cls`` indirection, ``pipeline_open_sora.py:74``)."""

    def __init__(self, config, pipeline_cls=None, device="cuda", **pipeline_kwargs):
        if pipeline_cls is None:
            pipeline_cls = getattr(config, "pipeline_cls", None)
        if pipeline_cls is None:
            from magcache_tpu_torch.pipelines.flux import FluxPipeline, FluxPipelineConfig
            from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

            classes = {FluxPipelineConfig: FluxPipeline, WanPipelineConfig: WanPipeline}
            if type(config) not in classes:
                raise ValueError(f"no pipeline class for {type(config).__name__}; "
                                 f"pass pipeline_cls=")
            pipeline_cls = classes[type(config)]
        self.config = config
        self.driver_pipeline: BasePipeline = pipeline_cls(config, device, **pipeline_kwargs)

    def generate(self, prompt: str, **kwargs) -> PipelineOutput:
        return self.driver_pipeline.generate(prompt, **kwargs)

    def warmup(self, prompt: str = "warmup", **kwargs) -> None:
        """One generation before timed ones: kernel builds, allocator caches."""
        self.generate(prompt, **kwargs)

    def save_video(self, video: np.ndarray, path: str, fps: int = 16) -> str:
        return save_video(video, path, fps=fps)

    def save_image(self, image: np.ndarray, path: str) -> str:
        return save_image(image, path)

    def serve(self, host: str = "127.0.0.1", port: int = 8900,
              warmup: bool = False, **server_kwargs):
        """Expose this engine's pipeline over HTTP (``serve/server.py``).
        Returns ``(httpd, server)``; call ``httpd.serve_forever()`` to block."""
        from magcache_tpu_torch.serve import PipelineServer, make_http_server

        server = PipelineServer(self.driver_pipeline, **server_kwargs)
        if warmup:
            server.warmup()
        return make_http_server(server, host, port), server

    def shutdown(self) -> None:
        """No worker processes to tear down (a server from ``serve`` stops
        with its own ``shutdown``); kept for the reference engine's API."""
