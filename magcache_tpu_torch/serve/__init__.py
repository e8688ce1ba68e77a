"""HTTP serving of one warm pipeline (counterpart of ``magcache_tpu.serve``)."""

from magcache_tpu_torch.serve.server import Job, PipelineServer, QueueFullError, make_http_server

__all__ = ["Job", "PipelineServer", "QueueFullError", "make_http_server"]
