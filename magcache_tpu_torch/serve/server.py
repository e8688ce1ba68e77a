"""HTTP serving endpoint: one warm pipeline behind a request queue
(counterpart of ``magcache_tpu.serve.server``).

The reference serves through ``VideoSysEngine``, a local worker pool with
pickled IPC queues and uuid-tagged futures (``videosys/core/engine.py:13-128``,
``videosys/core/mp_utils.py:60-254``). Here one long-lived process owns one
pipeline on its device and exposes it over HTTP:

- **One executor thread owns the device.** Requests flow through a FIFO queue
  into a single worker thread, so the host logic of two generations never
  interleaves on the card. PyTorch keeps grad mode and the current CUDA
  device per thread: the executor runs every job under
  ``torch.inference_mode()`` and makes the pipeline's device current before
  its first job.
- **Per-request cache schedules.** E/K/R overrides and full compute become a
  host-precomputed skip mask (``pipeline.skip_mask_for``) passed to
  ``generate(skip_override=...)``.
- **An explicit request safelist.** A request may carry ``negative_prompt``
  and ``seed`` (where the pipeline's ``generate`` takes them), the override
  keys and the control keys, and nothing else: no file paths (Open-Sora's
  ``refs``), latent payloads (``image_latents``, ``vace_context``,
  ``clip_features``) or images. Any other field is a 400.
- **uuid-tagged jobs**, sync and async, mirroring ``mp_utils.py:60-88``.
- **Watchdog** with the reference ``WorkerMonitor``'s semantics
  (``mp_utils.py:111-151``): if the executor dies, queued jobs fail instead
  of hanging; jobs over their run-time budget fail with ``status=timeout``.
  A running job cannot be preempted: its late result is discarded.
- **Micro-batching** (``max_batch > 1``, pipelines with ``generate_batch``):
  concurrent plain requests run as one batch of their own number (at most
  ``max_batch``), each element drawing its noise from its own seed.

Endpoints (JSON in and out):

  GET  /healthz          liveness, backend (device type; the card's name on
                         one), queue depth; 503 once the executor has died
  GET  /info             pipeline, steps and config of the served pipeline
  POST /generate         {"prompt": ..., "seed": 0, "negative_prompt": ...,
                          "async": false, "return_latents": false,
                          "timeout_s": 120,
                          "use_magcache": true, "magcache_thresh": 0.12,
                          "magcache_K": 2, "retention_ratio": 0.2}
                         sync -> the finished job record; async -> {"job_id"}
                         400 on a bad request, 503 when the queue is full,
                         504 when a sync wait runs out (the job goes on)
  GET  /jobs/<id>        job record (queued|running|done|error|cancelled|
                         timeout)
  POST /jobs/<id>/cancel cancel a queued job (409 once it is running)
"""

from __future__ import annotations

import base64
import collections
import dataclasses
import inspect
import io
import json
import os
import queue
import threading
import time
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np
import torch

from magcache_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# generate() keywords a request may set, where the pipeline's generate takes
# them; every other generate() keyword (paths, latents, images) stays closed
_REQUEST_KEYS = ("negative_prompt", "seed")
# per-request cache-schedule overrides -> pipeline.skip_mask_for()
_OVERRIDE_KEYS = ("use_magcache", "magcache_thresh", "magcache_K",
                  "retention_ratio")
_CONTROL_KEYS = ("prompt", "async", "return_latents", "timeout_s")
_MAX_LATENT_B64 = 32 * 1024 * 1024


def _request_keys(pipeline) -> tuple:
    """The safelisted keys ``pipeline.generate`` accepts (both when it takes
    ``**kwargs``)."""
    try:
        params = inspect.signature(pipeline.generate).parameters
    except (TypeError, ValueError):
        return _REQUEST_KEYS
    if any(p.kind is p.VAR_KEYWORD for p in params.values()):
        return _REQUEST_KEYS
    return tuple(k for k in _REQUEST_KEYS if k in params)


def _host(x) -> np.ndarray:
    """A result array on the host: a tensor leaves its device as f32 (or as
    it is when integer), anything else through ``np.asarray``."""
    if torch.is_tensor(x):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    return np.asarray(x)


def _timings(t: Optional[dict]) -> Optional[dict]:
    return {k: round(float(v), 3) for k, v in t.items()} if t else None


class QueueFullError(RuntimeError):
    """Raised by submit() when the request queue is at capacity."""


@dataclass
class Job:
    job_id: str
    request: Dict[str, Any]
    status: str = "queued"   # queued|running|done|error|cancelled|timeout
    result: Optional[Dict[str, Any]] = None
    error: Optional[str] = None
    submitted_at: float = field(default_factory=time.time)
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    deadline: Optional[float] = None     # run-time budget (watchdog-enforced)
    done_event: threading.Event = field(default_factory=threading.Event)

    def record(self, include_latents: bool = False) -> Dict[str, Any]:
        rec = {
            "job_id": self.job_id,
            "status": self.status,
            "queue_wait_s": (round(self.started_at - self.submitted_at, 3)
                             if self.started_at else None),
            "wall_s": (round(self.finished_at - self.started_at, 3)
                       if self.finished_at and self.started_at else None),
        }
        if self.result is not None:
            res = dict(self.result)
            if not include_latents:
                res.pop("latents_b64", None)
            rec["result"] = res
        if self.error is not None:
            rec["error"] = self.error
        return rec


class PipelineServer:
    """Owns a pipeline and the executor thread; ``submit()`` enqueues jobs."""

    def __init__(self, pipeline, steps: Optional[int] = None,
                 save_dir: Optional[str] = None, fps: int = 16,
                 max_queue: int = 64, max_batch: int = 1,
                 batch_window_s: float = 0.05,
                 job_history: int = 256,
                 default_timeout_s: Optional[float] = None,
                 sync_wait_s: float = 3600.0,
                 watchdog_interval_s: float = 0.25):
        """``max_batch > 1`` turns on micro-batching: the executor holds the
        first batchable job up to ``batch_window_s`` collecting more, then
        runs one ``generate_batch`` of the jobs it holds. It is not padded to
        ``max_batch`` as in JAX, where one static shape spares a recompile:
        eager PyTorch pays nothing for a new batch size, and padding would
        double a lone request's work. Per-element ``seeds`` keep each
        element's noise that of its single run. Needs a pipeline with
        ``generate_batch``.

        ``job_history`` bounds the finished-job records kept (the oldest are
        evicted), and a record's ``latents_b64`` is dropped once delivered.

        ``default_timeout_s`` and a request's ``timeout_s`` bound a job's run
        time; the watchdog fails jobs over budget (``status=timeout``) and
        queued jobs behind a dead executor."""
        self.pipeline = pipeline
        self.steps = steps
        self.save_dir = save_dir
        self.fps = fps
        self.max_batch = max_batch
        self.batch_window_s = batch_window_s
        self.job_history = job_history
        self.default_timeout_s = default_timeout_s
        self.sync_wait_s = sync_wait_s
        if max_batch > 1 and not hasattr(pipeline, "generate_batch"):
            raise ValueError(f"max_batch={max_batch} needs a pipeline with "
                             f"generate_batch; {type(pipeline).__name__} has none")
        self.device = torch.device(getattr(pipeline, "device", "cpu"))
        # the executor's current card: the pipeline's, or this thread's for "cuda"
        self._card = (None if self.device.type != "cuda" else self.device.index
                      if self.device.index is not None else torch.cuda.current_device())
        self._queue: "queue.Queue[Optional[Job]]" = queue.Queue(max_queue)
        self._jobs: Dict[str, Job] = {}
        self._done_order: "collections.deque[str]" = collections.deque()
        self._jobs_lock = threading.Lock()
        self._served = 0
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="magcache-serve-executor")
        self._worker.start()
        self._watchdog = threading.Thread(
            target=self._watch, args=(watchdog_interval_s,), daemon=True,
            name="magcache-serve-watchdog")
        self._watchdog.start()

    # ------------------------------------------------------------------ API
    def warmup(self, prompt: str = "warmup",
               timeout: Optional[float] = None) -> Dict[str, Any]:
        """Run one request before the first real one (kernel builds, caches).
        Under micro-batching it sends ``max_batch`` copies, which the
        executor's window gathers into the largest batch the server runs:
        its shape's first launches and the allocator's peak come first.
        ``timeout`` bounds each wait (None: until done)."""
        jobs = [self.submit({"prompt": prompt}) for _ in range(self.max_batch)]
        for job in jobs:
            job.done_event.wait(timeout)
        return jobs[0].record()

    def submit(self, request: Dict[str, Any]) -> Job:
        prompt = request.get("prompt")
        if not isinstance(prompt, str) or not prompt:
            raise ValueError("request must carry a non-empty string 'prompt'")
        allowed = _request_keys(self.pipeline) + _OVERRIDE_KEYS + _CONTROL_KEYS
        bad = [k for k in request if k not in allowed]
        if bad:
            raise ValueError(f"unknown request fields {bad}; allowed: "
                             f"{sorted(allowed)}")
        if any(k in request for k in _OVERRIDE_KEYS) \
                and not hasattr(self.pipeline, "skip_mask_for"):
            raise ValueError(
                "this pipeline does not support per-request cache overrides "
                f"({type(self.pipeline).__name__} has no skip_mask_for)")
        timeout_s = request.get("timeout_s", self.default_timeout_s)
        if timeout_s is not None and (not isinstance(timeout_s, (int, float))
                                      or timeout_s <= 0):
            raise ValueError(f"timeout_s must be a positive number, "
                             f"got {timeout_s!r}")
        if not self._worker.is_alive() or self._stop.is_set():
            raise QueueFullError("executor is not accepting jobs "
                                 "(shut down or dead)")
        job = Job(job_id=uuid.uuid4().hex[:12], request=dict(request))
        with self._jobs_lock:
            self._jobs[job.job_id] = job
        try:
            # fail fast instead of pinning an HTTP thread on a full queue
            self._queue.put_nowait(job)
        except queue.Full:
            with self._jobs_lock:
                self._jobs.pop(job.job_id, None)
            raise QueueFullError(
                f"request queue is full ({self._queue.maxsize} pending); "
                "retry later") from None
        return job

    def cancel(self, job_id: str) -> str:
        """Cancel a queued job. Returns the job's (new) status; a running
        job cannot be preempted and keeps its status."""
        with self._jobs_lock:
            job = self._jobs.get(job_id)
            if job is None:
                return "unknown"
            if job.status == "queued":
                job.status = "cancelled"
                job.error = "cancelled by client"
                job.finished_at = time.time()
                job.done_event.set()
                self._retire_locked(job)
            return job.status

    def get(self, job_id: str) -> Optional[Job]:
        with self._jobs_lock:
            return self._jobs.get(job_id)

    def stats(self) -> Dict[str, Any]:
        alive = self._worker.is_alive() and not self._stop.is_set()
        out = {
            "ok": alive,
            "backend": self.device.type,
            "pending": self._queue.qsize(),
            "served": self._served,
            "pipeline": type(self.pipeline).__name__,
        }
        if self.device.type == "cuda":
            out["device_name"] = torch.cuda.get_device_name(self.device)
        return out

    def info(self) -> Dict[str, Any]:
        cfg = getattr(self.pipeline, "config", None)
        out = {"pipeline": type(self.pipeline).__name__, "steps": self.steps,
               "overrides_supported": hasattr(self.pipeline, "skip_mask_for")}
        if cfg is not None:
            try:
                d = dataclasses.asdict(cfg)
            except TypeError:
                d = dict(vars(cfg))
            out["config"] = {k: v for k, v in d.items()
                             if isinstance(v, (int, float, str, bool, tuple,
                                               list, type(None)))}
        return out

    def shutdown(self, timeout: float = 30.0) -> None:
        """Stop the executor and fail (don't strand) still-queued jobs: every
        waiter's done_event fires with status=error."""
        self._stop.set()
        try:
            self._queue.put_nowait(None)
        except queue.Full:
            pass
        self._worker.join(timeout)
        self._drain("server shutting down")
        self._watchdog.join(1.0)

    # ------------------------------------------------------------- executor
    def _claim(self, job: Job, now: float) -> bool:
        """queued -> running (False if it was cancelled or failed first)."""
        with self._jobs_lock:
            if job.status != "queued":
                return False
            job.status = "running"
            job.started_at = now
            t = job.request.get("timeout_s", self.default_timeout_s)
            job.deadline = (now + float(t)) if t else None
            return True

    def _finish(self, job: Job, result=None, error=None) -> None:
        """running -> done/error; a no-op if the watchdog already timed the
        job out (its late result is discarded)."""
        with self._jobs_lock:
            if job.status != "running":
                return
            if error is None:
                job.result = result
                job.status = "done"
            else:
                job.status = "error"
                job.error = error
            job.finished_at = time.time()
            self._served += 1
            self._retire_locked(job)
        job.done_event.set()

    def _retire_locked(self, job: Job) -> None:
        """Bound finished-job memory (call with _jobs_lock held)."""
        self._done_order.append(job.job_id)
        while len(self._done_order) > self.job_history:
            self._jobs.pop(self._done_order.popleft(), None)

    def _fail_locked(self, job: Job, reason: str, status: str = "error") -> None:
        job.status = status
        job.error = reason
        job.finished_at = time.time()
        self._retire_locked(job)

    def _drain(self, reason: str) -> None:
        """Fail every still-queued job so no waiter hangs forever."""
        while True:
            try:
                job = self._queue.get_nowait()
            except queue.Empty:
                break
            if job is None:
                continue
            with self._jobs_lock:
                if job.status != "queued":
                    continue
                self._fail_locked(job, reason)
            job.done_event.set()

    def _run(self) -> None:
        if self._card is not None:
            torch.cuda.set_device(self._card)
        with torch.inference_mode():
            self._serve_loop()

    def _serve_loop(self) -> None:
        held: Optional[Job] = None       # non-batchable job deferred by a batch
        while not self._stop.is_set():
            if held is not None:
                job, held = held, None
            else:
                job = self._queue.get()
            if job is None:
                break
            if not self._claim(job, time.time()):
                continue                 # cancelled while queued
            batched = self.max_batch > 1 and self._batchable(job)
            batch = [job]
            if batched:
                deadline = time.time() + self.batch_window_s
                while len(batch) < self.max_batch:
                    try:
                        nxt = self._queue.get(
                            timeout=max(0.0, deadline - time.time()))
                    except queue.Empty:
                        break
                    if nxt is None:
                        self._stop.set()
                        break
                    if not self._batchable(nxt):
                        held = nxt       # run the batch first, this job next
                        break
                    if self._claim(nxt, time.time()):
                        batch.append(nxt)
            if len(batch) > 1:
                # one executor pass: the whole batch shares a dispatch stamp
                dispatch = time.time()
                with self._jobs_lock:
                    for j in batch:
                        if j.status == "running":
                            j.started_at = dispatch
                            t = j.request.get("timeout_s", self.default_timeout_s)
                            j.deadline = (dispatch + float(t)) if t else None
            try:
                # under micro-batching a batchable job takes generate_batch
                # even alone: its result record is that of a batch of 1
                if batched:
                    results = self._execute_batch([j.request for j in batch])
                else:
                    results = [self._execute(job.request)]
                for j, res in zip(batch, results):
                    self._finish(j, result=res)
            except Exception as exc:  # noqa: BLE001 - survive bad requests
                for j in batch:
                    logger.warning("job %s failed: %r", j.job_id, exc)
                    self._finish(j, error=repr(exc))
        if held is not None:         # deferred job stranded by shutdown
            with self._jobs_lock:
                if held.status == "queued":
                    self._fail_locked(held, "server shutting down")
            held.done_event.set()

    def _watch(self, interval: float) -> None:
        """Fail queued and in-flight jobs behind a dead executor; time out
        running jobs over their budget."""
        while not self._stop.is_set():
            time.sleep(interval)
            if not self._worker.is_alive() and not self._stop.is_set():
                logger.error("executor thread died; failing pending jobs")
                self._drain("executor thread died")
                stranded = []
                with self._jobs_lock:
                    for job in list(self._jobs.values()):
                        if job.status == "running":
                            self._fail_locked(job, "executor thread died mid-job")
                            stranded.append(job)
                for job in stranded:
                    job.done_event.set()
                continue
            now = time.time()
            expired = []
            with self._jobs_lock:
                for job in list(self._jobs.values()):
                    if job.status == "running" and job.deadline and now > job.deadline:
                        budget = job.request.get("timeout_s", self.default_timeout_s)
                        self._fail_locked(job, f"job exceeded its {budget}s run budget "
                                               "(a running job cannot be preempted; "
                                               "its result is discarded)", "timeout")
                        expired.append(job)
            for job in expired:
                logger.warning("job %s timed out", job.job_id)
                job.done_event.set()
        self._drain("server shutting down")

    def _batchable(self, job: Job) -> bool:
        """A request joins a micro-batch when it carries only what
        ``generate_batch`` takes per element (prompt, seed). With
        ``save_dir`` nothing batches: ``generate_batch`` returns latents
        only, and a job's ``media_path`` must not depend on who else
        arrived."""
        if self.save_dir:
            return False
        r = job.request
        return ("negative_prompt" not in r
                and not r.get("return_latents")
                and not any(k in r for k in _OVERRIDE_KEYS))

    def _execute_batch(self, requests) -> list:
        prompts = [r["prompt"] for r in requests]
        seeds = [int(r.get("seed", 0)) for r in requests]
        out = self.pipeline.generate_batch(prompts, seeds=seeds)
        shape = [1] + list(out.latents.shape[1:])
        timings = _timings(out.timings)
        results = []
        for _ in prompts:
            res: Dict[str, Any] = {"latents_shape": shape, "batched": len(prompts)}
            if timings:
                res["timings"] = timings
            results.append(res)
        return results

    def _execute(self, request: Dict[str, Any]) -> Dict[str, Any]:
        kwargs = {k: request[k] for k in _request_keys(self.pipeline) if k in request}
        overrides = {k: request[k] for k in _OVERRIDE_KEYS if k in request}
        if overrides:
            kwargs["skip_override"] = self.pipeline.skip_mask_for(
                thresh=overrides.get("magcache_thresh"),
                K=overrides.get("magcache_K"),
                retention_ratio=overrides.get("retention_ratio"),
                use_magcache=bool(overrides.get("use_magcache", True)))
        out = self.pipeline.generate(request["prompt"], **kwargs)
        lat = _host(out.latents)
        res: Dict[str, Any] = {"latents_shape": list(lat.shape)}
        if out.skips is not None:
            sk = np.asarray(out.skips)
            res["skipped_forwards"] = int(sk.sum())
            res["total_forwards"] = int(sk.size)
        if out.timings:
            res["timings"] = _timings(out.timings)
        video = getattr(out, "video", None)
        image = getattr(out, "image", None)
        if (video is not None or image is not None) and self.save_dir:
            from magcache_tpu_torch.utils.misc import save_image, save_video

            os.makedirs(self.save_dir, exist_ok=True)
            name = os.path.join(self.save_dir, uuid.uuid4().hex[:12])
            if video is not None:
                frames = _host(video)
                res["media_path"] = save_video(frames[0] if frames.ndim == 5 else frames,
                                               name + ".mp4", fps=self.fps)
            else:
                img = _host(image)
                res["media_path"] = save_image(img[0] if img.ndim == 4 else img,
                                               name + ".png")
        if request.get("return_latents"):
            buf = io.BytesIO()
            np.save(buf, lat)
            raw = buf.getvalue()
            if len(raw) > _MAX_LATENT_B64:
                res["latents_note"] = (f"latents ({len(raw)} bytes) exceed "
                                       f"the {_MAX_LATENT_B64}-byte transport "
                                       "cap; fetch via media_path instead")
            else:
                res["latents_b64"] = base64.b64encode(raw).decode("ascii")
        return res


# ------------------------------------------------------------------- HTTP
def make_http_server(server: PipelineServer, host: str = "127.0.0.1",
                     port: int = 0) -> ThreadingHTTPServer:
    """Bind a ThreadingHTTPServer over ``server``. ``port=0`` picks a free
    port (read it back from ``httpd.server_address``). Call
    ``httpd.serve_forever()`` (blocking) or drive it from a thread."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route to our logger, not stderr
            logger.debug("http: " + fmt, *args)

        def _send(self, code: int, payload: Dict[str, Any]) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_job(self, job: Job) -> None:
            """Deliver a finished job; its latent payload is released from
            the kept record after this first delivery."""
            self._send(200 if job.status == "done" else 500,
                       job.record(include_latents=True))
            if job.result is not None:
                job.result.pop("latents_b64", None)

        def do_GET(self):  # noqa: N802 - http.server API
            if self.path == "/healthz":
                stats = server.stats()
                self._send(200 if stats["ok"] else 503, stats)
            elif self.path == "/info":
                self._send(200, server.info())
            elif self.path.startswith("/jobs/"):
                job = server.get(self.path[len("/jobs/"):])
                if job is None:
                    self._send(404, {"error": "unknown job (or evicted from "
                                              "the bounded history)"})
                elif job.status == "done":
                    self._send_job(job)
                else:
                    self._send(200, job.record())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path.startswith("/jobs/") and self.path.endswith("/cancel"):
                job_id = self.path[len("/jobs/"):-len("/cancel")]
                status = server.cancel(job_id)
                if status == "unknown":
                    self._send(404, {"error": "unknown job"})
                elif status == "cancelled":
                    self._send(200, {"job_id": job_id, "status": status})
                else:
                    self._send(409, {"job_id": job_id, "status": status,
                                     "error": "job is no longer queued; a "
                                              "running job cannot be preempted"})
                return
            if self.path != "/generate":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                request = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(request, dict):
                    raise ValueError("request body must be a JSON object")
                job = server.submit(request)
            except QueueFullError as exc:
                self._send(503, {"error": str(exc), "retry": True})
                return
            except (ValueError, TypeError) as exc:   # JSONDecodeError included
                self._send(400, {"error": str(exc)})
                return
            if request.get("async"):
                self._send(202, {"job_id": job.job_id, "status": job.status})
                return
            if not job.done_event.wait(server.sync_wait_s):
                # don't pin this HTTP thread forever; the job keeps running
                self._send(504, {"job_id": job.job_id, "status": job.status,
                                 "error": f"no result within {server.sync_wait_s}s; "
                                          f"poll /jobs/{job.job_id}"})
                return
            self._send_job(job)

    return ThreadingHTTPServer((host, port), Handler)
