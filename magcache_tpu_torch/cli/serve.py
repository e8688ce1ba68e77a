"""``python -m magcache_tpu_torch.cli.serve``: serve one pipeline over HTTP.

Builds the pipeline ``cli.generate`` builds for the same flags (task, size,
steps, cache configuration), optionally runs one warmup generation, then
answers ``POST /generate`` until interrupted (SIGINT exits 0). The endpoint
contract: ``magcache_tpu_torch/serve/server.py``.

    python -m magcache_tpu_torch.cli.serve --task t2v-1.3B --tiny --device cpu \\
        --use_magcache --port 0                  # the CPU, toy widths
    python -m magcache_tpu_torch.cli.serve --task t2v-1.3B --frame_num 17 \\
        --sample_steps 20 --use_magcache --port 8900  # on the card, full width
"""

from __future__ import annotations

import sys


def build_serve_parser():
    from magcache_tpu_torch.cli.generate import build_parser

    p = build_parser()
    p.description = "Serve one magcache_tpu_torch pipeline over HTTP."
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8900, help="0 picks a free port")
    p.add_argument("--save_dir", default=None,
                   help="write decoded media here and return media_path; "
                        "omit to return latent metadata only")
    p.add_argument("--warmup", action="store_true",
                   help="run one generation before accepting requests")
    p.add_argument("--max_queue", type=int, default=64,
                   help="backpressure bound on queued generations")
    p.add_argument("--max_batch", type=int, default=1,
                   help="micro-batch concurrent requests into one "
                        "generate_batch (Wan t2v)")
    p.add_argument("--batch_window_ms", type=float, default=50.0,
                   help="how long the executor holds a request collecting a "
                        "micro-batch")
    p.add_argument("--job_history", type=int, default=256,
                   help="finished job records kept for GET /jobs/<id>")
    p.add_argument("--job_timeout_s", type=float, default=None,
                   help="default per-job run-time budget (requests may set "
                        "their own 'timeout_s')")
    p.add_argument("--sync_wait_s", type=float, default=3600.0,
                   help="how long a synchronous POST /generate blocks before "
                        "answering 504 with the job id")
    return p


def main(argv=None):
    args = build_serve_parser().parse_args(argv)

    from magcache_tpu_torch.cli.generate import _pipeline
    from magcache_tpu_torch.serve import PipelineServer, make_http_server
    from magcache_tpu_torch.utils.misc import task_fps

    pipe, steps, _lanes = _pipeline(args)
    server = PipelineServer(pipe, steps=steps, save_dir=args.save_dir,
                            fps=task_fps(args.task), max_queue=args.max_queue,
                            max_batch=args.max_batch,
                            batch_window_s=args.batch_window_ms / 1000.0,
                            job_history=args.job_history,
                            default_timeout_s=args.job_timeout_s,
                            sync_wait_s=args.sync_wait_s)
    if args.warmup:
        print("warmup: generating...", flush=True)
        rec = server.warmup(args.prompt or "warmup")
        print(f"warmup: {rec['status']} in {rec['wall_s']}s", flush=True)
    httpd = make_http_server(server, args.host, args.port)
    host, port = httpd.server_address[:2]
    print(f"serving {type(pipe).__name__} ({args.task}) on "
          f"http://{host}:{port}  (POST /generate)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
