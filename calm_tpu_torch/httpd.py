"""Minimal HTTP front end over the continuous-batching Server (the port of
``calm_tpu.httpd``; stdlib ``http.server``, no dependencies).

    python -m calm_tpu_torch.httpd model.calm --port 8000 --batch 8 [--page-rows 64]
    python -m calm_tpu_torch.httpd model.calm --batch 8 --page-rows 64 --dp 2
    CALM_CPU=1 python -m calm_tpu_torch.httpd model.calm --port 0   # on the CPU

Endpoints:
  GET  /v1/health    -> {"status": "ok", "model": ...}
  GET  /v1/stats     -> scheduler, prefix-cache, page-pool and ops.cost counters
  POST /v1/generate  -> {"prompt", "max_tokens"?, "temperature"?, "min_p"?,
                         "seed"?, "timeout_s"?, "stream"?}
     stream=false (default): one JSON body when done (504 past the deadline)
     stream=true: chunked text/plain pieces as they decode
  400 bad body, 404 unknown path, 413 body over 16 MiB, 429 queue full,
  503 while draining.

One scheduler thread owns the card: it makes every CUDA call (the kernel
wrappers launch on the calling thread's current stream). Handler threads
only enqueue requests and wait on per-request queues. SIGTERM drains:
new requests get 503, the live batch finishes, then the process exits.
``--draft d.calm`` serves speculatively (``--gamma`` tokens drafted a
round at most; ``--spec-sampled`` rejection-samples sampled requests
inside rounds), and ``/v1/stats`` then carries a ``speculative`` block of
rounds, emitted and acceptance, as ``calm_tpu.httpd``'s. ``--dp N`` with
``--page-rows`` spreads the slots over the first N devices, one paged
decoder each (``serve.PagedGroup``; the GPUs in order, or N times the CPU
under ``CALM_CPU=1``), and ``/v1/stats`` adds up the decoders' prefix
caches (``calm_tpu/httpd.py:129-140``, ``:273-301``). Its ``counters``
block is the process's ``ops.cost`` counters, into which every decoder of
a group counts: requests submitted and admitted, their summed queue wait
(``serve.queue_wait_s``), prompt and prefix-hit tokens, ticks and
slot-ticks (occupancy), graph captures, capture seconds and replays.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import signal
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from calm_tpu_torch.ops import cost
from calm_tpu_torch.serve import QueueFull, Server


class _Scheduler(threading.Thread):
    """Owns the device: ticks the Server whenever work is pending."""

    def __init__(self, server: Server, default_timeout_s: float = 0.0,
                 access_log=None):
        super().__init__(daemon=True)
        self.server = server
        self.default_timeout_s = default_timeout_s
        self.access_log = access_log  # callable(dict) per finished request
        self.lock = threading.Lock()  # guards submit/cancel against tick
        self.wake = threading.Event()
        self.running = True
        self.draining = False  # graceful shutdown: reject new, finish live

    def submit(self, prompt: str, **kw):
        if self.draining:
            raise RuntimeError("draining")
        with self.lock:
            req = self.server.submit(prompt, **kw)  # may raise QueueFull
        if self.access_log is not None:
            req.on_piece = _log_chain(req, self.access_log, req.on_piece)
        self.wake.set()
        return req

    def cancel(self, req):
        with self.lock:
            self.server.cancel(req)

    def run(self):
        while self.running:
            with self.lock:
                busy = (self.server.pending
                        or any(s.active for s in self.server.slots))
                if busy:
                    self.server.tick()
            if not busy:
                if self.draining:
                    break
                self.wake.wait(timeout=0.05)
                self.wake.clear()
        self.running = False

    def stop(self):
        self.running = False
        self.wake.set()

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Stop admitting (handlers answer 503), let the live batch finish,
        then stop the tick loop. True if it drained within the timeout."""
        self.draining = True
        self.wake.set()
        self.join(timeout=timeout_s)
        done = not self.is_alive()
        self.stop()
        return done


def _log_chain(req, log, inner):
    """Wrap a request's on_piece so that its terminal sentinel emits one
    access-log record (rid, tokens, ttft/total ms, terminal state)."""
    def hook(piece):
        if inner is not None:
            inner(piece)
        if piece is None:
            ttft = ((req.first_token_at - req.submitted_at) * 1e3
                    if req.first_token_at else None)
            log({"rid": req.rid, "tokens": req.n_generated,
                 "ttft_ms": None if ttft is None else round(ttft, 1),
                 "total_ms": round((req.finished_at - req.submitted_at) * 1e3, 1),
                 "cached_prefix": req.cached_prefix,
                 "state": ("cancelled" if req.cancelled else
                           "timeout" if req.timed_out else
                           "out_of_pages" if req.out_of_pages else "ok")})
    return hook


def make_handler(sched: _Scheduler):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, obj, headers=()):
            body = json.dumps(obj).encode()
            self.send_response(code)
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            srv = sched.server
            if self.path == "/v1/health":
                self._json(200, {"status": "ok", "model": srv.engine.banner()})
            elif self.path == "/v1/stats":
                # a group of decoders keeps one prefix cache each: their
                # sums, in the single cache's keys
                pcs = ([srv.prefix_cache] if srv.prefix_cache is not None
                       else list(srv._prefix_caches or ()))
                self._json(200, {
                    "slots": srv.batch,
                    "active": sum(s.active for s in srv.slots),
                    "pending": len(srv.pending),
                    "rejected": srv.rejected,
                    "prefix_cache": (None if not pcs else
                                     {"entries": sum(len(p._entries) for p in pcs),
                                      "tokens": sum(p.tokens for p in pcs),
                                      "hits": sum(p.hits for p in pcs),
                                      "hit_tokens": sum(p.hit_tokens for p in pcs)}),
                    "pages_in_use": (None if srv._paged is None
                                     else srv._paged.pages_in_use()),
                    "speculative": (None if srv._draft is None else {
                        "rounds": srv.spec_rounds,
                        "emitted": srv.spec_emitted,
                        "acceptance": srv.spec_accepted / max(srv.spec_emitted, 1),
                    }),
                    "counters": cost.counters(),
                })
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/v1/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                if n > 16 << 20:
                    self._json(413, {"error": "body too large"})
                    return
                body = json.loads(self.rfile.read(n) or b"{}")
                prompt = body["prompt"]
                if not isinstance(prompt, str):
                    raise ValueError("prompt must be a string")
                kw = dict(max_tokens=int(body.get("max_tokens", 128)),
                          temperature=float(body.get("temperature", 1.0)),
                          minp=float(body.get("min_p", 0.1)),
                          seed=int(body.get("seed", 42)),
                          timeout_s=float(body.get("timeout_s",
                                                   sched.default_timeout_s)))
            except (ValueError, KeyError, TypeError, AttributeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return

            pieces: queue.Queue = queue.Queue()
            try:
                req = sched.submit(prompt, on_piece=pieces.put, **kw)
            except QueueFull:
                self._json(429, {"error": "queue full"}, [("Retry-After", "1")])
                return
            except RuntimeError:
                self._json(503, {"error": "server draining"})
                return

            if body.get("stream"):
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; charset=utf-8")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(data: bytes):
                    self.wfile.write(f"{len(data):x}\r\n".encode())
                    self.wfile.write(data + b"\r\n")

                try:
                    while True:
                        # the server pushes a None sentinel on every
                        # terminal path (done, timeout, cancel)
                        piece = pieces.get()
                        if piece is None:
                            break
                        if piece:
                            chunk(piece.encode())
                    chunk(b"")  # terminator
                except (BrokenPipeError, ConnectionError, OSError):
                    sched.cancel(req)  # the client went away: free the slot
                return

            req.done_event.wait()
            if req.timed_out:
                self._json(504, {"error": "deadline exceeded",
                                 "partial_text": req.text,
                                 "tokens": req.n_generated})
                return
            self._json(200, {
                "text": req.text,
                "tokens": req.n_generated,
                "cached_prefix": req.cached_prefix,
                "ttft_ms": round(1e3 * (req.first_token_at - req.submitted_at), 2),
                "total_ms": round(1e3 * (req.finished_at - req.submitted_at), 2),
            })

    return Handler


def serve_http(server: Server, host: str = "127.0.0.1", port: int = 8000,
               default_timeout_s: float = 0.0, access_log=None):
    """Start the scheduler thread and return the (not yet serving) HTTP
    server, its scheduler as ``.scheduler``; call ``serve_forever()`` on
    it (the tests run it on port 0 in a thread)."""
    sched = _Scheduler(server, default_timeout_s, access_log=access_log)
    sched.start()
    httpd = ThreadingHTTPServer((host, port), make_handler(sched))
    httpd.scheduler = sched
    return httpd


def main(argv=None):
    ap = argparse.ArgumentParser(prog="calm_tpu_torch.httpd")
    ap.add_argument("checkpoint")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("-c", dest="context", type=int, default=0)
    ap.add_argument("--kv", default=None, choices=["bf16", "fp16", "fp8"])
    ap.add_argument("--prefix-cache-tokens", type=int, default=0)
    ap.add_argument("--device-sampling", action="store_true")
    ap.add_argument("--page-rows", type=int, default=0,
                    help="paged KV: rows per page (0 = dense cache)")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="paged KV: pool size (default batch*seq_len/rows)")
    ap.add_argument("--max-pending", type=int, default=256,
                    help="pending-queue bound (submit beyond it -> 429)")
    ap.add_argument("--timeout-s", type=float, default=0.0,
                    help="default per-request deadline (0 = none)")
    ap.add_argument("--drain-s", type=float, default=60.0,
                    help="graceful-shutdown drain window (SIGTERM)")
    ap.add_argument("--access-log", action="store_true",
                    help="JSONL per-request record on stderr at completion")
    ap.add_argument("--draft", default=None,
                    help="draft checkpoint for speculative serving (greedy-exact; "
                    "engages while every active request is greedy)")
    ap.add_argument("--gamma", type=int, default=4,
                    help="speculative draft length per round")
    ap.add_argument("--spec-sampled", action="store_true",
                    help="rejection-sample sampled requests inside speculative "
                    "rounds (distributionally exact)")
    ap.add_argument("--dp", type=int, default=0,
                    help="paged mode: spread the slots over this many devices "
                    "(one independent pool and decoder each; needs --page-rows, "
                    "batch %% dp == 0)")
    args = ap.parse_args(argv)

    cpu = os.environ.get("CALM_CPU", "0") == "1"
    device = "cpu" if cpu else "cuda"
    dp_devices = None
    if args.dp:
        if not args.page_rows:
            ap.error("--dp needs --page-rows (paged serving)")
        # the first dp devices, as jax.devices()[:dp]
        dp_devices = (["cpu"] * args.dp if cpu else
                      [f"cuda:{i}" for i in range(min(args.dp, torch.cuda.device_count()))])
        device = dp_devices[0] if dp_devices else device
    server = Server(args.checkpoint, batch=args.batch, context=args.context,
                    kv_dtype=args.kv, device_sampling=args.device_sampling,
                    prefix_cache_tokens=args.prefix_cache_tokens,
                    page_rows=args.page_rows, pool_pages=args.pool_pages,
                    max_pending=args.max_pending, dp_devices=dp_devices,
                    draft_path=args.draft, gamma=args.gamma,
                    spec_sampled=args.spec_sampled, device=device)
    print(server.engine.banner(), flush=True)
    log = None
    if args.access_log:
        def log(rec):
            print(json.dumps(rec), file=sys.stderr, flush=True)

    httpd = serve_http(server, args.host, args.port,
                       default_timeout_s=args.timeout_s, access_log=log)
    print(f"# serving on http://{args.host}:{httpd.server_address[1]} "
          f"({args.batch} slots)", flush=True)

    def _drain():
        httpd.scheduler.drain(timeout_s=args.drain_s)
        httpd.shutdown()  # returns once serve_forever has left its loop

    def _term(signum, frame):
        # drain on another thread: shutdown() waits for serve_forever,
        # which runs on this one
        print("# draining...", file=sys.stderr, flush=True)
        threading.Thread(target=_drain, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        httpd.scheduler.drain(timeout_s=args.drain_s)
    httpd.server_close()
    print("# drained", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
