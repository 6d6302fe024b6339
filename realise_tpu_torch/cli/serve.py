"""HTTP serving daemon of the port: ``realise_tpu.cli.serve`` over
:class:`realise_tpu_torch.serving.Corrector` (checkpoint, precomputed-table
fast path, fused block kernels on CUDA).

A stdlib ThreadingHTTPServer. Request threads featurize and build JSON
concurrently; device steps run on a dedicated worker that merges concurrent
requests sharing a length bucket into ONE step (``serving._CrossRequestBatcher``,
no wait timer: an unloaded request still rides alone). ``--no_cross_batching``
serves one serialized device step per request instead. The socket is bound
before the warmup, which builds the kernels and primes the allocator for
every (batch, length) bucket (``--warmup all``).

Endpoints:
    GET  /healthz           → {"status": "ok", "model_type": ...}
    POST /correct           body {"sentences": ["...", ...]}
                            → {"results": [{"input", "corrected", "edits"}]}

Example:
    python -m realise_tpu_torch.cli.serve --ckpt_dir ckpts --synthetic \
        --native_featurizer --port 8000
    curl -s localhost:8000/correct -d '{"sentences": ["我爱北经。"]}'
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from realise_tpu_torch.cli.common import logger, setup_logging


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt_dir", required=True)
    p.add_argument("--vocab_path", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--no_fast_path", action="store_true")
    p.add_argument("--no_cross_batching", action="store_true",
                   help="disable the cross-request device batcher "
                        "(concurrent requests then serialize one device "
                        "step each behind the device lock)")
    p.add_argument("--warmup", choices=("all", "quick", "none"),
                   default="all",
                   help="'all' runs every (batch, length) bucket once before "
                        "serving (kernel build, allocator); 'quick' one "
                        "small request; 'none' skips")
    p.add_argument("--native_featurizer", action="store_true",
                   help="tokenize with the C++ featurizer "
                        "(realise_tpu_torch/csrc/featurizer.cpp)")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic vocabulary (smoke runs)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run on the CPU)")
    p.add_argument("--no_kernels", action="store_true",
                   help="plain PyTorch sub-blocks instead of the fused kernels")
    return p


def make_handler(corrector):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj) -> None:
            body = json.dumps(obj, ensure_ascii=False).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # route through our logger
            logger.debug("http: " + fmt, *args)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok",
                                 "model_type": corrector.cfg.model_type})
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/correct":
                self._send(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
            except ValueError:  # a bad length, bad JSON or bad UTF-8
                self._send(400, {"error": "malformed request"})
                return
            sentences = (payload.get("sentences")
                         if isinstance(payload, dict) else None)
            if (not isinstance(sentences, list)
                    or not all(isinstance(s, str) for s in sentences)):
                self._send(400, {"error": "body must be "
                                          '{"sentences": ["...", ...]}'})
                return
            try:
                results = corrector.correct_with_edits(sentences)
            except Exception as e:  # the server keeps serving; log and report
                logger.exception("request failed")
                self._send(500, {"error": str(e)})
                return
            self._send(200, {"results": results})

    return Handler


def serve(corrector, host: str, port: int) -> ThreadingHTTPServer:
    """Build (but don't start) the server; port 0 binds a free port, which
    ``server.server_address`` then names."""
    return ThreadingHTTPServer((host, port), make_handler(corrector))


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup_logging()

    from realise_tpu_torch.serving import Corrector

    corrector = Corrector(
        args.ckpt_dir, vocab_path=args.vocab_path,
        batch_size=args.batch_size,
        use_kernels=False if args.no_kernels else None,
        fast_path=not args.no_fast_path, synthetic_vocab=args.synthetic,
        device=args.device, native_featurizer=args.native_featurizer,
        cross_request_batching=not args.no_cross_batching)
    # Bind before the warmup: a port conflict fails fast, and health checks
    # see the socket while the buckets warm.
    server = serve(corrector, args.host, args.port)
    try:
        if args.warmup != "none":
            logger.info("warming up (%s buckets)...", args.warmup)
            corrector.warmup(all_buckets=args.warmup == "all")
        host, port = server.server_address[:2]
        logger.info("serving %s on http://%s:%d (POST /correct, GET /healthz)",
                    corrector.cfg.model_type, host, port)
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        corrector.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
