"""Request front-end: a stdlib JSON-lines HTTP endpoint over the engine.

The counterpart of llama_pipeline_parallel_tpu/serve/frontend.py, copied
over the port's engine. Deliberately dependency-free (http.server): the
serving story must run on a bare machine image. The in-process path
(`ServeEngine.submit` + `RequestHandle`) is the primary API and what tests
use; this module only maps it onto sockets:

  POST /v1/generate   {"input_ids": [...], "max_new_tokens": 16,
                       "temperature": 0.8, "top_k": 40, "top_p": 0.95,
                       "eos_token_id": 2, "seed": 7, "stream": true,
                       "tenant": "paid"}
    stream=false -> one JSON body {"request_id", "trace_id", "tokens"}.
    stream=true  -> one JSON line per token {"token": id} as it is
                    generated — the FIRST line also carries "request_id"
                    and "trace_id" — then a final {"done": true,
                    "request_id", "trace_id", "tokens"} line (connection
                    close delimits the stream — HTTP/1.0 framing,
                    curl/urllib read it naturally).
  GET /healthz        engine SLO/occupancy snapshot (the same dict the
                      serving metrics line carries).

Tracing contract (docs/SERVING.md "Request tracing"): an incoming W3C
`traceparent` header joins the request to the caller's trace (malformed
headers mint a fresh trace, never a 400); every response that decoded a
request — 200, 429, 400, 503 — carries `X-Request-Id`, `X-Trace-Id`, and
a `traceparent` response header. A client disconnect mid-stream bumps
`requests_abandoned`, stamps the request trace, and cancels the request
at the engine's next step boundary — its slot and unshared pages are
freed, shared prefix pages drop a refcount.

Backpressure maps to status codes: ServeOverloaded -> 429 with a
Retry-After header (wait queue full, or — its ServePagesExhausted
subclass — the paged cache's free-page pool cannot cover the request's
worst-case demand), RequestRejected -> 400 (shape can never be served),
EngineShutdown -> 503 with the same drain-time-derived Retry-After —
clients and the gateway tier back off honestly instead of hot-retrying
a draining replica.
The engine loop runs elsewhere (tools/serve.py main thread or ServeLoop);
handler threads only block on their request's handle.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from llama_pipeline_parallel_tpu_torch.models.llama.decode import GenerationConfig
from llama_pipeline_parallel_tpu_torch.serve.engine import (
    EngineShutdown,
    RequestRejected,
    ServeEngine,
    ServeOverloaded,
    ServeRequest,
)
from llama_pipeline_parallel_tpu_torch.serve.reqtrace import TraceContext
from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

GEN_KEYS = ("max_new_tokens", "temperature", "top_k", "top_p",
            "eos_token_id", "pad_token_id")


def request_from_json(body: dict,
                      traceparent: str | None = None) -> ServeRequest:
    """Decode one API request body; ValueError on malformed input.
    `traceparent` (the W3C header, when the caller sent one) joins this
    request to the caller's distributed trace; a malformed header mints a
    fresh trace instead of rejecting — tracing must never shed work."""
    if not isinstance(body, dict):
        raise ValueError("request body must be a JSON object")
    ids = body.get("input_ids")
    if (not isinstance(ids, list) or not ids
            or not all(isinstance(i, int) for i in ids)):
        raise ValueError("input_ids must be a non-empty list of ints")
    tenant = body.get("tenant")
    if tenant is not None and not isinstance(tenant, str):
        raise ValueError("tenant must be a string when present")
    gen_kw = {k: body[k] for k in GEN_KEYS if body.get(k) is not None}
    kwargs: dict = {}
    # gateway pass-throughs (serve/gateway.py): the routing tier supplies
    # its journalled id as an idempotency key — a replayed request lands
    # on a fresh replica under the SAME id, so the WAL, the replica trace
    # and the healthz counters all name one request — plus the dispatch
    # attribution the trace record carries
    rid = body.get("request_id")
    if rid is not None:
        if not isinstance(rid, str) or not rid:
            raise ValueError("request_id must be a non-empty string "
                             "when present")
        kwargs["request_id"] = rid
    gateway = body.get("gateway")
    if gateway is not None:
        if not isinstance(gateway, dict):
            raise ValueError("gateway must be an object when present")
        kwargs["gateway"] = {
            "attempt": int(gateway.get("attempt", 1)),
            "replay": bool(gateway.get("replay")),
            "hedge": bool(gateway.get("hedge")),
        }
    return ServeRequest(input_ids=ids, gen=GenerationConfig(**gen_kw),
                        seed=int(body.get("seed", 0)), tenant=tenant or None,
                        trace=TraceContext.from_traceparent(traceparent),
                        **kwargs)


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.0: the streaming response is delimited by connection close,
    # no chunked-encoding framing to hand-roll
    protocol_version = "HTTP/1.0"
    server_version = "lpt-serve/1"

    @property
    def engine(self) -> ServeEngine:
        return self.server.engine  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # stdlib default spams stderr
        logger.debug("http %s", fmt % args)

    def _send_json(self, code: int, payload: dict,
                   headers: dict | None = None) -> None:
        body = (json.dumps(payload) + "\n").encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            return self._send_json(200, self.engine.metrics_snapshot())
        return self._send_json(404, {"error": f"no route {self.path}"})

    @staticmethod
    def _trace_headers(request: ServeRequest,
                       extra: dict | None = None) -> dict:
        """Correlation headers on EVERY response for a decoded request —
        success, 429, 400, and 503 alike: a shed client must still be able
        to name the trace it was shed under."""
        headers = {"X-Request-Id": request.request_id}
        if request.trace is not None:
            headers["X-Trace-Id"] = request.trace.trace_id
            headers["traceparent"] = request.trace.traceparent()
        if extra:
            headers.update(extra)
        return headers

    def do_POST(self):
        if self.path != "/v1/generate":
            return self._send_json(404, {"error": f"no route {self.path}"})
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            request = request_from_json(body,
                                        self.headers.get("traceparent"))
        except (ValueError, TypeError) as e:
            return self._send_json(400, {"error": str(e)})
        trace_id = request.trace.trace_id if request.trace else None
        try:
            handle = self.engine.submit(request)
        except ServeOverloaded as e:
            # 429 + Retry-After: queue overload AND page-pool exhaustion
            # (ServePagesExhausted) both tell the client to back off and
            # come back — the hint is coarse, not a promise
            retry = max(1, int(-(-getattr(e, "retry_after_s", 1.0) // 1)))
            return self._send_json(
                429, {"error": str(e), "request_id": request.request_id,
                      "trace_id": trace_id},
                headers=self._trace_headers(request,
                                            {"Retry-After": str(retry)}))
        except RequestRejected as e:
            return self._send_json(
                400, {"error": str(e), "request_id": request.request_id,
                      "trace_id": trace_id},
                headers=self._trace_headers(request))
        except EngineShutdown as e:  # process exiting: go to another replica
            # 503 + Retry-After, drain-time derived like the degraded 429:
            # "come back after the relaunch", not "hot-retry a dying pod"
            retry = max(1, int(-(-getattr(e, "retry_after_s", 1.0) // 1)))
            return self._send_json(
                503, {"error": str(e), "request_id": request.request_id,
                      "trace_id": trace_id},
                headers=self._trace_headers(request,
                                            {"Retry-After": str(retry)}))

        if not body.get("stream"):
            try:
                tokens = handle.result()
            except Exception as e:
                return self._send_json(
                    500, {"error": repr(e),
                          "request_id": request.request_id,
                          "trace_id": trace_id},
                    headers=self._trace_headers(request))
            return self._send_json(
                200, {"request_id": request.request_id,
                      "trace_id": trace_id, "tokens": tokens},
                headers=self._trace_headers(request))

        self.send_response(200)
        self.send_header("Content-Type", "application/jsonlines")
        for name, value in self._trace_headers(request).items():
            self.send_header(name, value)
        self.end_headers()
        try:
            first = True
            for token in handle.tokens():
                # the FIRST line carries the correlation ids, so a client
                # can join a waterfall without waiting for the tail line
                line = ({"token": token, "request_id": request.request_id,
                         "trace_id": trace_id} if first
                        else {"token": token})
                first = False
                self.wfile.write((json.dumps(line) + "\n").encode())
                self.wfile.flush()
            tail = {"done": True, "request_id": request.request_id,
                    "trace_id": trace_id, "tokens": handle.tokens_out}
        except OSError:
            # client hung up mid-stream: count the abandonment and tell the
            # engine — it cancels the request at the next step boundary,
            # freeing the slot and its pages for paying traffic
            logger.debug("client disconnected during stream of %s",
                         request.request_id)
            self.engine.note_abandoned(request)
            return
        except Exception as e:
            tail = {"done": True, "request_id": request.request_id,
                    "trace_id": trace_id, "error": repr(e)}
        try:
            self.wfile.write((json.dumps(tail) + "\n").encode())
        except OSError:
            # disconnect raced the final write: same abandonment, observed
            # one line later — don't let socketserver traceback on it
            logger.debug("client disconnected during stream tail of %s",
                         request.request_id)
            self.engine.note_abandoned(request)


def make_server(engine: ServeEngine, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Bound (not yet serving) HTTP server; port 0 picks an ephemeral port
    — read the bound one off `server.server_address`."""
    server = ThreadingHTTPServer((host, port), _Handler)
    server.engine = engine  # type: ignore[attr-defined]
    server.daemon_threads = True
    return server
