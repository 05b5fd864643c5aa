"""Continuous-batching serving: the counterpart of
llama_pipeline_parallel_tpu/serve/ (docs/SERVING.md), minus the gateway.

The decode stack generalized from one-shot batches to a long-lived
service: the slot-managed dense KV cache (slots.py) or the paged KV cache
(pages.py: fixed-size pages + slot->page table, optional int8 pages and
prefix caching), the admission scheduler with continuous batching and
chunked prefill (engine.py), SLO telemetry (telemetry.py), per-request
tracing (reqtrace.py) and a stdlib HTTP front-end (frontend.py).
`tools/serve.py` wraps it into a process; `tools/serving_report.py` and
`tools/request_report.py` summarize its files offline;
`tools/serve_traffic.py` drives synthetic traffic against it.
"""

from llama_pipeline_parallel_tpu_torch.serve.engine import (
    EngineShutdown,
    RequestHandle,
    RequestRejected,
    ServeConfig,
    ServeEngine,
    ServeLoop,
    ServeOverloaded,
    ServePagesExhausted,
    ServeRequest,
)
from llama_pipeline_parallel_tpu_torch.serve.pages import PagedKVCache
from llama_pipeline_parallel_tpu_torch.serve.reqtrace import (
    RequestTraceRecorder,
    TraceContext,
)
from llama_pipeline_parallel_tpu_torch.serve.slots import SlotKVCache
from llama_pipeline_parallel_tpu_torch.serve.telemetry import SLOStats

__all__ = [
    "EngineShutdown", "PagedKVCache", "RequestHandle", "RequestRejected",
    "RequestTraceRecorder", "ServeConfig", "ServeEngine", "ServeLoop",
    "ServeOverloaded", "ServePagesExhausted", "ServeRequest", "SlotKVCache",
    "SLOStats", "TraceContext",
]
