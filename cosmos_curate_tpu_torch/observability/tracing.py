"""Spans, their backends, and W3C trace-context propagation (port of
``cosmos_curate_tpu/observability/tracing.py``).

Spans are recorded to one NDJSON file per process and, when an OTLP
endpoint is configured (``OTEL_EXPORTER_OTLP_ENDPOINT`` /
``CURATE_OTLP_ENDPOINT``), exported to a collector over OTLP/HTTP JSON,
encoded against the public OTLP schema (no opentelemetry SDK). Disabled
costs one boolean per call: every entry point short-circuits on it and
hands out the shared no-op span.

Propagation uses the W3C trace-context header
(``00-<32 hex trace_id>-<16 hex span_id>-01``):

- ``format_traceparent()`` / ``parse_traceparent()``: the header itself;
- ``traced_span(..., traceparent=...)``: an incoming context as the span's
  parent;
- ``attach_traceparent()``: the process-level base parent, which spans
  opened with no enclosing span parent onto (``run_split`` roots every
  span of a run on its ``run.split`` span this way);
- the active-span stack lives in a ``contextvars.ContextVar`` of immutable
  tuples, so ``contextvars.copy_context()`` carries it into the pipelined
  runner's worker threads, which ``threading.local`` cannot.

Host code only: nothing here touches the device.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import queue
import re
import tempfile
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Iterator

from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_enabled = False
_backends: list = []
# innermost-last active spans of the CURRENT context; an immutable tuple,
# so copied contexts (thread hops) never share a mutable stack
_stack: contextvars.ContextVar[tuple] = contextvars.ContextVar("curate_trace_stack", default=())
# True while exporting spans: a storage.write span made by the NDJSON
# backend's own flush would deadlock on the backend lock
_suppress: contextvars.ContextVar[bool] = contextvars.ContextVar("curate_trace_suppress", default=False)
# process-level base parent (trace_id, span_id) from an incoming traceparent
_process_parent: tuple[str, str] | None = None

TRACEPARENT_ENV = "CURATE_TRACEPARENT"


@dataclass
class TracedSpan:
    name: str
    trace_id: str
    span_id: str
    parent_id: str | None
    start_s: float
    attributes: dict[str, Any] = field(default_factory=dict)
    end_s: float | None = None
    # timestamped point events (W3C span events): the anomaly detector
    # stamps its verdicts here, inside the pipeline.run span
    events: list = field(default_factory=list)

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def add_event(self, name: str, **attributes: Any) -> None:
        self.events.append({"name": name, "ts": time.time(), "attributes": dict(attributes)})

    @property
    def duration_s(self) -> float:
        return (self.end_s or time.time()) - self.start_s


class _NdjsonBackend:
    """Buffers span records and flushes them through the storage layer.

    Storage cannot append, so each flush writes its buffered chunk to a NEW
    part file (``t.ndjson``, ``t.part1.ndjson``, ...) and drops the buffer:
    memory stays bounded at ``FLUSH_EVERY`` records and every byte is
    written once. Readers (the flight recorder, the artifact collector)
    glob ``*.ndjson``; a trace under ``FLUSH_EVERY`` spans is one file."""

    FLUSH_EVERY = 200

    def __init__(self, path: str) -> None:
        self.path = path
        self._lines: list[str] = []
        self._parts = 0
        self._flush_errors = 0
        self._lock = threading.Lock()

    def export(self, span: TracedSpan) -> None:
        record = {
            "name": span.name,
            "trace_id": span.trace_id,
            "span_id": span.span_id,
            "parent_id": span.parent_id,
            "start_s": span.start_s,
            "end_s": span.end_s,
            "duration_s": span.duration_s,
            "attributes": span.attributes,
            "pid": os.getpid(),
        }
        if span.events:
            record["events"] = span.events
        with self._lock:
            self._lines.append(json.dumps(record))
            if len(self._lines) >= self.FLUSH_EVERY:
                self._flush_locked()

    def _part_path(self) -> str:
        if self._parts == 0:
            return self.path
        if self.path.endswith(".ndjson"):
            return f"{self.path[:-len('.ndjson')]}.part{self._parts}.ndjson"
        return f"{self.path}.part{self._parts}"

    def _flush_locked(self) -> None:
        from cosmos_curate_tpu_torch.storage.client import write_bytes

        try:
            # the storage layer is traced itself: a span for THIS write
            # would re-enter export() under self._lock
            with suppress_tracing():
                write_bytes(self._part_path(), ("\n".join(self._lines) + "\n").encode())
        except Exception as e:
            # a flush failure never surfaces inside the instrumented work
            # (export runs in end_span, inside the caller's finally): the
            # chunk is dropped so memory stays bounded while storage is down
            self._flush_errors += 1
            if self._flush_errors == 1:
                logger.warning("trace flush to %s failed (%r); dropping %d span(s) (further failures logged at close)",
                               self._part_path(), e, len(self._lines))
        self._parts += 1
        self._lines = []

    def close(self) -> None:
        with self._lock:
            if self._lines:
                self._flush_locked()
            if self._flush_errors > 1:
                logger.warning("trace backend for %s dropped spans on %d failed flushes", self.path,
                               self._flush_errors)


class _OtlpHttpBackend:
    """OTLP/HTTP JSON trace exporter (the opentelemetry-proto trace service
    schema, JSON encoding): POSTs span batches to ``{endpoint}/v1/traces``
    with urllib from a background thread, so a slow collector never stalls
    a traced thread; a full queue drops the batch. Errors are logged once."""

    BATCH = 100
    MAX_QUEUED_BATCHES = 8

    def __init__(self, endpoint: str, service_name: str = "cosmos-curate-tpu") -> None:
        self.url = endpoint.rstrip("/") + "/v1/traces"
        self.service_name = service_name
        self._spans: list[TracedSpan] = []
        self._lock = threading.Lock()
        self._warned = False
        self._q: queue.Queue = queue.Queue(maxsize=self.MAX_QUEUED_BATCHES)
        self._sender = threading.Thread(target=self._send_loop, daemon=True, name="otlp-export")
        self._sender.start()

    def _send_loop(self) -> None:
        while True:
            batch = self._q.get()
            if batch is None:
                return
            self._post(batch)

    @staticmethod
    def _attr(key: str, value: Any) -> dict[str, Any]:
        if isinstance(value, bool):
            v: dict[str, Any] = {"boolValue": value}
        elif isinstance(value, int):
            v = {"intValue": str(value)}
        elif isinstance(value, float):
            v = {"doubleValue": value}
        else:
            v = {"stringValue": str(value)}
        return {"key": key, "value": v}

    def _encode(self, spans: list[TracedSpan]) -> bytes:
        otlp_spans = []
        for s in spans:
            rec = {
                "traceId": s.trace_id.ljust(32, "0"),
                "spanId": s.span_id,
                "name": s.name,
                "kind": 1,  # SPAN_KIND_INTERNAL
                "startTimeUnixNano": str(int(s.start_s * 1e9)),
                "endTimeUnixNano": str(int((s.end_s or s.start_s) * 1e9)),
                "attributes": [self._attr(k, v) for k, v in s.attributes.items()],
                "status": ({"code": 2, "message": str(s.attributes["error"])} if "error" in s.attributes
                           else {"code": 1}),
            }
            if s.parent_id:
                rec["parentSpanId"] = s.parent_id
            otlp_spans.append(rec)
        # the reference's service and scope names: a collector or dashboard
        # reads both packages' spans as one service
        payload = {
            "resourceSpans": [{
                "resource": {"attributes": [self._attr("service.name", self.service_name),
                                            self._attr("process.pid", os.getpid())]},
                "scopeSpans": [{"scope": {"name": "cosmos_curate_tpu.tracing"}, "spans": otlp_spans}],
            }]
        }
        return json.dumps(payload).encode()

    def export(self, span: TracedSpan) -> None:
        with self._lock:
            self._spans.append(span)
            if len(self._spans) < self.BATCH:
                return
            batch, self._spans = self._spans, []
        try:
            self._q.put_nowait(batch)
        except queue.Full:
            if not self._warned:
                self._warned = True
                logger.warning("OTLP export queue full; dropping span batches (collector at %s unreachable or slow)",
                               self.url)

    def _post(self, batch: list[TracedSpan]) -> None:
        import urllib.error
        import urllib.request

        req = urllib.request.Request(self.url, data=self._encode(batch),
                                     headers={"content-type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=10):
                pass
        except (urllib.error.URLError, ConnectionError, TimeoutError, OSError) as e:
            if not self._warned:
                self._warned = True
                logger.warning("OTLP trace export to %s failing (%s); further errors suppressed", self.url, e)

    def close(self) -> None:
        with self._lock:
            batch, self._spans = self._spans, []
        if batch:
            try:
                self._q.put_nowait(batch)
            except queue.Full:
                pass
        try:
            self._q.put_nowait(None)
        except queue.Full:
            return  # jammed by a dead collector; the daemon thread dies with us
        self._sender.join(timeout=15)


def otlp_endpoint_from_env() -> str | None:
    return os.environ.get("CURATE_OTLP_ENDPOINT") or os.environ.get("OTEL_EXPORTER_OTLP_ENDPOINT")


def default_staging_dir() -> str:
    """Per-run staging dir (concurrent pipelines on one host must not sweep
    each other's artifacts): ``CURATE_TRACE_DIR``, else one under the
    temporary directory named after the coordinator pid
    (``CURATE_STORE_OWNER``, else this process)."""
    run = os.environ.get("CURATE_STORE_OWNER", str(os.getpid()))
    return os.environ.get("CURATE_TRACE_DIR", os.path.join(tempfile.gettempdir(), "curate_traces", f"run-{run}"))


_ATEXIT_REGISTERED = False


def _flush_backends_at_exit() -> None:
    """Close (flush) the live backends at process exit: the NDJSON backend
    buffers, and a process that never disables tracing would lose its
    trace."""
    for b in _backends:
        try:
            b.close()
        except Exception:  # a failed flush must never break process exit
            pass


def enable_tracing(output_path: str | None = None, *, otlp_endpoint: str | None = None) -> str:
    """Turn tracing on for this process; returns the NDJSON path. An OTLP
    endpoint (argument or env) adds a second backend."""
    global _enabled, _backends, _ATEXIT_REGISTERED
    path = output_path or os.environ.get("CURATE_TRACE_PATH", f"{default_staging_dir()}/trace-{os.getpid()}.ndjson")
    for b in _backends:  # re-enabling must not drop buffered spans
        b.close()
    _backends = [_NdjsonBackend(path)]
    endpoint = otlp_endpoint or otlp_endpoint_from_env()
    if endpoint:
        _backends.append(_OtlpHttpBackend(endpoint))
    if not _ATEXIT_REGISTERED:
        import atexit

        atexit.register(_flush_backends_at_exit)
        _ATEXIT_REGISTERED = True
    _enabled = True
    return path


def disable_tracing() -> None:
    global _enabled, _backends, _process_parent
    _enabled = False
    _process_parent = None
    for b in _backends:
        b.close()
    _backends = []


def tracing_enabled() -> bool:
    return _enabled


# -- W3C trace-context propagation ------------------------------------------

_TRACEPARENT_RE = re.compile(r"^00-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")


def parse_traceparent(header: str | None) -> tuple[str, str] | None:
    """``00-<trace_id>-<span_id>-<flags>`` -> (trace_id, span_id), or None
    for anything malformed (the all-zero ids W3C forbids included)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip())
    if m is None:
        return None
    trace_id, span_id = m.group(1), m.group(2)
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def format_traceparent(span: TracedSpan | None = None) -> str:
    """The W3C traceparent of ``span`` (default: the innermost span, else
    the process-level parent); '' when tracing is off or nothing is
    active."""
    if not _enabled:
        return ""
    if span is None:
        stack = _stack.get()
        if stack:
            span = stack[-1]
        elif _process_parent is not None:
            return f"00-{_process_parent[0]}-{_process_parent[1]}-01"
        else:
            return ""
    if span is _NOOP_SPAN:
        return ""
    return f"00-{span.trace_id}-{span.span_id}-01"


def attach_traceparent(header: str | None) -> bool:
    """Adopt an incoming traceparent as this PROCESS's base parent: spans
    opened with no enclosing span parent onto it. True when a valid header
    was attached."""
    global _process_parent
    parsed = parse_traceparent(header)
    if parsed is None:
        return False
    _process_parent = parsed
    return True


def current_span() -> TracedSpan | None:
    """The innermost active span of this context, or None (disabled,
    suppressed or empty): how a helper deep in a call tree (the retry
    backoff) annotates the span its caller opened."""
    if not _enabled or _suppress.get():
        return None
    stack = _stack.get()
    return stack[-1] if stack else None


def current_trace_id() -> str | None:
    """Trace id of the current context (innermost span, else the process
    parent), or None; the dead-letter queue stamps it into its entries."""
    if not _enabled:
        return None
    stack = _stack.get()
    if stack:
        return stack[-1].trace_id
    return _process_parent[0] if _process_parent is not None else None


@contextlib.contextmanager
def suppress_tracing() -> Iterator[None]:
    """No spans are recorded inside this block (export paths keep their own
    storage writes out of the trace, and out of deadlocks)."""
    token = _suppress.set(True)
    try:
        yield
    finally:
        _suppress.reset(token)


# -- span lifecycle ----------------------------------------------------------


def start_span(name: str, *, traceparent: str | None = None, **attributes: Any) -> TracedSpan:
    """A manually managed span (exported by :func:`end_span`), the no-op
    span when disabled. It does not change the ambient context. Parent:
    explicit ``traceparent``, else the current stack, else the process
    parent, else a fresh trace."""
    if not _enabled or _suppress.get():
        return _NOOP_SPAN
    parent_ctx = parse_traceparent(traceparent) if traceparent else None
    if parent_ctx is None:
        stack = _stack.get()
        if stack:
            parent_ctx = (stack[-1].trace_id, stack[-1].span_id)
        elif _process_parent is not None:
            parent_ctx = _process_parent
    if parent_ctx is not None:
        trace_id, parent_id = parent_ctx
    else:
        trace_id, parent_id = uuid.uuid4().hex, None
    return TracedSpan(name=name, trace_id=trace_id, span_id=uuid.uuid4().hex[:16], parent_id=parent_id,
                      start_s=time.time(), attributes=dict(attributes))


def end_span(span: TracedSpan) -> None:
    """Finish and export a :func:`start_span` span (no-op spans pass)."""
    if span is _NOOP_SPAN or not _enabled:
        return
    if span.end_s is None:
        span.end_s = time.time()
    for b in _backends:
        b.export(span)


@contextlib.contextmanager
def traced_span(name: str, *, traceparent: str | None = None, **attributes: Any) -> Iterator[TracedSpan]:
    """Context-manager span, the no-op span when disabled. The span parents
    onto ``traceparent`` when given, else the contextvar stack (which
    survives ``contextvars.copy_context()`` thread hops), else the process
    parent. An exception leaving the block is recorded as ``error``."""
    if not _enabled or _suppress.get():
        yield _NOOP_SPAN
        return
    span = start_span(name, traceparent=traceparent, **attributes)
    token = _stack.set(_stack.get() + (span,))
    try:
        yield span
    except Exception as e:
        span.attributes["error"] = repr(e)
        raise
    finally:
        _stack.reset(token)
        end_span(span)


class _NoopSpan(TracedSpan):
    def set_attribute(self, key: str, value: Any) -> None:
        pass  # shared module-global: must not accumulate state

    def add_event(self, name: str, **attributes: Any) -> None:
        pass


_NOOP_SPAN = _NoopSpan("noop", "0", "0", None, 0.0)


def add_span_event(name: str, **attributes: Any) -> bool:
    """Attach a timestamped event to the innermost active span. With no
    active span but tracing on, a zero-duration span carries it instead.
    False (and nothing done) when tracing is off."""
    if not _enabled or _suppress.get():
        return False
    stack = _stack.get()
    if stack:
        stack[-1].add_event(name, **attributes)
        return True
    end_span(start_span(name, **attributes))
    return True
