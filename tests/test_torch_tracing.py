"""The port's tracing (``cosmos_curate_tpu_torch/observability/tracing.py``)
against the JAX package's, on the same inputs: W3C traceparent parsing and
formatting, the disabled no-op path, the contextvar thread hop and the
process-level parent, NDJSON rotation, the OTLP/HTTP payload (ids and times
pinned) and its export to a local collector, suppression, the storage spans
and the retry backoff's annotation of them.

Both packages' tracers, environment and aggregates are restored after every
test (tests/fixtures/observability.py)."""

from __future__ import annotations

import contextvars
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

from cosmos_curate_tpu.observability import tracing as jtracing
from cosmos_curate_tpu.storage import client as jclient
from cosmos_curate_tpu.storage import retry as jretry
from cosmos_curate_tpu_torch.observability import tracing as ttracing
from cosmos_curate_tpu_torch.storage import client as tclient
from cosmos_curate_tpu_torch.storage import retry as tretry
from tests.fixtures.observability import observability_state  # noqa: F401  (autouse)

PACKAGES = {"jax": (jtracing, jclient, jretry), "torch": (ttracing, tclient, tretry)}
TIMEOUT_S = 30.0


def _records(path: Path) -> list[dict]:
    return [json.loads(line) for f in sorted(path.parent.glob("*.ndjson")) for line in f.read_text().splitlines()
            if line.strip()]


def _shape(records: list[dict]) -> list[tuple]:
    """Span names with each span's parent's name: the tree, ids aside."""
    by_id = {r["span_id"]: r["name"] for r in records}
    return sorted((r["name"], by_id.get(r["parent_id"])) for r in records)


# -- W3C traceparent -----------------------------------------------------------

MALFORMED = [
    None,
    "",
    "garbage",
    "00-zz-yy-01",
    "00-" + "0" * 32 + "-" + "a" * 16 + "-01",  # all-zero trace id
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",  # all-zero span id
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01",  # short trace id
    "00-" + "A" * 32 + "-" + "b" * 16 + "-01",  # upper case
    "01-" + "a" * 32 + "-" + "b" * 16,  # no flags
]


@pytest.mark.parametrize("header", MALFORMED, ids=[f"malformed{i}" for i in range(len(MALFORMED))])
def test_malformed_traceparent_is_refused_by_both(header):
    assert ttracing.parse_traceparent(header) is None
    assert jtracing.parse_traceparent(header) is None
    assert ttracing.attach_traceparent(header) is False


def test_traceparent_round_trip_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    for _ in range(8):
        trace_id = "".join(rng.choice(list("0123456789abcdef"), 32))
        span_id = "".join(rng.choice(list("0123456789abcdef"), 16))
        header = f"00-{trace_id}-{span_id}-01"
        assert ttracing.parse_traceparent(header) == jtracing.parse_traceparent(header) == (trace_id, span_id)
        assert ttracing.parse_traceparent(f"  {header}\n") == (trace_id, span_id)
    for name, (tr, _, _) in PACKAGES.items():
        tr.enable_tracing(str(tmp_path / name / "t.ndjson"))
        with tr.traced_span("root") as span:
            header = tr.format_traceparent()
            assert header == f"00-{span.trace_id}-{span.span_id}-01"
            assert tr.parse_traceparent(header) == (span.trace_id, span.span_id)
            assert tr.current_trace_id() == span.trace_id
        tr.disable_tracing()
    # the same span formats the same in both
    t_span = ttracing.TracedSpan("x", "ab" * 16, "cd" * 8, None, 1.0)
    j_span = jtracing.TracedSpan("x", "ab" * 16, "cd" * 8, None, 1.0)
    ttracing.enable_tracing(str(tmp_path / "t2.ndjson"))
    jtracing.enable_tracing(str(tmp_path / "j2.ndjson"))
    assert ttracing.format_traceparent(t_span) == jtracing.format_traceparent(j_span)


@pytest.mark.parametrize("name", list(PACKAGES))
def test_disabled_tracer_is_the_noop_singleton_and_writes_nothing(name, tmp_path, monkeypatch):
    tr, client, _ = PACKAGES[name]
    monkeypatch.setenv("CURATE_TRACE_DIR", str(tmp_path / "staging"))
    assert not tr.tracing_enabled()
    with tr.traced_span("a", k=1) as a, tr.traced_span("b") as b:
        a.set_attribute("x", 1)
        a.add_event("e")
    assert a is b is tr._NOOP_SPAN is tr.start_span("c")
    assert tr._NOOP_SPAN.attributes == {} and tr._NOOP_SPAN.events == []
    assert tr.format_traceparent() == "" and tr.current_trace_id() is None and tr.current_span() is None
    assert tr.add_span_event("e") is False
    tr.end_span(tr.start_span("d"))
    client.write_bytes(str(tmp_path / "data.bin"), b"x")
    assert sorted(p.name for p in tmp_path.rglob("*")) == ["data.bin"]


@pytest.mark.parametrize("name", list(PACKAGES))
def test_thread_hop_under_copy_context_and_the_process_parent(name, tmp_path):
    tr = PACKAGES[name][0]
    path = tmp_path / "t.ndjson"
    tr.enable_tracing(str(path))

    def child(label: str) -> None:
        with tr.traced_span(label):
            pass

    with tr.traced_span("root") as root:
        hop = threading.Thread(target=contextvars.copy_context().run, args=(child, "copied"))
        hop.start()
        hop.join(TIMEOUT_S)
        assert not hop.is_alive()
        # a plain thread starts with an empty stack: without a process
        # parent its span is a fresh trace
        bare = threading.Thread(target=child, args=("bare",))
        bare.start()
        bare.join(TIMEOUT_S)
        # with the root attached as the process parent it joins the trace
        assert tr.attach_traceparent(tr.format_traceparent(root))
        attached = threading.Thread(target=child, args=("attached",))
        attached.start()
        attached.join(TIMEOUT_S)
        assert not bare.is_alive() and not attached.is_alive()
    tr.disable_tracing()
    recs = {r["name"]: r for r in _records(path)}
    assert recs["copied"]["parent_id"] == recs["attached"]["parent_id"] == root.span_id
    assert recs["copied"]["trace_id"] == recs["attached"]["trace_id"] == root.trace_id
    assert recs["bare"]["parent_id"] is None and recs["bare"]["trace_id"] != root.trace_id


def test_thread_hop_records_the_same_tree_as_jax(tmp_path):
    shapes = {}
    for name, (tr, _, _) in PACKAGES.items():
        path = tmp_path / name / "t.ndjson"
        tr.enable_tracing(str(path))
        with tr.traced_span("root"):
            threads = [threading.Thread(target=contextvars.copy_context().run, args=(_nested, tr, i))
                       for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(TIMEOUT_S)
        tr.disable_tracing()
        shapes[name] = _shape(_records(path))
    assert shapes["torch"] == shapes["jax"]
    assert len(shapes["torch"]) == 7


def _nested(tr, i: int) -> None:
    with tr.traced_span(f"child{i}"):
        with tr.traced_span(f"leaf{i}"):
            pass


@pytest.mark.parametrize("n_spans", [3, 7, 9])
def test_ndjson_rotation_matches_jax(n_spans, tmp_path, monkeypatch):
    layouts = {}
    for name, (tr, _, _) in PACKAGES.items():
        monkeypatch.setattr(tr._NdjsonBackend, "FLUSH_EVERY", 3)
        root = tmp_path / name
        tr.enable_tracing(str(root / "traces" / "driver.ndjson"))
        for i in range(n_spans):
            with tr.traced_span(f"s{i}"):
                pass
        tr.disable_tracing()
        layouts[name] = {str(p.relative_to(root)): [json.loads(x)["name"] for x in p.read_text().splitlines()]
                         for p in sorted(root.rglob("*.ndjson"))}
    assert layouts["torch"] == layouts["jax"]
    assert len(layouts["torch"]) == -(-n_spans // 3)
    assert sorted(n for names in layouts["torch"].values() for n in names) == sorted(f"s{i}" for i in range(n_spans))


def _pinned_spans(tr) -> list:
    spans = [
        tr.TracedSpan("pipeline.run", "0123456789abcdef0123456789abcdef", "0011223344556677", None, 1700000000.25,
                      {"runner": "pipelined", "stages": 3, "ratio": 0.5, "ok": True}, 1700000002.75),
        tr.TracedSpan("stage.X.process", "0123456789abcdef0123456789abcdef", "8899aabbccddeeff", "0011223344556677",
                      1700000000.5, {"batch_size": 4, "error": "ValueError('boom')"}, 1700000001.0),
        tr.TracedSpan("orphan", "abc", "1234567890abcdef", None, 1700000003.0, {"path": Path("/x")}, None),
    ]
    spans[0].add_event("anomaly.stuck_batch", stage="X")
    return spans


def test_otlp_payload_of_pinned_spans_equals_jax():
    payloads = {}
    for name, (tr, _, _) in PACKAGES.items():
        backend = tr._OtlpHttpBackend("http://127.0.0.1:9")  # never posts: nothing is exported
        try:
            payloads[name] = json.loads(backend._encode(_pinned_spans(tr)))
        finally:
            backend.close()
    assert payloads["torch"] == payloads["jax"]
    spans = payloads["torch"]["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert [s["status"]["code"] for s in spans] == [1, 2, 1]
    assert spans[2]["traceId"] == "abc".ljust(32, "0")


class _Collector:
    """A local OTLP/HTTP sink on a free port."""

    def __init__(self) -> None:
        self.payloads: list[dict] = []
        self.paths: list[str] = []
        sink = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):  # noqa: N802
                body = self.rfile.read(int(self.headers.get("content-length", "0")))
                sink.payloads.append(json.loads(body))
                sink.paths.append(self.path)
                self.send_response(200)
                self.send_header("content-length", "0")
                self.end_headers()

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    @property
    def endpoint(self) -> str:
        host, port = self.server.server_address[:2]
        return f"http://{host}:{port}"

    def spans(self) -> list[dict]:
        return [s for p in self.payloads for rs in p["resourceSpans"] for ss in rs["scopeSpans"] for s in ss["spans"]]

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(TIMEOUT_S)


@pytest.mark.parametrize("n_spans", [5, 130])
def test_otlp_export_reaches_a_local_collector_like_jax(n_spans, tmp_path):
    received = {}
    for name, (tr, _, _) in PACKAGES.items():
        with _Collector() as sink:
            tr.enable_tracing(str(tmp_path / name / "t.ndjson"), otlp_endpoint=sink.endpoint)
            with tr.traced_span("root"):
                for i in range(n_spans - 1):
                    with tr.traced_span("child", i=i):
                        pass
            tr.disable_tracing()  # close() flushes the partial batch and joins the sender
            assert set(sink.paths) == {"/v1/traces"}
            received[name] = sorted(s["name"] for s in sink.spans())
            assert len({s["traceId"] for s in sink.spans()}) == 1
    assert received["torch"] == received["jax"]
    assert len(received["torch"]) == n_spans


@pytest.mark.parametrize("name", list(PACKAGES))
def test_suppressed_block_records_nothing(name, tmp_path):
    tr, client, _ = PACKAGES[name]
    path = tmp_path / "t.ndjson"
    tr.enable_tracing(str(path))
    with tr.suppress_tracing():
        with tr.traced_span("hidden") as span:
            assert span is tr._NOOP_SPAN and tr.current_span() is None
        client.write_bytes(str(tmp_path / "data.bin"), b"xyz")
    with tr.traced_span("shown"):
        assert tr.add_span_event("marker", n=1)
    assert tr.add_span_event("loose")  # no active span: a zero-length span carries it
    tr.disable_tracing()
    recs = _records(path)
    assert sorted(r["name"] for r in recs) == ["loose", "shown"]
    assert [e["name"] for e in next(r for r in recs if r["name"] == "shown")["events"]] == ["marker"]


def test_storage_spans_and_retry_annotation_match_jax(tmp_path):
    recs = {}
    for name, (tr, client, retry) in PACKAGES.items():
        path = tmp_path / name / "t.ndjson"
        data = tmp_path / name / "blob.bin"
        tr.enable_tracing(str(path))
        with tr.traced_span("stage.X.process"):
            client.write_bytes(str(data), b"abcdef")
            assert client.read_bytes(str(data)) == b"abcdef"
            with tr.traced_span("storage.read", path="p") as span:
                for attempt in range(2):
                    retry.sleep_backoff(attempt, base=0.0)
                assert span.attributes["attempt"] == 3 and span.attributes["backoff_s"] == 0.0
            # a non-storage span is left alone
            with tr.traced_span("api.caption") as other:
                retry.sleep_backoff(0, base=0.0)
                assert "attempt" not in other.attributes
        tr.disable_tracing()
        recs[name] = _records(path)
    for name, rs in recs.items():
        for r in rs:
            r["attributes"].pop("path", None)
    keyed = {name: sorted((r["name"], json.dumps(r["attributes"], sort_keys=True)) for r in rs)
             for name, rs in recs.items()}
    assert keyed["torch"] == keyed["jax"]
    assert ("storage.write", json.dumps({"backend": "local", "bytes": 6}, sort_keys=True)) in keyed["torch"]
