"""The observability layer's process-wide state, kept from leaking between
tests.

Both packages keep it per process: the environment variables that
``run_split`` exports (``CURATE_LIVE_STATUS_DIR``) or that the layer reads,
each package's tracing switch, backends and process-level parent, and each
package's stage_timer aggregates. Tier-1 runs many test files in one worker
process, so a test that runs ``run_split``, a runner or the layer itself
leaves all of it as it found it: import :func:`observability_state` into the
test module (it is autouse there), or wrap a module-scoped fixture's body in
:func:`preserved_observability_state`.
"""

from __future__ import annotations

import contextlib
import copy
import os

import pytest

from cosmos_curate_tpu.observability import stage_timer as jstage_timer
from cosmos_curate_tpu.observability import tracing as jtracing
from cosmos_curate_tpu_torch.observability import stage_timer as tstage_timer
from cosmos_curate_tpu_torch.observability import tracing as ttracing

ENV_NAMES = (
    "CURATE_LIVE_STATUS_DIR",
    "CURATE_LIVE_STATUS",
    "CURATE_LIVE_STATUS_INTERVAL_S",
    "CURATE_TRACEPARENT",
    "CURATE_DISPATCH_DUMP_DIR",
    "CURATE_NODE_ID",
    "CURATE_OTLP_ENDPOINT",
    "OTEL_EXPORTER_OTLP_ENDPOINT",
    "CURATE_TRACE_DIR",
)
# stage_timer's aggregates (dicts and one set), in both packages
_AGGREGATES = ("_DISPATCH", "_FOLDED", "_FLOW", "_CAPTION", "_INDEX", "_SEARCH", "_ANOMALY_COUNTS", "_OP",
               "_OP_NODES", "_MERGED_DUMPS")
_PACKAGES = ((jtracing, jstage_timer), (ttracing, tstage_timer))


def _clear_aggregates(st) -> None:
    for name in _AGGREGATES:
        getattr(st, name).clear()
    if st._ANOMALY_RECENT is not None:
        st._ANOMALY_RECENT.clear()


@contextlib.contextmanager
def preserved_observability_state():
    """Inside the block the aggregates start empty and tracing off; after
    it, the environment, both tracers and the aggregates are as before."""
    env = {name: os.environ.get(name) for name in ENV_NAMES}
    saved = []
    for tr, st in _PACKAGES:
        saved.append((tr._enabled, list(tr._backends), tr._process_parent,
                      {name: copy.deepcopy(getattr(st, name)) for name in _AGGREGATES},
                      list(st._ANOMALY_RECENT or ())))
        tr._enabled, tr._backends, tr._process_parent = False, [], None
        _clear_aggregates(st)
    try:
        yield
    finally:
        for name, value in env.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
        for (tr, st), (enabled, backends, parent, aggs, recent) in zip(_PACKAGES, saved):
            if tr._enabled:
                tr.disable_tracing()  # flush and close what the block left on
            tr._enabled, tr._backends, tr._process_parent = enabled, backends, parent
            _clear_aggregates(st)
            for name, value in aggs.items():
                getattr(st, name).update(value)
            if st._ANOMALY_RECENT is not None:
                st._ANOMALY_RECENT.extend(recent)


@pytest.fixture(autouse=True)
def observability_state():
    with preserved_observability_state():
        yield
