"""Both packages' job services side by side, for the port's parity tests
(``tests/test_torch_service_*.py``).

A :class:`Service` is one package's app (``build_app``) on an aiohttp test
server with its own event loop and sync helpers: the reference's
``tests/service`` harness with the package as an argument. Waits poll a
condition against a deadline; no test relies on a sleep being long
enough. :func:`masked` takes ids, times and the work root out of a JSON
body, :func:`journal_events` reads a journal as its (event, state)
sequence, and :func:`service_series` snapshots a package's ``service_*``
and ``search_shed`` metric series, so a scenario's answers in the two
packages compare as equal.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import re
import sys
import time
from pathlib import Path
from types import SimpleNamespace

from aiohttp.test_utils import TestClient, TestServer

PACKAGES = ("cosmos_curate_tpu", "cosmos_curate_tpu_torch")
# the fields whose values the clock decides
TIME_KEYS = frozenset({"ts", "elapsed_s", "submitted_s", "enqueued_s", "started_s", "finished_s", "latency_ms",
                       "snapshot_age_s", "mean_s", "max_s", "retry_after_s", "pid"})
JOB_ID = re.compile(r"\b[0-9a-f]{12}\b")


def package(name: str) -> SimpleNamespace:
    """The service modules of one package."""
    mods = {m: importlib.import_module(f"{name}.service.{m}") for m in ("app", "admission", "job_queue", "slo", "search")}
    return SimpleNamespace(name=name, chaos=importlib.import_module(f"{name}.chaos"), **mods)


def config(pkg: SimpleNamespace, slo=None, **kw):
    """A ``ServiceConfig`` of ``pkg`` with the reference tests' settings:
    the CPU clamp off (a CI box may have 1 core), short retry backoff,
    ``kw`` split between ``QuotaConfig`` and ``ServiceConfig``."""
    kw.setdefault("cpus_per_job", 0.0)
    fields = set(pkg.admission.QuotaConfig.__dataclass_fields__)
    quota = {k: v for k, v in kw.items() if k in fields}
    rest = {k: v for k, v in kw.items() if k not in fields}
    rest.setdefault("retry_base_s", 0.05)
    rest.setdefault("retry_cap_s", 0.1)
    return pkg.app.ServiceConfig(quota=pkg.admission.QuotaConfig(**quota), slo=slo or pkg.slo.SloConfig(), **rest)


class Service:
    """One package's app + its own event loop, with sync helpers."""

    def __init__(self, pkg: SimpleNamespace, work_root, config=None, runner_cmd=None, search_config=None):
        self.pkg = pkg
        self.work_root = Path(work_root)
        self.app = pkg.app.build_app(work_root=str(work_root), config=config, runner_cmd=runner_cmd,
                                     search_config=search_config)
        self.state = self.app["state"]
        self.loop = asyncio.new_event_loop()

        async def make():
            client = TestClient(TestServer(self.app))
            await client.start_server()
            return client

        self.client = self.loop.run_until_complete(make())

    def req(self, method, path, **kw):
        async def go():
            resp = await self.client.request(method, path, **kw)
            return resp.status, await resp.json(), resp.headers

        return self.loop.run_until_complete(go())

    def submit(self, **body):
        body.setdefault("pipeline", "split")
        body.setdefault("args", {})
        status, doc, _ = self.req("POST", "/v1/invoke", json=body)
        assert status == 200, doc
        return doc["job_id"]

    def wait(self, pred, timeout=30.0, msg="condition"):
        async def go():
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                if pred():
                    return True
                await asyncio.sleep(0.02)
            return pred()

        assert self.loop.run_until_complete(go()), f"{self.pkg.name}: timeout waiting for {msg}"

    def wait_state(self, job_id, *states, timeout=30.0):
        """Until the job is in one of ``states`` and its transition is
        journaled (the journal thread runs appends in order, so a no-op
        after them returns once they have)."""
        self.wait(lambda: self.state.jobs[job_id].state in states, timeout=timeout,
                  msg=f"job {job_id} -> {states} (now {self.state.jobs[job_id].state})")
        self.state._journal_exec.submit(lambda: None).result(timeout=timeout)

    def wait_http(self, method, path, accept, timeout=30.0, msg="http condition"):
        """Poll an endpoint from inside the loop until ``accept(status,
        doc)``; returns that (status, doc)."""

        async def go():
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                resp = await self.client.request(method, path)
                doc = await resp.json()
                if accept(resp.status, doc):
                    return resp.status, doc
                await asyncio.sleep(0.02)
            return None

        out = self.loop.run_until_complete(go())
        assert out is not None, f"{self.pkg.name}: timeout waiting for {msg}"
        return out

    def sleep(self, seconds: float) -> None:
        self.loop.run_until_complete(asyncio.sleep(seconds))

    def journal_events(self) -> list[tuple[str, str]]:
        return journal_events(self.work_root / "journal.ndjson")

    def close(self):
        self.loop.run_until_complete(self.client.close())
        self.loop.close()

    def close_abruptly(self):
        """Tear down without letting watchers or the journal see the job
        exits: the in-process stand-in for the service being kill -9'd."""
        for task in list(self.state.watchers):
            task.cancel()
        self.app["dispatcher"].cancel()
        self.loop.run_until_complete(self.client.close())
        self.loop.close()


def sleep_job(duration_s, rc=0):
    """A job command: sleep, then write summary.json (or exit ``rc``)."""

    def cmd(rec, work_dir):
        code = (
            "import json, sys, time\n"
            f"time.sleep({duration_s})\n"
            f"rc = {rc}\n"
            "if rc == 0:\n"
            "    json.dump({'ok': True}, open(sys.argv[1], 'w'))\n"
            "sys.exit(rc)\n"
        )
        return [sys.executable, "-c", code, str(work_dir / "summary.json")]

    return cmd


def gated_job(gate: Path, rc=0):
    """A job command that runs until ``gate`` exists (or 60 s), then writes
    summary.json (or exits ``rc``): a test decides when it ends."""

    def cmd(rec, work_dir):
        code = (
            "import json, os, sys, time\n"
            "deadline = time.monotonic() + 60\n"
            "while not os.path.exists(sys.argv[2]) and time.monotonic() < deadline:\n"
            "    time.sleep(0.01)\n"
            f"rc = {rc}\n"
            "if rc == 0:\n"
            "    json.dump({'ok': True}, open(sys.argv[1], 'w'))\n"
            "sys.exit(rc)\n"
        )
        return [sys.executable, "-c", code, str(work_dir / "summary.json"), str(gate)]

    return cmd


def masked(doc, root=None):
    """``doc`` with job ids, clock-decided fields and ``root`` (a work root
    or tmp dir, which differs between the two packages' runs) replaced."""
    if isinstance(doc, dict):
        return {masked(k, root): ("<t>" if k in TIME_KEYS and doc[k] is not None else masked(v, root))
                for k, v in doc.items()}
    if isinstance(doc, list):
        return [masked(v, root) for v in doc]
    if isinstance(doc, tuple):
        return tuple(masked(v, root) for v in doc)
    if isinstance(doc, str):
        if root is not None:
            doc = doc.replace(str(root), "<root>")
        return JOB_ID.sub("<id>", doc)
    return doc


def journal_events(path: Path) -> list[tuple[str, str]]:
    """(event, record state) of every line of a journal."""
    out = []
    for line in Path(path).read_text().splitlines():
        doc = json.loads(line)
        out.append((doc["event"], doc["record"]["state"]))
    return out


def service_series(pkg: SimpleNamespace) -> dict:
    """{(sample name, labels): value} of the package's ``service_*`` and
    ``search_shed`` series (the JAX package's live in the process's default
    registry, the port's in its own)."""
    if pkg.name == "cosmos_curate_tpu":
        from prometheus_client import REGISTRY as registry
    else:
        from cosmos_curate_tpu_torch.engine.metrics import get_metrics

        registry = get_metrics().registry
    out = {}
    for metric in registry.collect():
        for s in metric.samples:
            if s.name.startswith(("service_", "search_shed")) and not s.name.endswith("_created"):
                out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


def series_delta(before: dict, after: dict) -> dict:
    """The counters' increments and the gauges' last values between two
    snapshots, zero entries dropped."""
    out = {}
    for key, value in after.items():
        gauge = key[0] in ("service_jobs_current", "service_queue_depth")
        d = value if gauge else value - before.get(key, 0.0)
        if d:
            out[key] = round(d, 6) if not key[0].startswith("service_queue_wait") else "<t>"
    return out
