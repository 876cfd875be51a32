"""``chip_smoke.py``'s ``service`` phase, which ``chip_smoke.py`` runs after
its ``av`` phase on the split phase's corpus and outputs, or alone on the
card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/service_phase.py

Alone, it builds the kernels, checks flash at ``chip_smoke.FLASH_CASES``,
writes the first ``SERVICE_VIDEOS`` videos of the split corpus and makes
what the full call's earlier phases leave: run B (the split phase's
captioned run, ``out_b``) and the one-node run A of the multinode phase
(``mn_one``), both in this process. One JSON line, ``service``:

1. **job** (a job through HTTP): the port's ``build_app`` serves on
   127.0.0.1 in a thread of this process; ``POST /v1/invoke`` a ``split``
   job with run B's settings (no ``device``: the job runs on the card) and
   poll ``/v1/progress/<id>`` to its end. The job child runs the port's
   ``_runner_code`` text unchanged, between a prologue that zeroes every
   kernel's launch counter and an epilogue that writes the counters to the
   job's work dir (the ``runner_cmd`` hook of ``build_app``). Asserted: run
   B's clip uuids, embeddings within ``EMBED_BOUND`` of run B's, every
   window captioned (texts reported, not asserted: run B's engine batches
   by host timing), and flash, paged decode and paged prefill launched in
   the child. Recorded: submit -> running, the child's spawn -> first log
   line, the job's wall beside run B's in-process wall, and the
   ``/health``, ``/v1/slo`` and ``/v1/jobs/<id>/status`` bodies.
2. **resume** (crash and resume): ``python -m cosmos_curate_tpu_torch.cli.main
   serve --work-root W`` as a subprocess; a job at run A's settings on the
   multinode phase's 2 videos; once ``/v1/jobs/<id>/status`` shows a stage
   busy, SIGKILL the service and start it again on ``W``. Asserted: the
   orphaned job child's process group has no live process when the new
   service first answers, and its log kills the orphan before it
   dispatches the resumed attempt; the journal reads running before the
   kill, the new service's log recovers the job interrupted -> pending, and
   the journal then reads pending -> running -> done (two attempts); the
   outputs equal the one-node run's (``mn_one``: clips, metas, files,
   embeddings within ``EMBED_BOUND``); SIGTERM ends the service with 0.
3. **search**: ``index build`` (the port's command line, in this process)
   over the job's embeddings; ``build_app`` with a ``search_config`` at it
   (the ``clip-text-l-tpu`` tower: the ``video`` embedding's 768 width;
   seeded, so ``CURATE_INDEX_ALLOW_RANDOM=1``); ``SEARCH_REQUESTS``
   requests by ``embedding``, ``clip_uuid`` and ``text`` in turn, each
   answer equal to the port's ``IndexServer`` queried directly under
   ``index_phase.same_answer``'s 1e-5 near-tie rule; causal flash launched
   in this process by the text path (every new flash shape checked and
   timed); p50 / p99 latency by mode; then a burst of ``BURST`` concurrent
   requests at a lane of ``max_inflight=1 + max_waiting=1`` (a 50 ms batch
   window holds each request): some shed with 429 and ``Retry-After``, the
   rest answered.

Every subprocess is killed in a ``finally`` and every wait has a timeout; a
check that fails makes the phase raise.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# a spawned child (the corpus writers) imports this script again as
# ``__mp_main__`` and runs none of its device code
if __name__ != "__mp_main__":
    import torch

REPO = Path(__file__).resolve().parents[1]
SEED = 21
SERVICE_VIDEOS = 2
TIMEOUT_S = 600
SEARCH_REQUESTS = 64
SEARCH_TEXT_MODEL = "clip-text-l-tpu"  # projection 768: the `video` embedding's width
BURST = 32
LIVE_INTERVAL_S = "0.2"  # the job child's live status cadence in the resume run
WORDS = "a red car drives down a wet city street at night while people cross under bright shop lights".split()


def http(method: str, url: str, body: dict | None = None, timeout: float = 60.0) -> tuple[int, dict, dict]:
    """(status, JSON body, headers) of one request; an HTTP error status is
    an answer, not an exception."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"} if data is not None else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def wait_for(pred, what: str, timeout: float = TIMEOUT_S, poll_s: float = 0.05):
    """``pred()`` until it returns something truthy; returns it."""
    deadline = time.monotonic() + timeout
    while True:
        out = pred()
        if out:
            return out
        if time.monotonic() > deadline:
            raise TimeoutError(f"service phase: timed out waiting for {what}")
        time.sleep(poll_s)


@contextlib.contextmanager
def serving(app, port: int):
    """``app`` on 127.0.0.1:``port`` in a thread with its own event loop;
    yields the base URL; the app is cleaned up (dispatcher stopped, search
    closed) on the way out."""
    from aiohttp import web

    loop = asyncio.new_event_loop()
    runner = web.AppRunner(app)
    started = threading.Event()
    failed: list[BaseException] = []

    def run() -> None:
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(runner.setup())
            loop.run_until_complete(web.TCPSite(runner, "127.0.0.1", port).start())
        except BaseException as e:  # handed to the caller's thread, which raises it
            failed.append(e)
            started.set()
            return
        started.set()
        loop.run_forever()
        loop.run_until_complete(runner.cleanup())
        loop.close()

    thread = threading.Thread(target=run, name="service-phase-app", daemon=True)
    thread.start()
    assert started.wait(TIMEOUT_S), "service phase: the app never started"
    if failed:
        raise failed[0]
    try:
        yield f"http://127.0.0.1:{port}"
    finally:
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=120)
        assert not thread.is_alive(), "service phase: the app's thread did not stop"


def job_args(a) -> dict:
    """A ``SplitPipelineArgs``' fields that differ from the defaults, as the
    JSON a client sends (tuples as lists)."""
    out = {}
    for f in dataclasses.fields(a):
        default = f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default
        value = getattr(a, f.name)
        if value != default:
            out[f.name] = list(value) if isinstance(value, tuple) else value
    return out


def counted_runner_cmd(rec, work_dir: Path) -> list[str]:
    """The port's job child program (``_runner_code``, unchanged) between a
    prologue that zeroes every kernel's launch counter and an epilogue that
    writes them to ``<work_dir>/launches.json``: the counters live in the
    process that launches."""
    from cosmos_curate_tpu_torch.service.app import _runner_code

    code = _runner_code(rec.pipeline, rec.args, str(work_dir / "summary.json"), work_dir=str(work_dir),
                        input_zip_url=rec.input_zip_url, output_zip_url=rec.output_zip_url,
                        output_zip_multipart=rec.output_zip_multipart)
    prologue = ("from cosmos_curate_tpu_torch.ops import kernels as _kernels\n"
                "for _k in _kernels().values():\n"
                "    _k.launches = 0\n")
    epilogue = ("import json as _json\n"
                f"_json.dump({{_n: _k.launches for _n, _k in _kernels().items()}}, open({str(work_dir / 'launches.json')!r}, 'w'))\n")
    return [sys.executable, "-c", prologue + code + epilogue]


def drive_job(cs, root: Path, run_b_wall: float) -> dict:
    """1. run B's settings as a job through the port's service (HTTP)."""
    from multinode_phase import free_port

    from cosmos_curate_tpu_torch.service.admission import QuotaConfig
    from cosmos_curate_tpu_torch.service.app import ServiceConfig, build_app

    model = next(p.name for p in (root / "out_b" / "embeddings").iterdir())
    b_metas, b_embs, _ = cs.split_outputs(root / "out_b", model)
    out = root / "svc_job_out"
    args = job_args(cs.split_args(root / "videos_b", out, captioning=True, caption_model="base"))
    # the host's CPU clamp (8 cores) would still allow this one job
    app = build_app(work_root=str(root / "svc_job"), config=ServiceConfig(quota=QuotaConfig(cpus_per_job=0.0)),
                    runner_cmd=counted_runner_cmd)
    state = app["state"]
    rec: dict = {"args": args}
    with serving(app, free_port()) as base:
        t_submit = time.time()
        status, doc, _ = http("POST", f"{base}/v1/invoke",
                              {"pipeline": "split", "args": args, "tenant": "chip", "priority": "interactive"})
        assert status == 200, doc
        job_id = doc["job_id"]
        log = state.log_path(job_id)
        first_line_at: list[float] = []
        live: dict = {}

        def ended():
            if not first_line_at and log.exists() and log.stat().st_size > 0:
                first_line_at.append(time.time())
            _, prog, _ = http("GET", f"{base}/v1/progress/{job_id}")
            if prog["state"] == "running" and not live.get("snapshot"):
                _, st, _ = http("GET", f"{base}/v1/jobs/{job_id}/status")
                if st.get("live") and st["snapshot"].get("state") == "running":
                    live.update(st)
            return prog if prog["state"] in ("done", "failed", "dead_lettered") else None

        prog = wait_for(ended, "the job's end", poll_s=0.02)
        tail = "\n".join(http("GET", f"{base}/v1/logs/{job_id}?tail=60")[1]["lines"])
        assert prog["state"] == "done" and prog["attempts"] == 1, f"{prog}\n{tail}"
        health = http("GET", f"{base}/health")[1]
        slo = http("GET", f"{base}/v1/slo")[1]
        job_status = http("GET", f"{base}/v1/jobs/{job_id}/status")[1]
    job = state.jobs[job_id]
    launches = json.loads((state.work_dir(job_id) / "launches.json").read_text())
    for name in ("flash", "paged_decode", "paged_prefill"):
        assert launches[name] > 0, f"service job: {name} was not launched in the job child ({launches})"
    metas, embs, _ = cs.split_outputs(out, model)
    assert set(metas) == set(b_metas) and set(embs) == set(b_embs) == set(metas), "service job: clip uuids"
    emb_diff = max(float(np.abs(embs[u] - b_embs[u]).max()) for u in embs)
    assert emb_diff <= cs.EMBED_BOUND, f"service job: embeddings {emb_diff} > {cs.EMBED_BOUND}"
    windows = [w for m in metas.values() for w in m["windows"]]
    assert windows and all(w["captions"].get("default") for w in windows), "service job: a window has no caption"
    b_captions = {(u, i): w["captions"]["default"] for u, m in b_metas.items() for i, w in enumerate(m["windows"])}
    captions = {(u, i): w["captions"]["default"] for u, m in metas.items() for i, w in enumerate(m["windows"])}
    rec.update(
        job_id=job_id, clips=len(metas), windows_captioned=len(windows), max_abs_embedding_diff=emb_diff,
        embed_bound=cs.EMBED_BOUND, captions_equal_to_run_b=sum(captions[k] == b_captions.get(k) for k in captions),
        caption_texts=[t[:60] for t in sorted(set(captions.values()))[:4]], launches=launches,
        submit_to_running_s=job.started_s - job.submitted_s, submit_to_ack_s=job.submitted_s - t_submit,
        spawn_to_first_log_line_s=(first_line_at[0] - job.started_s) if first_line_at else None,
        job_wall_s=job.finished_s - job.started_s, run_b_in_process_wall_s=run_b_wall,
        summary=prog["summary"], health=health, slo=slo, status=job_status,
        status_while_running={k: v for k, v in live.items() if k != "snapshot"}
        | ({"snapshot_state": live["snapshot"]["state"], "stages": sorted(live["snapshot"]["stages"])}
           if live.get("snapshot") else {}),
        journal=state.journal.path.read_text().count("\n"))
    return rec


def live_group(pgid: int) -> list[int]:
    from cosmos_curate_tpu_torch.service.job_queue import _live_group_members

    members = _live_group_members(pgid)
    assert members is not None, "/proc is unreadable here"
    return members


@contextlib.contextmanager
def serve_process(work_root: Path, port: int, log: Path):
    """``cosmos_curate_tpu_torch.cli.main serve`` on 127.0.0.1:``port`` until it
    answers ``/health``; yields (process, seconds to the first answer);
    SIGKILLed on the way out if still running."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "CURATE_LIVE_STATUS_INTERVAL_S": LIVE_INTERVAL_S}
    with open(log, "w") as out:
        t0 = time.monotonic()
        proc = subprocess.Popen([sys.executable, "-m", "cosmos_curate_tpu_torch.cli.main", "serve", "--host",
                                 "127.0.0.1", "--port", str(port), "--work-root", str(work_root)],
                                cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT)
    try:
        def up():
            if proc.poll() is not None:
                raise RuntimeError(f"serve exited {proc.returncode}:\n{log.read_text()[-3000:]}")
            try:
                return http("GET", f"http://127.0.0.1:{port}/health", timeout=5)[0] == 200
            except OSError:
                return False

        wait_for(up, "the service's /health", timeout=120, poll_s=0.01)
        yield proc, time.monotonic() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)


def drive_resume(cs, root: Path) -> dict:
    """2. a SIGKILLed ``serve`` resumes its job to a clean run's outputs."""
    from multinode_phase import free_port, held_to_one_node, output_files

    from cosmos_curate_tpu_torch.service.job_queue import JobJournal

    videos, clean = root / "videos_multinode", root / "mn_one"
    model = next(p.name for p in (clean / "embeddings").iterdir())
    metas, embs, _ = cs.split_outputs(clean, model)
    ref = {"model": model, "metas": metas, "embs": embs, "files": output_files(clean)}
    work, out = root / "svc_resume", root / "svc_resume_out"
    journal = work / "journal.ndjson"
    args = job_args(cs.split_args(videos, out))
    rec: dict = {"videos": SERVICE_VIDEOS}
    port = free_port()
    with serve_process(work, port, root / "svc_resume_1.log") as (proc, start_s):
        base = f"http://127.0.0.1:{port}"
        rec["serve_start_to_health_s"] = start_s
        status, doc, _ = http("POST", f"{base}/v1/invoke", {"pipeline": "split", "args": args})
        assert status == 200, doc
        job_id = doc["job_id"]
        t_submit = time.monotonic()

        def busy():
            _, st, _ = http("GET", f"{base}/v1/jobs/{job_id}/status")
            assert st["state"] in ("pending", "running"), f"the job ended before the kill: {st['state']}"
            stages = (st.get("snapshot") or {}).get("stages") or {}
            hot = sorted(n for n, s in stages.items() if s.get("busy_frac", 0) > 0 or s.get("inflight"))
            return (st, hot) if st.get("live") and st["snapshot"].get("state") == "running" and hot else None

        st, hot = wait_for(busy, "a busy stage", poll_s=0.02)
        orphan = next(j["pid"] for j in http("GET", f"{base}/v1/jobs")[1]["jobs"] if j["job_id"] == job_id)
        before = [(e["event"], e["record"]["state"]) for e in map(json.loads, journal.read_text().splitlines())]
        proc.kill()
        proc.wait(timeout=60)
        killed_at = time.monotonic()
        rec.update(submit_to_busy_stage_s=killed_at - t_submit, busy_stages=hot,
                   processed_videos_at_kill=len(list((out / "processed_videos").glob("*")))
                   if (out / "processed_videos").exists() else 0,
                   journal_before_kill=before, orphan_pid=orphan,
                   orphan_live_after_service_kill=len(live_group(orphan)))
    assert before[-1] == ("running", "running"), before
    assert rec["orphan_live_after_service_kill"] > 0, "the job child died with its service"

    port = free_port()
    log2 = root / "svc_resume_2.log"
    with serve_process(work, port, log2) as (proc, start_s):
        base = f"http://127.0.0.1:{port}"
        left = live_group(orphan)
        assert not left, f"the orphan's group is alive when the new service answers: {left}"
        rec.update(restart_to_health_s=start_s, orphan_live_at_first_health=len(left))

        def ended():
            _, prog, _ = http("GET", f"{base}/v1/progress/{job_id}")
            return prog if prog["state"] in ("done", "failed", "dead_lettered") else None

        prog = wait_for(ended, "the resumed job's end")
        assert prog["state"] == "done" and prog["attempts"] == 2, prog
        rec["resumed_job_wall_s"] = time.monotonic() - killed_at
        proc.send_signal(signal.SIGTERM)
        rec["serve_exit_code"] = proc.wait(timeout=120)
    assert rec["serve_exit_code"] == 0, log2.read_text()[-3000:]
    lines = log2.read_text().splitlines()
    kill_line = next(i for i, line in enumerate(lines) if f"killed orphaned job process group {orphan}" in line)
    dispatch_line = next(i for i, line in enumerate(lines) if f"job {job_id} dispatched" in line)
    assert kill_line < dispatch_line and "; gone after" in lines[kill_line], lines[kill_line]
    assert any(f"job {job_id} recovered from journal (interrupted → pending)" in line for line in lines)
    events = [(e["event"], e["record"]["state"]) for e in map(json.loads, journal.read_text().splitlines())]
    # the transitions; the dispatcher also journals the anomaly verdicts it
    # relays from the job's live status (receipts, no state change)
    after = [ev for ev in events if not ev[0].startswith(("anomaly:", "slo-breach:"))]
    assert after == [("compact", "pending"), ("running", "running"), ("done", "done")], events
    assert JobJournal(journal).replay()[job_id].attempts == 2
    rec.update(orphan_reaped=lines[kill_line].split(" - ", 1)[-1], journal_after_restart=after,
               journal_receipts=sorted({ev[0] for ev in events} - {ev[0] for ev in after}),
               journal_reads=["running", "interrupted", "pending", "running", "done"],
               max_abs_embedding_diff=held_to_one_node(cs, out, ref, "resumed job"), clips=len(metas))
    return rec


def drive_search(cs, dev, timer, root: Path, job_out: Path) -> dict:
    """3. ``POST /v1/search`` over an index of the job's embeddings."""
    from index_phase import same_answer
    from multinode_phase import free_port

    from cosmos_curate_tpu_torch.cli import main as cli
    from cosmos_curate_tpu_torch.dedup.index_server import IndexServer
    from cosmos_curate_tpu_torch.ops import kernels
    from cosmos_curate_tpu_torch.service.app import build_app
    from cosmos_curate_tpu_torch.service.search import SearchConfig

    device = torch.device(dev).type
    index = root / "svc_index"
    t0 = time.monotonic()
    assert cli.main(["index", "build", "--input-path", str(job_out), "--index-path", str(index),
                     "--device", device]) == 0
    rec: dict = {"index_build_s": time.monotonic() - t0}
    model = next(p.name for p in (job_out / "embeddings").iterdir())
    _, embs, _ = cs.split_outputs(job_out, model)
    uuids = sorted(embs)
    rng = np.random.default_rng(SEED)
    texts = [" ".join(rng.choice(WORDS, size=int(rng.integers(4, 12)))) for _ in range(SEARCH_REQUESTS)]
    queries = []
    for i in range(SEARCH_REQUESTS):
        mode = ("embedding", "clip_uuid", "text")[i % 3]
        value = {"embedding": [float(v) for v in embs[uuids[i % len(uuids)]]], "clip_uuid": uuids[i % len(uuids)],
                 "text": texts[i]}[mode]
        queries.append({mode: value, "top_k": 5})
    cfg = SearchConfig(index_path=str(index), text_model=SEARCH_TEXT_MODEL, device=device)
    latencies: dict = collections.defaultdict(list)
    answers = []
    shapes: set = set()
    launches: dict = {}
    with cs.patched_environ({"CURATE_INDEX_ALLOW_RANDOM": "1"}):
        app = build_app(work_root=str(root / "svc_search"), search_config=cfg)
        with cs.recorded_flash_shapes(shapes), cs.counted_launches(launches):
            with serving(app, free_port()) as base:
                health = http("GET", f"{base}/health")[1]
                assert health["search"]["enabled"], health
                # each mode's first request, not among the timed ones: the
                # text tower is built on the first text query
                first_ms = {}
                for q in queries[:3]:
                    t = time.perf_counter()
                    status, doc, _ = http("POST", f"{base}/v1/search", q)
                    first_ms[next(iter(q))] = 1e3 * (time.perf_counter() - t)
                    assert status == 200, (q, doc)
                for q in queries:
                    t = time.perf_counter()
                    status, doc, _ = http("POST", f"{base}/v1/search", q)
                    latencies[next(iter(q))].append(time.perf_counter() - t)
                    assert status == 200, (q, doc)
                    answers.append(doc)
                stats = http("GET", f"{base}/v1/search/stats")[1]
            torch.cuda.synchronize()
        assert launches["flash"] > 0, f"search: the text path launched no flash ({launches})"
        assert any(causal for _, causal in shapes), f"search: no causal flash call ({shapes})"
        server = IndexServer(str(index), text_model=SEARCH_TEXT_MODEL, device=device)
        try:
            for q, doc in zip(queries, answers, strict=True):
                mode, value = next(iter(q.items()))
                kw = {"vecs": np.asarray(value, np.float32)} if mode == "embedding" else {mode: value}
                hits, generation = server.search(**kw, top_k=5)
                got = [(h["clip_uuid"], h["score"]) for h in doc["results"]]
                assert same_answer(got, hits[0]) and doc["generation"] == generation, (q, got, hits[0])
        finally:
            server.close()
        # a burst past the lane: 1 in flight + 1 waiting, each request held
        # by a 50 ms batch window
        burst_cfg = dataclasses.replace(cfg, max_inflight=1, max_waiting=1, batch_window_s=0.05)
        app = build_app(work_root=str(root / "svc_burst"), search_config=burst_cfg)
        with serving(app, free_port()) as base, ThreadPoolExecutor(max_workers=BURST) as pool:
            burst = list(pool.map(lambda q: http("POST", f"{base}/v1/search", q), queries[:BURST]))
            shed_total = http("GET", f"{base}/v1/search/stats")[1]["shed_total"]
    shed = [(s, d, h) for s, d, h in burst if s == 429]
    assert shed and all(h.get("Retry-After") for _, _, h in shed), [s for s, _, _ in burst]
    assert all(s == 200 for s, _, _ in burst if s != 429), [s for s, _, _ in burst]
    assert shed_total == len(shed), (shed_total, len(shed))

    def pct(xs, p):
        return 1e3 * float(np.percentile(xs, p))

    everything = [x for xs in latencies.values() for x in xs]
    rec.update(
        requests=len(queries), first_request_ms=first_ms, text_model=SEARCH_TEXT_MODEL,
        index_vectors=stats["num_vectors"],
        generation=stats["generation"], answers_equal_index_server=len(queries),
        latency_ms={"p50": pct(everything, 50), "p99": pct(everything, 99)}
        | {mode: {"p50": pct(xs, 50), "p99": pct(xs, 99), "n": len(xs)} for mode, xs in latencies.items()},
        server_stats={k: stats[k] for k in ("counts", "cache", "inflight", "shed_total") if k in stats},
        launches=launches, flash_shapes=sorted([list(s), c] for s, c in shapes),
        burst={"requests": BURST, "shed_429": len(shed), "answered": BURST - len(shed),
               "retry_after": sorted({h["Retry-After"] for _, _, h in shed}), "lane_shed_total": shed_total},
        health_search=health["search"])
    rec["flash_checked_here"] = cs.check_new_flash_shapes(timer, shapes, SEED)
    return rec


def run(cs, dev, timer, root: Path, corpus: list[Path], run_b_wall: float) -> dict:
    """The phase, its line emitted as it ends; returns the record."""
    t0 = time.monotonic()
    job = drive_job(cs, root, run_b_wall)
    resume = drive_resume(cs, root)
    search = drive_search(cs, dev, timer, root, root / "svc_job_out")
    record = {"job": job, "resume": resume, "search": search, "flash_checked_here": search.pop("flash_checked_here")}
    record["launches"] = {"job": job["launches"], "search": search["launches"]}
    record["phase_s"] = time.monotonic() - t0
    record["card"] = cs.card_line()
    cs.emit({"phase": "service", **record})
    print(f"service: job {job['job_wall_s']:.3f} s (run B in process {run_b_wall:.3f} s, queue "
          f"{job['submit_to_running_s']:.3f} s); resume {resume['resumed_job_wall_s']:.3f} s after the kill; "
          f"search p50 {search['latency_ms']['p50']:.3f} ms p99 {search['latency_ms']['p99']:.3f} ms, "
          f"{search['burst']['shed_429']} of {BURST} shed; phase {record['phase_s']:.1f} s", flush=True)
    return record


def main() -> int:
    if not torch.cuda.is_available():
        print("service_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import pyarrow.parquet  # noqa: F401  (main thread first: see remote_phase.main)

    import chip_smoke as cs
    from cosmos_curate_tpu_torch.core.runner import default_runner
    from cosmos_curate_tpu_torch.models.vlm import SharedCaptionEngine
    from cosmos_curate_tpu_torch.pipelines.video import split
    from cosmos_curate_tpu_torch.pipelines.video.stages.writer import ClipWriterStage

    dev = torch.device("cuda", 0)
    started = time.monotonic()
    timer, build_s = cs.phase_prologue(dev)
    stage_classes = (split.VideoDownloadStage, split.FixedStrideExtractorStage, split.ClipTranscodingStage,
                     split.ClipFrameExtractionStage, split.ClipEmbeddingStage, split.CaptionPrepStage,
                     split.CaptionStage, ClipWriterStage)
    with cs.split_corpus(SERVICE_VIDEOS) as (root, corpus, corpus_s):
        # what the full call's split and multinode phases leave: run B and the one-node run A
        SharedCaptionEngine.reset()
        try:
            b = cs.split_run(dev, cs.split_args(cs.subset(root, corpus, "videos_b", SERVICE_VIDEOS), root / "out_b",
                                                captioning=True, caption_model="base"), default_runner(),
                             stage_classes)
        finally:
            SharedCaptionEngine.reset()
        cs.split_run(dev, cs.split_args(cs.subset(root, corpus, "videos_multinode", SERVICE_VIDEOS), root / "mn_one"),
                     default_runner(), stage_classes)
        cs.emit({"phase": "service_prologue", "build_s": build_s, "corpus_build_s": corpus_s, "run_b_wall_s": b["wall"]})
        run(cs, dev, timer, root, corpus, b["wall"])
    cs.emit({"phase": "timing", "script_s": time.monotonic() - started})
    return 0


if __name__ == "__main__":
    sys.exit(main())
