"""Port parity: the job service's HTTP surface (``service/app.py``), the
scenarios of ``tests/service/test_service.py`` through both packages' apps,
and real jobs through the port's.

- ``/health``, ``/v1/invoke``'s validation and the unknown-job answers give
  the same statuses and bodies (ids and times masked) in both services.
- A real ``split`` job with ``"device": "cpu"`` runs in a job child of the
  port's service on one small fixture video; its clips, metas, embeddings
  and files equal a direct ``run_split`` of the port on the same args
  (which ``tests/test_torch_split.py`` holds to the JAX package).
- A job without ``device`` asks for the card: on a host without one its
  child fails, the job ends ``dead_lettered`` after its attempts, and its
  error and log name the missing device.
- ``/v1/models`` lists the port's model registry.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import pytest

from tests.fixtures.media import make_scene_video
from tests.fixtures.observability import observability_state  # noqa: F401  (autouse)
from tests.fixtures.service_harness import PACKAGES, Service, config, masked, package

PKGS = [package(name) for name in PACKAGES]
JAX, PORT = PKGS


def both(tmp_path, scenario, **kw) -> list:
    """``scenario(svc)`` against each package's service; returns both
    transcripts, masked, after asserting they agree."""
    outs = []
    for pkg in PKGS:
        root = tmp_path / pkg.name
        svc = Service(pkg, root / "service", config=config(pkg), **kw)
        try:
            outs.append(masked(scenario(svc), root))
        finally:
            svc.close()
    assert outs[1] == outs[0]
    return outs[1]


def test_health(tmp_path):
    status, body = both(tmp_path, lambda svc: svc.req("GET", "/health")[:2])
    assert status == 200 and body["status"] == "ok" and body["active_job"] is None


def test_invoke_validation(tmp_path):
    def scenario(svc):
        return [svc.req("POST", "/v1/invoke", **kw)[:2] for kw in (
            {"json": {"pipeline": "nope"}}, {"data": b"not json"}, {"json": {"pipeline": "split", "args": 3}})]

    out = both(tmp_path, scenario)
    assert [status for status, _ in out] == [400, 400, 400]


def test_unknown_job(tmp_path):
    def scenario(svc):
        return [svc.req(method, path)[:2] for method, path in (
            ("GET", "/v1/progress/zzz"), ("GET", "/v1/logs/zzz"), ("GET", "/v1/jobs/zzz/status"),
            ("POST", "/v1/terminate/zzz"), ("POST", "/v1/requeue/zzz"))]

    assert [status for status, _ in both(tmp_path, scenario)] == [404] * 5


def test_routes_are_the_reference_routes(tmp_path):
    routes = []
    for pkg in PKGS:
        svc = Service(pkg, tmp_path / pkg.name)
        try:
            routes.append(sorted((r.method, r.resource.canonical) for r in svc.app.router.routes()))
        finally:
            svc.close()
    assert routes[1] == routes[0]


def test_models_lists_the_port_registry(tmp_path):
    from cosmos_curate_tpu_torch.models import registry

    svc = Service(PORT, tmp_path / "svc")
    try:
        status, body, _ = svc.req("GET", "/v1/models")
    finally:
        svc.close()
    assert status == 200 and body["weights_root"] == str(registry.weights_root())
    assert sorted(body["models"]) == sorted(registry.registered_models())
    assert all(set(m) == {"staged", "size_bytes"} for m in body["models"].values())


# -- real jobs through the port's service -----------------------------------------

SPLIT_ARGS = {"fixed_stride_len_s": 1.0, "min_clip_len_s": 0.5, "embedding_model": "video-256",
              "extract_resize_hw": [64, 64]}


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("service_videos")
    make_scene_video(d / "v.mp4", scene_len_frames=24, num_scenes=2)
    return d


def _outputs(out) -> tuple[dict, dict, set]:
    import pyarrow.parquet as pq

    metas = {p.stem: json.loads(p.read_text()) for p in (out / "metas" / "v0").glob("*.json")}
    embs = {}
    for path in (out / "embeddings").rglob("*.parquet"):
        table = pq.read_table(path).to_pydict()
        embs.update(zip(table["clip_uuid"], (np.asarray(e, np.float32) for e in table["embedding"]), strict=True))
    files = {str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()
             and not str(p.relative_to(out)).startswith(("report/", "summary"))}
    return metas, embs, files


def test_cpu_split_job_matches_run_split(videos, tmp_path):
    """The job child runs the port's ``run_split`` on ``SplitPipelineArgs``
    built from the job's args: the same outputs as calling it directly."""
    import pyarrow.parquet  # noqa: F401  (in the main thread first: see remote_phase.main)

    from cosmos_curate_tpu_torch.pipelines.video import split

    args = {**SPLIT_ARGS, "input_path": str(videos), "output_path": str(tmp_path / "job_out"), "device": "cpu"}
    svc = Service(PORT, tmp_path / "svc", config=config(PORT))
    try:
        job_id = svc.submit(args=args, tenant="acme", priority="interactive")
        svc.wait_state(job_id, "done", "failed", "dead_lettered", timeout=240)
        status, prog, _ = svc.req("GET", f"/v1/progress/{job_id}")
        log = "\n".join(svc.req("GET", f"/v1/logs/{job_id}?tail=40")[1]["lines"])
        assert prog["state"] == "done", log
        assert prog["attempts"] == 1 and prog["summary"]["num_clips"] == 2, prog
        # the transitions (the dispatcher also journals the anomaly verdicts
        # it relays from the job's live status, which a loaded host may raise)
        assert [ev for ev in svc.journal_events() if not ev[0].startswith("anomaly:")] == [
            ("submit", "pending"), ("running", "running"), ("done", "done")]
    finally:
        svc.close()
    direct = split.run_split(split.SplitPipelineArgs(**{**args, "extract_resize_hw": (64, 64),
                                                       "output_path": str(tmp_path / "direct_out")}))
    job_metas, job_embs, job_files = _outputs(tmp_path / "job_out")
    metas, embs, files = _outputs(tmp_path / "direct_out")
    assert job_metas == metas and len(metas) == 2
    assert job_files == files
    assert set(job_embs) == set(embs) == set(metas)
    for uuid, emb in embs.items():
        np.testing.assert_allclose(job_embs[uuid], emb, rtol=0, atol=1e-6)
    summary = {k: v for k, v in prog["summary"].items() if k not in ("timestamp", "pipeline_run_time_s",
                                                                         "video_hours_per_day_per_chip")}
    assert summary == {k: v for k, v in direct.items() if k in summary}


def test_job_without_a_device_fails_without_a_card(videos, tmp_path, monkeypatch):
    """No ``device`` in the args: the child asks for the card, finds none on
    this host, and fails every attempt; it never runs on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the job would run on it")
    args = {**SPLIT_ARGS, "input_path": str(videos), "output_path": str(tmp_path / "out")}
    svc = Service(PORT, tmp_path / "svc", config=config(PORT))
    try:
        job_id = svc.submit(args=args, max_attempts=2)
        svc.wait_state(job_id, "dead_lettered", "done", timeout=240)
        _, prog, _ = svc.req("GET", f"/v1/progress/{job_id}")
        _, logs, _ = svc.req("GET", f"/v1/logs/{job_id}?tail=400")
    finally:
        svc.close()
    assert prog["state"] == "dead_lettered" and prog["attempts"] == 2, prog
    assert "no CUDA device is available" in prog["error"], prog["error"]
    assert sum("no CUDA device is available" in line for line in logs["lines"]) >= 2
    assert not list((tmp_path / "out").rglob("*.json")), "the job wrote clips"


def test_runner_code_imports_the_port(tmp_path):
    """The job child's program is the reference's, on the port's modules."""
    code = PORT.app._runner_code("split", {"device": "cpu"}, str(tmp_path / "s.json"), work_dir=str(tmp_path))
    ref = JAX.app._runner_code("split", {"device": "cpu"}, str(tmp_path / "s.json"), work_dir=str(tmp_path))
    assert code == ref.replace("cosmos_curate_tpu", "cosmos_curate_tpu_torch")
    assert "cosmos_curate_tpu." not in code.replace("cosmos_curate_tpu_torch", "")
    compile(code, "<runner>", "exec")
    cmd = PORT.app._default_runner_cmd(PORT.job_queue.JobRecord.new("split", {}), tmp_path)
    assert cmd[:2] == [sys.executable, "-c"]
