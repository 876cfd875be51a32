"""Port parity: the commands of the job service slice, ``serve``, ``view``,
``slurm`` and ``index serve`` (``cli/serve_cli.py``, ``view_cli.py``,
``slurm_cli.py``, ``index_cli.py``), and ``top`` against the port's real
service.

- ``serve``: the same flags build the same ``ServiceConfig`` and
  ``SearchConfig`` in both packages (the port's search config also carries
  ``--device``); ``python -m cosmos_curate_tpu_torch.cli.main serve`` runs
  the port's service, and ``top --once`` (text and JSON, the service and a
  job) prints the same through both command lines against it; SIGTERM
  drains it and it exits 0.
- ``index serve``: both command lines serve one index (the port with
  ``--device cpu``) and answer ``/health`` and ``/v1/search`` alike.
- ``view``: the same page of the same split output; the same refusal of a
  directory that is not one.
- ``slurm``: dry runs only (no ``sbatch`` here). ``submit`` prints and
  writes the JAX package's scripts with the port's module names (and the
  coordinator comment naming the gloo group); ``prom-sd`` writes the same
  file; ``parse_job_id`` parses alike.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from cosmos_curate_tpu.cli import main as jmain
from cosmos_curate_tpu.cli import slurm_cli as jslurm
from cosmos_curate_tpu.cli import view_cli as jview
from cosmos_curate_tpu_torch.cli import main as tmain
from cosmos_curate_tpu_torch.cli import slurm_cli as tslurm
from cosmos_curate_tpu_torch.cli import view_cli as tview

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url: str, body: dict | None = None) -> tuple[int, dict]:
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _started(argv: list[str], port: int, log: Path) -> subprocess.Popen:
    """``python -m <package>.cli.main <argv>`` until its /health answers."""
    with open(log, "w") as out:
        proc = subprocess.Popen([sys.executable, "-m", *argv], cwd=REPO, stdout=out, stderr=subprocess.STDOUT,
                                env={**os.environ, "PYTHONPATH": str(REPO)})
    deadline = time.monotonic() + TIMEOUT_S
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"{argv[:3]} exited {proc.returncode}:\n{log.read_text()[-3000:]}")
        try:
            if _get(f"http://127.0.0.1:{port}/health")[0] == 200:
                return proc
        except OSError:
            pass
        time.sleep(0.05)
    proc.kill()
    raise AssertionError(f"{argv[:3]} never answered /health:\n{log.read_text()[-3000:]}")


def _stopped(proc: subprocess.Popen) -> int:
    """SIGTERM (the service drains) and the exit code."""
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


# -- serve ---------------------------------------------------------------------

SERVE_ARGV = ["serve", "--port", "0", "--work-root", "W", "--max-concurrent", "3", "--max-running-per-tenant", "1",
              "--max-queued-per-tenant", "5", "--max-queued-total", "9", "--cpus-per-job", "0.5",
              "--memory-gb-per-job", "2", "--max-attempts", "4", "--drain-s", "7", "--term-grace-s", "1.5",
              "--slo-queue-wait-s", "2", "--slo-run-duration-s", "60", "--slo-success-rate", "0.9", "--slo-window", "20",
              "--index-path", "IDX", "--search-max-inflight", "3", "--search-max-waiting", "4",
              "--search-text-model", "clip-text-tiny-test", "--search-cache-mb", "16", "--compact-interval-s", "30"]


@pytest.mark.parametrize("device", [[], ["--device", "cpu"]], ids=["default", "cpu"])
def test_serve_flags_build_the_reference_config(device, monkeypatch):
    seen = {}
    for name, main in (("jax", jmain), ("torch", tmain)):
        app = __import__(f"{main.__name__.rsplit('.', 2)[0]}.service.app", fromlist=["serve"])
        monkeypatch.setattr(app, "serve", lambda **kw: seen.setdefault(name, kw))
        assert main.main(SERVE_ARGV + (device if name == "torch" else [])) == 0
    j, t = seen["jax"], seen["torch"]
    assert {k: v for k, v in t.items() if k not in ("config", "search_config")} == \
        {k: v for k, v in j.items() if k not in ("config", "search_config")}
    assert dataclasses.asdict(t["config"]) == dataclasses.asdict(j["config"])
    search = dataclasses.asdict(t["search_config"])
    assert search.pop("device") == (device[1] if device else "cuda")
    assert search == dataclasses.asdict(j["search_config"])


def test_top_against_the_ports_service(tmp_path, capsys):
    """The port's ``serve`` command on a local port, one CPU job through it,
    then ``top`` through both command lines."""
    port = _free_port()
    proc = _started(["cosmos_curate_tpu_torch.cli.main", "serve", "--host", "127.0.0.1", "--port", str(port),
                     "--work-root", str(tmp_path / "work")], port, tmp_path / "serve.log")
    base = f"http://127.0.0.1:{port}"
    try:
        (tmp_path / "in").mkdir()
        status, doc = _get(f"{base}/v1/invoke", {"pipeline": "split", "tenant": "acme", "args": {
            "input_path": str(tmp_path / "in"), "output_path": str(tmp_path / "out"), "device": "cpu"}})
        assert status == 200, doc
        job_id = doc["job_id"]
        deadline = time.monotonic() + TIMEOUT_S
        while _get(f"{base}/v1/progress/{job_id}")[1]["state"] not in ("done", "failed", "dead_lettered"):
            assert time.monotonic() < deadline, "the job never ended"
            time.sleep(0.1)
        assert _get(f"{base}/v1/progress/{job_id}")[1]["state"] == "done"
        for argv in (["top", base, "--once"], ["top", base, "--once", "--json"],
                     ["top", base, "--job", job_id, "--once", "--json"],
                     ["top", f"{base}/v1/jobs/{job_id}/status", "--once"]):
            rc = tmain.main(argv)
            out = capsys.readouterr().out
            j_rc = jmain.main(argv)
            j_out = capsys.readouterr().out
            mask = lambda s: re.sub(r"\d+\.\d+", "<n>", s)  # noqa: E731  (ages and elapsed seconds)
            assert rc == j_rc == 0 and mask(out) == mask(j_out), argv
            if argv == ["top", base, "--once"]:
                assert "queues: interactive=0  batch=0" in out, out
    finally:
        rc = _stopped(proc)
    assert rc == 0, (tmp_path / "serve.log").read_text()[-3000:]


# -- index serve ------------------------------------------------------------------


def test_index_serve_answers_like_jax(tmp_path):
    """One index (written by the JAX package; the layout is shared) served
    by both ``index serve`` commands: the same health and the same hits."""
    from cosmos_curate_tpu.dedup.corpus_index import CorpusIndex

    rng = np.random.default_rng(0)
    centers = rng.standard_normal((4, 16)).astype(np.float32)
    vecs = np.concatenate([c + 0.05 * rng.standard_normal((20, 16)) for c in centers]).astype(np.float32)
    root = str(tmp_path / "idx")
    CorpusIndex.build(root, [f"c{i}" for i in range(len(vecs))], vecs, model="m", k=4)
    answers, codes = [], []
    for name, extra in (("cosmos_curate_tpu", []), ("cosmos_curate_tpu_torch", ["--device", "cpu"])):
        port = _free_port()
        proc = _started([f"{name}.cli.main", "index", "serve", "--index-path", root, "--host", "127.0.0.1",
                         "--port", str(port), "--text-model", "clip-text-tiny-test", *extra],
                        port, tmp_path / f"{name}.log")
        try:
            base = f"http://127.0.0.1:{port}"
            health = _get(f"{base}/health")
            hits = [_get(f"{base}/v1/search", {"embedding": [float(v) for v in vecs[i]], "top_k": 5})
                    for i in (3, 40)]
            uuid = _get(f"{base}/v1/search", {"clip_uuid": "c7", "top_k": 3})
            unknown = _get(f"{base}/v1/search", {"clip_uuid": "nope"})
            answers.append((health, hits, uuid, unknown))
        finally:
            codes.append(_stopped(proc))
    (jh, jhits, juuid, junknown), (th, thits, tuuid, tunknown) = answers
    assert codes == [0, 0]
    assert th[0] == jh[0] == 200 and th[1]["status"] == jh[1]["status"] == "ok"
    assert th[1]["search"]["num_vectors"] == jh[1]["search"]["num_vectors"] == 80
    for (ts, tb), (js, jb) in zip([*thits, tuuid], [*jhits, juuid], strict=True):
        assert ts == js == 200 and tb["mode"] == jb["mode"] and tb["generation"] == jb["generation"]
        assert [h["clip_uuid"] for h in tb["results"]] == [h["clip_uuid"] for h in jb["results"]]
        np.testing.assert_allclose([h["score"] for h in tb["results"]], [h["score"] for h in jb["results"]],
                                   rtol=0, atol=1e-5)
    assert tunknown == junknown and tunknown[0] == 404


# -- view ------------------------------------------------------------------------------


def test_view_renders_the_reference_page(tmp_path, capsys):
    root = tmp_path / "out"
    (root / "metas" / "v0").mkdir(parents=True)
    metas = [{"uuid": "u1", "span_start": 0.0, "span_end": 1.0, "motion_score_global": 0.5,
              "windows": [{"captions": {"default": "a <b>red</b> car"}}]},
             {"uuid": "u2", "span_start": 1.0, "span_end": 2.5, "aesthetic_score": 0.25, "filtered_by": "motion",
              "windows": []}]
    for meta in metas:
        (root / "metas" / "v0" / f"{meta['uuid']}.json").write_text(json.dumps(meta))
    page = tview._render_index(root)
    assert page == jview._render_index(root)
    assert "Curated clips (2)" in page and "&lt;b&gt;red&lt;/b&gt;" in page and "FILTERED: motion" in page
    argv = ["view", "--input-path", str(tmp_path / "not-a-split")]
    assert tmain.main(argv) == jmain.main(argv) == 2


# -- slurm -----------------------------------------------------------------------------


def _port_script(jax_script: str) -> str:
    """The JAX package's script with the port's module names."""
    return (jax_script.replace("cosmos_curate_tpu.", "cosmos_curate_tpu_torch.")
            .replace("(jax.distributed convention)", "(the gloo group's rank 0)"))


@pytest.mark.parametrize("extra", [
    [],
    ["--nodes", "4", "--partition", "gpu", "--account", "acct", "--env", "A=1", "--env", "B=two words",
     "--merge-output", "/out/run", "--prom-sd-file", "/tmp/sd.json", "--metrics-port", "9100"],
    ["--nodes", "3", "--engine-plane", "--engine-port", "9000", "--merge-output", "/out/x"],
], ids=["default", "partition-env-merge-promsd", "engine-plane"])
def test_slurm_submit_scripts_match_jax(extra, tmp_path, capsys):
    argv = ["slurm", "submit", *extra, "--", "local", "split", "--config", "run.yaml", "--limit", "2"]
    assert tmain.main(argv) == 0
    out = capsys.readouterr().out
    assert jmain.main(argv) == 0
    j_out = capsys.readouterr().out
    assert out == _port_script(j_out) and "cosmos_curate_tpu_torch.cli.main" in out
    assert "cosmos_curate_tpu." not in out and "jax" not in out
    # --output writes the same script
    for name, main in (("jax", jmain), ("torch", tmain)):
        assert main.main([*argv[:2], "--output", str(tmp_path / f"{name}.sbatch"), *argv[2:]]) == 0
    capsys.readouterr()
    assert (tmp_path / "torch.sbatch").read_text() == _port_script((tmp_path / "jax.sbatch").read_text())


def test_slurm_submit_without_a_command_exits_2(capsys):
    assert tmain.main(["slurm", "submit"]) == jmain.main(["slurm", "submit"]) == 2


def test_slurm_prom_sd_and_job_ids_match_jax(tmp_path, capsys):
    hosts = tmp_path / "hosts"
    hosts.write_text("node-a\n\nnode-b\n")
    for name, main in (("jax", jmain), ("torch", tmain)):
        assert main.main(["slurm", "prom-sd", "--path", str(tmp_path / f"{name}.json"), "--hostfile", str(hosts),
                          "--port", "9002", "--job-id", "77", "--job-name", "j", "--job-user", "u"]) == 0
    capsys.readouterr()
    assert (tmp_path / "torch.json").read_text() == (tmp_path / "jax.json").read_text()
    assert json.loads((tmp_path / "torch.json").read_text())[0]["targets"] == ["node-a:9002", "node-b:9002"]
    assert tslurm.parse_job_id("Submitted batch job 12345\n") == jslurm.parse_job_id("Submitted batch job 12345") == "12345"
    for mod in (tslurm, jslurm):
        with pytest.raises(ValueError):
            mod.parse_job_id("sbatch: error")
