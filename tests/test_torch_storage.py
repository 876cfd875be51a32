"""Port parity: the storage layer's dispatch, local backend, background
uploader and retry policy (``storage/client.py``, ``storage/retry.py``),
and the host utilities the remote backends use (``utils/user_config.py``,
``utils/retry.py``, ``utils/file_lock.py``). The cases of the JAX package's
``tests/storage/test_storage.py`` and ``test_retry.py``, each also held
against the JAX function where both answer the same question."""

from __future__ import annotations

import io
import json
import multiprocessing
import random
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pyarrow.parquet as pq
import pytest

from cosmos_curate_tpu.storage import client as jclient
from cosmos_curate_tpu.storage import retry as jretry
from cosmos_curate_tpu.utils import retry as jretry_utils
from cosmos_curate_tpu.utils import user_config as j_user_config
from cosmos_curate_tpu_torch.observability import tracing
from cosmos_curate_tpu_torch.storage import (
    LocalStorageClient,
    StorageClient,
    get_storage_client,
    is_remote_path,
    read_bytes,
    write_bytes,
    writers,
)
from cosmos_curate_tpu_torch.storage import client as storage_client
from cosmos_curate_tpu_torch.storage import retry
from cosmos_curate_tpu_torch.storage.client import BackgroundUploader, relative_to_prefix
from cosmos_curate_tpu_torch.utils import file_lock, user_config
from cosmos_curate_tpu_torch.utils import retry as retry_utils
from tests.fixtures.observability import observability_state  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _no_remote_credentials(monkeypatch):
    for var in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY", "AWS_ENDPOINT_URL", "AZURE_STORAGE_ACCOUNT",
                "AZURE_STORAGE_KEY", "AZURE_STORAGE_SAS_TOKEN", "CURATE_CONFIG_PATH"):
        monkeypatch.delenv(var, raising=False)
    user_config.load_user_config.cache_clear()
    yield
    user_config.load_user_config.cache_clear()


def test_path_model():
    for path in ("s3://bucket/key", "gs://bucket/key", "az://cont/blob", "/data/x.mp4", "rel/x.mp4", "s3:/x"):
        assert is_remote_path(path) == jclient.is_remote_path(path)
        assert storage_client.backend_name(path) == jclient.backend_name(path)
    assert isinstance(get_storage_client("/tmp/x"), LocalStorageClient)
    assert issubclass(LocalStorageClient, StorageClient)


@pytest.mark.parametrize("path,prefix", [("s3://b/in/a.mp4", "s3://b/in"), ("s3://b/input/a.mp4", "s3://b/in"),
                                         ("videos/a.mp4", "./videos"), ("az://c/x/y/z.mp4", "az://c/x/")])
def test_relative_to_prefix_matches_jax(path, prefix):
    assert relative_to_prefix(path, prefix) == jclient.relative_to_prefix(path, prefix)


@pytest.mark.parametrize("path", ["s3://bucket/key", "az://cont/blob"])
def test_gated_backend_raises_clearly(path, tmp_path, monkeypatch):
    """Without credentials a remote path raises ``RuntimeError`` naming what
    is missing, in both packages, and is never read as a local file of the
    same name."""
    monkeypatch.chdir(tmp_path)
    local_twin = tmp_path / path.replace("://", ":/")
    local_twin.parent.mkdir(parents=True)
    local_twin.write_bytes(b"local")
    match = "boto3" if path.startswith("s3") else "AZURE_STORAGE_ACCOUNT"
    with pytest.raises(RuntimeError, match=match):
        get_storage_client(path)
    with pytest.raises(RuntimeError, match=match):
        read_bytes(path)
    with pytest.raises(RuntimeError, match=match):
        jclient.get_storage_client(path)


def test_local_roundtrip_and_atomicity(tmp_path):
    p = tmp_path / "a" / "b" / "f.bin"  # parents made
    write_bytes(str(p), b"hello")
    assert read_bytes(str(p)) == b"hello"
    assert not p.with_name("f.bin.tmp").exists()


def test_list_files_and_relative(tmp_path):
    (tmp_path / "sub").mkdir()
    (tmp_path / "a.mp4").write_bytes(b"1")
    (tmp_path / "b.txt").write_bytes(b"22")
    (tmp_path / "sub" / "c.mp4").write_bytes(b"333")
    client, jc = LocalStorageClient(), jclient.LocalStorageClient()
    mp4s = list(client.list_files(str(tmp_path), suffixes=(".mp4",)))
    assert [i.path.split("/")[-1] for i in mp4s] == ["a.mp4", "c.mp4"]
    assert mp4s[1].size == 3
    assert [(i.path, i.size) for i in mp4s] == [(i.path, i.size) for i in jc.list_files(str(tmp_path),
                                                                                       suffixes=(".mp4",))]
    assert client.list_relative(str(tmp_path), suffixes=(".mp4",)) == ["a.mp4", "sub/c.mp4"]
    assert len(list(client.list_files(str(tmp_path), recursive=False))) == 2


def test_delete(tmp_path):
    client = LocalStorageClient()
    f = tmp_path / "x.bin"
    f.write_bytes(b"1")
    client.delete(str(f))
    assert not f.exists()
    d = tmp_path / "dir"
    (d / "nested").mkdir(parents=True)
    client.delete(str(d))
    assert not d.exists()


def test_background_uploader(tmp_path):
    up = BackgroundUploader()
    for i in range(10):
        up.submit(str(tmp_path / f"f{i}.bin"), bytes([i]))
    assert up.close() == []
    assert read_bytes(str(tmp_path / "f7.bin")) == b"\x07"


def test_background_uploader_records_failures(tmp_path):
    (tmp_path / "file").write_bytes(b"x")
    up = BackgroundUploader()
    up.submit(str(tmp_path / "file" / "under_a_file.bin"), b"1")  # its parent is a file
    up.submit(str(tmp_path / "ok.bin"), b"2")
    errors = up.close()
    assert [p for p, _ in errors] == [str(tmp_path / "file" / "under_a_file.bin")]
    assert (tmp_path / "ok.bin").read_bytes() == b"2"


def test_background_write_span_parents_onto_the_submitter(tmp_path):
    """Each write runs in its submitter's context: its ``storage.write`` span
    is a child of the span open where ``submit`` was called."""
    trace = tmp_path / "trace.ndjson"
    tracing.enable_tracing(str(trace))
    try:
        up = BackgroundUploader()
        with tracing.traced_span("stage.writer") as stage:
            up.submit(str(tmp_path / "out.bin"), b"abc")
        assert up.close() == []
    finally:
        tracing.disable_tracing()
    spans = [json.loads(line) for line in trace.read_text().splitlines()]
    write = next(s for s in spans if s["name"] == "storage.write")
    assert write["parent_id"] == stage.span_id and write["trace_id"] == stage.trace_id
    assert write["attributes"] == {"backend": "local", "path": str(tmp_path / "out.bin"), "bytes": 3}


def test_writers(tmp_path):
    writers.write_json(str(tmp_path / "o.json"), {"a": np.int64(3), "b": np.float32(0.5)})
    assert json.loads(read_bytes(str(tmp_path / "o.json"))) == {"a": 3, "b": 0.5}
    writers.write_csv(str(tmp_path / "o.csv"), [{"x": 1, "y": 2}], ["x", "y"])
    assert read_bytes(str(tmp_path / "o.csv")).decode().splitlines()[1] == "1,2"
    writers.write_parquet(str(tmp_path / "o.parquet"), {"ids": [1, 2], "vals": [0.1, 0.2]})
    assert pq.read_table(str(tmp_path / "o.parquet")).column("ids").to_pylist() == [1, 2]
    writers.write_npy(str(tmp_path / "o.npy"), np.arange(5))
    assert np.array_equal(np.load(io.BytesIO(read_bytes(str(tmp_path / "o.npy")))), np.arange(5))


# -- retry policy (tests/storage/test_retry.py) ----------------------------------


def test_retryable_statuses_include_throttling():
    assert retry.RETRYABLE_STATUSES == jretry.RETRYABLE_STATUSES
    assert 429 in retry.RETRYABLE_STATUSES
    for s in (500, 502, 503, 504):
        assert retry.is_retryable_status(s)
    for s in (200, 301, 400, 403, 404, 501):
        assert not retry.is_retryable_status(s)


@pytest.mark.parametrize("base,cap", [(retry.DEFAULT_BASE_S, retry.DEFAULT_CAP_S), (1.0, 8.0)])
def test_backoff_full_jitter_bounds_and_draws_match_jax(base, cap):
    rng, j_rng = random.Random(0), random.Random(0)
    for attempt in range(10):
        for _ in range(20):
            d = retry.backoff_s(attempt, base=base, cap=cap, rng=rng)
            assert 0.0 <= d <= min(cap, base * 2**attempt)
            assert d == jretry.backoff_s(attempt, base=base, cap=cap, rng=j_rng)


def test_backoff_respects_cap():
    rng = random.Random(1)
    assert max(retry.backoff_s(30, rng=rng) for _ in range(100)) <= 5.0


def test_backoff_is_jittered_not_fixed():
    rng = random.Random(2)
    assert len({retry.backoff_s(4, rng=rng) for _ in range(20)}) > 1  # lockstep retries were the bug


def test_sleep_backoff_sleeps_the_returned_duration(monkeypatch):
    slept = []
    monkeypatch.setattr(retry.time, "sleep", slept.append)
    d = retry.sleep_backoff(3)
    assert slept == [d]


def test_sleep_backoff_annotates_only_storage_spans(monkeypatch):
    monkeypatch.setattr(retry.time, "sleep", lambda s: None)
    tracing.enable_tracing(None)
    try:
        with tracing.traced_span("storage.read") as s:
            a = retry.sleep_backoff(0)
            b = retry.sleep_backoff(1)
        with tracing.traced_span("stage.api_caption") as other:
            retry.sleep_backoff(0)
    finally:
        tracing.disable_tracing()
    assert s.attributes["attempt"] == 3 and s.attributes["backoff_s"] == round(round(a, 4) + b, 4)
    assert "attempt" not in other.attributes


# -- host utilities ----------------------------------------------------------------


def test_user_config_sections_match_jax(tmp_path, monkeypatch):
    cfg = tmp_path / "config.yaml"
    cfg.write_text("s3:\n  access_key_id: k\n  region: eu-west-1\n  endpoint_url: http://127.0.0.1:9\n"
                   "azure: not-a-mapping\n")
    monkeypatch.setenv("CURATE_CONFIG_PATH", str(cfg))
    j_user_config.load_user_config.cache_clear()
    try:
        for name in ("s3", "azure", "gcs"):
            assert user_config.get_section(name) == j_user_config.get_section(name)
        assert user_config.s3_session_kwargs() == j_user_config.s3_session_kwargs() == {
            "aws_access_key_id": "k", "region_name": "eu-west-1", "endpoint_url": "http://127.0.0.1:9"}
        cfg.write_text("- a list, not a mapping\n")
        user_config.load_user_config.cache_clear()
        assert user_config.load_user_config() == {}
    finally:
        j_user_config.load_user_config.cache_clear()


def test_user_config_reads_no_yaml_without_a_file(tmp_path, monkeypatch):
    """``yaml`` is imported only when the config file exists."""
    import subprocess

    script = ("import sys; from cosmos_curate_tpu_torch.utils import user_config as u; "
              "assert u.load_user_config() == {}; print('yaml' in sys.modules)")
    env = {"CURATE_CONFIG_PATH": str(tmp_path / "absent.yaml"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True, text=True, timeout=60,
                         cwd=str(Path(__file__).resolve().parents[1]))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


@pytest.mark.parametrize("fails", [0, 2, 3])
def test_retry_decorator_matches_jax(fails, monkeypatch):
    for mod in (retry_utils, jretry_utils):
        monkeypatch.setattr(mod.time, "sleep", lambda s: None)
    outcomes = []
    for mod in (retry_utils, jretry_utils):
        calls = []

        @mod.retry(attempts=3, backoff_s=0.01, exceptions=(ValueError,))
        def flaky():
            calls.append(1)
            if len(calls) <= fails:
                raise ValueError(len(calls))
            return len(calls)

        try:
            outcomes.append(("ok", flaky(), len(calls)))
        except ValueError as e:
            outcomes.append(("raised", e.args, len(calls)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0] == (("raised", (3,), 3) if fails == 3 else ("ok", fails + 1, fails + 1))


def _hold_lock(path: str, held: multiprocessing.Event, release: multiprocessing.Event) -> None:
    with file_lock.file_lock(path):
        held.set()
        release.wait(30)


def test_file_lock_excludes_other_processes(tmp_path):
    lock = str(tmp_path / "locks" / ".lock")
    ctx = multiprocessing.get_context("spawn")
    held, release = ctx.Event(), ctx.Event()
    proc = ctx.Process(target=_hold_lock, args=(lock, held, release))
    proc.start()
    try:
        assert held.wait(60)
        with pytest.raises(TimeoutError):
            with file_lock.file_lock(lock, timeout_s=0.2):
                pass
    finally:
        release.set()
        proc.join(60)
    assert not proc.is_alive() and proc.exitcode == 0
    t0 = time.monotonic()
    with file_lock.file_lock(lock, timeout_s=5):
        pass
    assert time.monotonic() - t0 < 5


def test_file_lock_serialises_threads(tmp_path):
    lock, counter, seen = str(tmp_path / ".lock"), [0], []

    def bump():
        for _ in range(20):
            with file_lock.file_lock(lock):
                v = counter[0]
                time.sleep(0.0005)
                counter[0] = v + 1
                seen.append(v)

    threads = [threading.Thread(target=bump) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert counter[0] == 80 and sorted(seen) == list(range(80))
