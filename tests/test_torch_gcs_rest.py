"""Port parity: the GCS backends against ``tests/storage/fake_gcs.py``, the
fake the JAX package's are held to: the JSON-API REST backend
(``storage/gcs_rest.py``; the JAX file's cases, ``tests/storage/
test_gcs_rest.py``) and the ``google-cloud-storage`` one (``storage/gcs.py``;
``tests/storage/test_gcs_sdk.py``'s, through ``STORAGE_EMULATOR_HOST``),
and objects written by one package's client read back through the other's.

Every GCS client here is built with ``STORAGE_EMULATOR_HOST`` set or an
explicit host: without it the SDK looks for default credentials."""

from __future__ import annotations

import sys
import unittest.mock

import pytest

from cosmos_curate_tpu.storage.gcs_rest import GcsRestClient as JGcsRestClient
from cosmos_curate_tpu_torch.storage import client as storage_client
from cosmos_curate_tpu_torch.storage.gcs_rest import GcsError, GcsRestClient
from tests.storage.fake_gcs import FakeGcsServer


@pytest.fixture()
def server():
    with FakeGcsServer() as srv:
        yield srv


@pytest.fixture()
def client(server):
    return GcsRestClient(host=server.endpoint)


def test_round_trip(client):
    client.write_bytes("gs://bkt/dir/obj.bin", b"payload")
    assert client.read_bytes("gs://bkt/dir/obj.bin") == b"payload"
    assert client.exists("gs://bkt/dir/obj.bin")
    assert not client.exists("gs://bkt/dir/other.bin")
    client.delete("gs://bkt/dir/obj.bin")
    assert not client.exists("gs://bkt/dir/obj.bin")


def test_read_missing_raises(client):
    with pytest.raises(FileNotFoundError):
        client.read_bytes("gs://bkt/none")


def test_list_pagination(client):
    for i in range(12):
        client.write_bytes(f"gs://bkt/p/f{i:02d}.webp", b"z" * (i + 1))
    client.write_bytes("gs://bkt/q/out.webp", b"q")
    orig = GcsRestClient._request

    def small_pages(self, method, url, **kw):
        return orig(self, method, url.replace("maxResults=1000", "maxResults=5"), **kw)

    with unittest.mock.patch.object(GcsRestClient, "_request", small_pages):
        infos = list(client.list_files("gs://bkt/p/", suffixes=(".webp",)))
    assert len(infos) == 12
    assert infos[0].path == "gs://bkt/p/f00.webp"
    assert infos[0].size == 1


def test_dispatch_via_emulator_env(server, monkeypatch):
    """Without the SDK, ``gs://`` dispatch builds the REST client (this
    environment has google-cloud-storage: its absence is simulated)."""
    monkeypatch.setenv("STORAGE_EMULATOR_HOST", server.endpoint)
    monkeypatch.setitem(sys.modules, "google.cloud.storage", None)
    c = storage_client.get_storage_client("gs://bkt/obj")
    assert isinstance(c, GcsRestClient)
    c.write_bytes("gs://bkt/obj", b"emu")
    assert c.read_bytes("gs://bkt/obj") == b"emu"


def test_missing_token_is_gated(monkeypatch):
    """No token and no emulator: the REST backend refuses, and dispatch
    returns the gated client naming both ways out."""
    monkeypatch.delenv("STORAGE_EMULATOR_HOST", raising=False)
    monkeypatch.delenv("GCS_OAUTH_TOKEN", raising=False)
    monkeypatch.setitem(sys.modules, "google.cloud.storage", None)
    with pytest.raises(RuntimeError, match="OAuth token"):
        GcsRestClient()
    with pytest.raises(RuntimeError, match="gs:// storage unavailable: .*installing google-cloud-storage also works"):
        storage_client.get_storage_client("gs://bkt/obj")


def _flaky_transport(monkeypatch, status: int, times: int) -> list[int]:
    """The client's transport answers ``status`` ``times`` times, then
    passes through to the fake (which never fails on its own); the list
    holds the failures still to come."""
    import urllib.error

    from cosmos_curate_tpu_torch.storage import retry

    real = retry.urllib.request.urlopen
    left = [times]

    def flaky(req, timeout):
        if left[0]:
            left[0] -= 1
            raise urllib.error.HTTPError(req.full_url, status, "injected", {}, None)
        return real(req, timeout=timeout)

    monkeypatch.setattr(retry.urllib.request, "urlopen", flaky)
    return left


@pytest.mark.parametrize("status", [503, 429])
def test_retry_on_transient_status(client, status, monkeypatch):
    left = _flaky_transport(monkeypatch, status, 2)
    client.write_bytes("gs://bkt/retry.bin", b"ok")
    assert left == [0] and client.read_bytes("gs://bkt/retry.bin") == b"ok"


def test_forbidden_fails_fast(client, monkeypatch):
    left = _flaky_transport(monkeypatch, 403, 2)
    with pytest.raises(GcsError) as ei:
        client.write_bytes("gs://bkt/x.bin", b"data")
    assert ei.value.status == 403 and left == [1]


def test_non_recursive_list(client):
    client.write_bytes("gs://bkt/top/a.webp", b"1")
    client.write_bytes("gs://bkt/top/sub/b.webp", b"2")
    assert [i.path for i in client.list_files("gs://bkt/top/", recursive=False)] == ["gs://bkt/top/a.webp"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_objects_cross_between_the_packages(server, writer):
    port, ref = GcsRestClient(host=server.endpoint), JGcsRestClient(host=server.endpoint)
    w, r = (port, ref) if writer == "port" else (ref, port)
    data = bytes((7 * i) % 256 for i in range(3000))
    w.write_bytes("gs://bkt/cross/obj 1.bin", data)
    assert r.read_bytes("gs://bkt/cross/obj 1.bin") == data
    assert [(i.path, i.size) for i in r.list_files("gs://bkt/cross/")] == [("gs://bkt/cross/obj 1.bin", 3000)]


# -- the SDK backend -----------------------------------------------------------


@pytest.fixture()
def sdk_client(server, monkeypatch):
    pytest.importorskip("google.cloud.storage")
    monkeypatch.setenv("STORAGE_EMULATOR_HOST", server.endpoint)
    from cosmos_curate_tpu_torch.storage.gcs import GcsStorageClient

    return GcsStorageClient(project="test")


def test_sdk_round_trip(sdk_client):
    sdk_client.write_bytes("gs://bkt/a/b.bin", b"sdk payload")
    assert sdk_client.read_bytes("gs://bkt/a/b.bin") == b"sdk payload"
    assert sdk_client.exists("gs://bkt/a/b.bin")
    assert not sdk_client.exists("gs://bkt/a/nope.bin")
    sdk_client.delete("gs://bkt/a/b.bin")
    assert not sdk_client.exists("gs://bkt/a/b.bin")
    with pytest.raises(FileNotFoundError):
        sdk_client.read_bytes("gs://bkt/a/b.bin")


def test_sdk_list(sdk_client):
    for i in range(4):
        sdk_client.write_bytes(f"gs://bkt/l/f{i}.json", b"{}")
    infos = list(sdk_client.list_files("gs://bkt/l/", suffixes=(".json",)))
    assert [i.path for i in infos] == [f"gs://bkt/l/f{i}.json" for i in range(4)]


def test_sdk_is_chosen_where_it_imports(server, sdk_client):
    """The reference's order: the SDK where it imports, the REST backend
    only without it; both read the same objects."""
    from cosmos_curate_tpu_torch.storage.gcs import GcsStorageClient

    c = storage_client.get_storage_client("gs://bkt/x")
    assert isinstance(c, GcsStorageClient)
    c.write_bytes("gs://bkt/x", b"sdk")
    assert GcsRestClient(host=server.endpoint).read_bytes("gs://bkt/x") == b"sdk"
