"""Port parity: the Azure Blob REST backend (``storage/azure_rest.py`` and
``storage/azure_shared_key.py``) against ``tests/storage/fake_azure.py``,
the fake the JAX package's backend is held to. The fake recomputes every
Shared Key signature and answers a wrong one with 403. The cases are the
JAX file's (``tests/storage/test_azure_rest.py``); the cross-package cases
write a blob through one package's client and read it back byte-equal
through the other's, the block-list case included."""

from __future__ import annotations

import base64
import unittest.mock

import pytest

import cosmos_curate_tpu.storage.azure_rest as j_azure_rest
import cosmos_curate_tpu_torch.storage.azure_rest as azure_rest
from cosmos_curate_tpu_torch import chaos
from cosmos_curate_tpu_torch.storage import client as storage_client
from cosmos_curate_tpu_torch.storage.azure_rest import AzureError, AzureRestClient
from tests.storage.fake_azure import TEST_ACCOUNT, TEST_KEY, FakeAzureServer


@pytest.fixture()
def server():
    with FakeAzureServer() as srv:
        yield srv


def _client(server, cls=AzureRestClient, key=TEST_KEY):
    return cls(account_name=TEST_ACCOUNT, account_key=key, endpoint_url=server.endpoint)


@pytest.fixture()
def client(server):
    return _client(server)


def test_round_trip(client, server):
    client.write_bytes("az://cont/a/b.txt", b"hello azure")
    assert client.read_bytes("az://cont/a/b.txt") == b"hello azure"
    assert client.exists("az://cont/a/b.txt")
    assert not client.exists("az://cont/a/missing.txt")
    assert client.size("az://cont/a/b.txt") == 11
    client.delete("az://cont/a/b.txt")
    assert not client.exists("az://cont/a/b.txt")
    assert not server.state.auth_failures


@pytest.mark.parametrize("blob", ["clip 01.mp4", "a+b/c%d.mp4", "vidéo/東京 (1).mp4"])
def test_names_that_need_encoding_are_signed_as_sent(client, server, blob):
    client.write_bytes(f"az://cont/{blob}", b"v")
    assert client.read_bytes(f"az://cont/{blob}") == b"v"
    assert [i.path for i in client.list_files("az://cont/")] == [f"az://cont/{blob}"]
    assert not server.state.auth_failures


def test_read_missing_raises(client):
    with pytest.raises(FileNotFoundError):
        client.read_bytes("az://cont/nope")


def test_empty_object_write(client):
    """A zero-byte marker carries Content-Length: 0 (Azure answers 411
    without it)."""
    client.write_bytes("az://cont/marker", b"")
    assert client.read_bytes("az://cont/marker") == b""
    assert client.size("az://cont/marker") == 0


def test_ranged_read(client):
    client.write_bytes("az://cont/r.bin", bytes(range(100)))
    assert client.read_range("az://cont/r.bin", 10, 19) == bytes(range(10, 20))


def test_list_pagination_and_suffix_filter(client):
    for i in range(25):
        client.write_bytes(f"az://cont/pre/f{i:03d}.mp4", b"x" * i)
    client.write_bytes("az://cont/pre/skip.txt", b"t")
    client.write_bytes("az://cont/other/g.mp4", b"y")
    orig = AzureRestClient._request

    def small_pages(self, method, container, blob, *, query=None, **kw):
        if query and query.get("maxresults"):
            query = dict(query, maxresults="10")
        return orig(self, method, container, blob, query=query, **kw)

    with unittest.mock.patch.object(AzureRestClient, "_request", small_pages):
        infos = list(client.list_files("az://cont/pre/", suffixes=(".mp4",)))
    assert len(infos) == 25
    assert infos[0].path == "az://cont/pre/f000.mp4"
    assert infos[3].size == 3


@pytest.mark.parametrize("status", [503, 429])
def test_retry_on_transient_status(client, server, status):
    server.state.fail_status = status
    server.state.fail_next = 2
    client.write_bytes("az://cont/retry.bin", b"ok")
    assert client.read_bytes("az://cont/retry.bin") == b"ok"
    assert server.state.fail_next == 0


def test_forbidden_fails_fast(client, server):
    server.state.fail_status = 403
    server.state.fail_next = 2
    with pytest.raises(AzureError) as ei:
        client.write_bytes("az://cont/x.bin", b"data")
    assert ei.value.status == 403 and server.state.fail_next == 1


def test_chaos_injected_storage_fault_is_retried(client):
    chaos.install(chaos.FaultPlan(rules=(chaos.FaultRule(site=chaos.SITE_STORAGE_REQUEST, kind="error", count=2),)))
    try:
        client.write_bytes("az://cont/chaos.bin", b"ok")
        assert client.read_bytes("az://cont/chaos.bin") == b"ok"
        assert chaos.fire_count(chaos.SITE_STORAGE_REQUEST) == 2
    finally:
        chaos.uninstall()


def test_block_list_upload(client, server, monkeypatch):
    monkeypatch.setattr(azure_rest, "BLOCK_THRESHOLD", 1024)
    monkeypatch.setattr(azure_rest, "BLOCK_CHUNK", 400)
    data = bytes(i % 251 for i in range(2500))
    client.write_bytes("az://cont/big.bin", data)
    assert client.read_bytes("az://cont/big.bin") == data
    assert not server.state.blocks  # the committed block list is cleaned up


def test_storage_dispatch_constructs_azure_client(server, monkeypatch):
    monkeypatch.setenv("AZURE_STORAGE_ACCOUNT", TEST_ACCOUNT)
    monkeypatch.setenv("AZURE_STORAGE_KEY", TEST_KEY)
    monkeypatch.setenv("AZURE_STORAGE_ENDPOINT", server.endpoint)
    c = storage_client.get_storage_client("az://cont/x")
    assert isinstance(c, AzureRestClient)
    c.write_bytes("az://cont/x", b"dispatch")
    assert storage_client.read_bytes("az://cont/x") == b"dispatch"


def test_bad_key_rejected(server):
    bad = _client(server, key=base64.b64encode(b"WRONG").decode())
    with pytest.raises(AzureError) as ei:
        bad.write_bytes("az://cont/x.bin", b"data")
    assert ei.value.status == 403
    with pytest.raises(AzureError) as ei2:
        bad.exists("az://cont/x.bin")
    assert ei2.value.status == 403
    assert server.state.auth_failures


def test_signature_bug_is_caught_by_the_fake(client, server, monkeypatch):
    """A canonicalisation bug (a query parameter left out of the signed
    resource) is refused."""
    real = azure_rest.sign_request

    def drops_query(**kw):
        return real(**{**kw, "query": {}})

    monkeypatch.setattr(azure_rest, "sign_request", drops_query)
    with pytest.raises(AzureError) as ei:
        list(client.list_files("az://cont/"))
    assert ei.value.status == 403 and server.state.auth_failures


def test_sas_auth_skips_signing(server):
    server.state.verify_signatures = False
    c = AzureRestClient(account_name=TEST_ACCOUNT, sas_token="?sv=2021-08-06&sig=testsig",
                        endpoint_url=server.endpoint)
    c.write_bytes("az://cont/sas.txt", b"via sas")
    assert c.read_bytes("az://cont/sas.txt") == b"via sas"


def test_missing_credentials_raise(monkeypatch):
    for var in ("AZURE_STORAGE_ACCOUNT", "AZURE_STORAGE_KEY", "AZURE_STORAGE_SAS_TOKEN", "AZURE_STORAGE_ENDPOINT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="account"):
        AzureRestClient()
    with pytest.raises(RuntimeError, match="credentials"):
        AzureRestClient(account_name="acct")
    # dispatch: a gated client naming what is missing, never a local read
    with pytest.raises(RuntimeError, match="az:// storage unavailable: az:// access needs an account"):
        storage_client.get_storage_client("az://cont/x")


def test_non_recursive_list(client):
    client.write_bytes("az://cont/top/a.mp4", b"1")
    client.write_bytes("az://cont/top/sub/b.mp4", b"2")
    assert [i.path for i in client.list_files("az://cont/top/", recursive=False)] == ["az://cont/top/a.mp4"]


def test_signed_headers_equal_the_reference():
    """One request, signed by both packages at one instant, carries the
    same Authorization header."""
    from cosmos_curate_tpu.storage import azure_shared_key as j_sk
    from cosmos_curate_tpu_torch.storage import azure_shared_key as sk

    kw = dict(method="PUT", account=TEST_ACCOUNT, path=f"/{TEST_ACCOUNT}/cont/a%20b.bin",
              query={"comp": "block", "blockid": "YmxvY2s="}, content_length=5,
              headers={"x-ms-date": "Sun, 18 Oct 2026 08:00:00 GMT", "content-type": "application/octet-stream"})
    assert sk.sign_request(**kw, creds=sk.AzureCredentials(TEST_ACCOUNT, TEST_KEY)) == j_sk.sign_request(
        **kw, creds=j_sk.AzureCredentials(TEST_ACCOUNT, TEST_KEY))


@pytest.mark.parametrize("size", [11, 2500])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_blobs_cross_between_the_packages(server, monkeypatch, writer, size):
    """A blob one package's client writes reads back byte-equal through the
    other's; 2500 bytes go up as a block list."""
    for mod in (azure_rest, j_azure_rest):
        monkeypatch.setattr(mod, "BLOCK_THRESHOLD", 1024)
        monkeypatch.setattr(mod, "BLOCK_CHUNK", 400)
    port, ref = _client(server), _client(server, j_azure_rest.AzureRestClient)
    w, r = (port, ref) if writer == "port" else (ref, port)
    data = bytes((7 * i) % 256 for i in range(size))
    w.write_bytes("az://cont/cross/obj.bin", data)
    assert r.read_bytes("az://cont/cross/obj.bin") == data
    assert r.read_range("az://cont/cross/obj.bin", 3, 9) == data[3:10]
    assert r.size("az://cont/cross/obj.bin") == size
    assert [i.path for i in r.list_files("az://cont/cross/")] == ["az://cont/cross/obj.bin"]
    assert not server.state.auth_failures
