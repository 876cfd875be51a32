"""Port parity: the S3 REST backend (``storage/s3_rest.py`` and
``storage/sigv4.py``) against ``tests/storage/fake_s3.py``, the fake the JAX
package's backend is held to. The fake recomputes every SigV4 signature and
answers a wrong one with 403, so each case also checks the port's signing.
The cases are the JAX file's (``tests/storage/test_s3_rest.py``); the
cross-package cases write an object through one package's client and read
it back byte-equal through the other's, the multipart case included."""

from __future__ import annotations

import sys
import unittest.mock

import pytest

import cosmos_curate_tpu.storage.s3_rest as j_s3_rest
import cosmos_curate_tpu_torch.storage.s3_rest as s3_rest
from cosmos_curate_tpu_torch import chaos
from cosmos_curate_tpu_torch.storage import client as storage_client
from cosmos_curate_tpu_torch.storage.s3_rest import S3Error, S3RestClient
from tests.storage.fake_s3 import TEST_ACCESS_KEY, TEST_SECRET_KEY, FakeS3Server


@pytest.fixture()
def server():
    with FakeS3Server() as srv:
        yield srv


def _client(server, cls=S3RestClient, secret=TEST_SECRET_KEY):
    return cls(access_key_id=TEST_ACCESS_KEY, secret_access_key=secret, region="us-east-1",
               endpoint_url=server.endpoint)


@pytest.fixture()
def client(server):
    return _client(server)


def test_round_trip(client, server):
    client.write_bytes("s3://bkt/a/b.txt", b"hello world")
    assert client.read_bytes("s3://bkt/a/b.txt") == b"hello world"
    assert client.exists("s3://bkt/a/b.txt")
    assert not client.exists("s3://bkt/a/missing.txt")
    assert client.size("s3://bkt/a/b.txt") == 11
    client.delete("s3://bkt/a/b.txt")
    assert not client.exists("s3://bkt/a/b.txt")
    assert not server.state.auth_failures


@pytest.mark.parametrize("key", ["clip 01.mp4", "a+b/c%d.mp4", "vidéo/東京 (1).mp4", "x~y_z-0.9.mp4"])
def test_keys_that_need_encoding_are_signed_as_sent(client, server, key):
    """Spaces, ``+``, ``%`` and non-ASCII names: the canonical URI the fake
    recomputes must equal the one the client signed."""
    client.write_bytes(f"s3://bkt/{key}", b"v")
    assert client.read_bytes(f"s3://bkt/{key}") == b"v"
    assert [i.path for i in client.list_files("s3://bkt/")] == [f"s3://bkt/{key}"]
    assert not server.state.auth_failures


def test_read_missing_raises(client):
    with pytest.raises(FileNotFoundError):
        client.read_bytes("s3://bkt/nope")


def test_ranged_read(client):
    client.write_bytes("s3://bkt/r.bin", bytes(range(100)))
    assert client.read_range("s3://bkt/r.bin", 10, 19) == bytes(range(10, 20))


def test_list_pagination_and_suffix_filter(client):
    for i in range(25):
        client.write_bytes(f"s3://bkt/pre/f{i:03d}.mp4", b"x" * i)
    client.write_bytes("s3://bkt/pre/skip.txt", b"t")
    client.write_bytes("s3://bkt/other/g.mp4", b"y")
    orig = S3RestClient._request

    def small_pages(self, method, bucket, key, *, query=None, **kw):
        if query and query.get("max-keys"):
            query = dict(query, **{"max-keys": "10"})
        return orig(self, method, bucket, key, query=query, **kw)

    with unittest.mock.patch.object(S3RestClient, "_request", small_pages):
        infos = list(client.list_files("s3://bkt/pre/", suffixes=(".mp4",)))
    assert len(infos) == 25
    assert infos[0].path == "s3://bkt/pre/f000.mp4"
    assert infos[3].size == 3


@pytest.mark.parametrize("status", [503, 429])
def test_retry_on_transient_status(client, server, status):
    server.state.fail_status = status
    server.state.fail_next = 2
    client.write_bytes("s3://bkt/retry.bin", b"ok")
    assert client.read_bytes("s3://bkt/retry.bin") == b"ok"
    assert server.state.fail_next == 0


def test_forbidden_fails_fast(client, server):
    """403 is not retried: one refused request, then S3Error."""
    server.state.fail_status = 403
    server.state.fail_next = 2
    with pytest.raises(S3Error) as ei:
        client.write_bytes("s3://bkt/x.bin", b"data")
    assert ei.value.status == 403 and server.state.fail_next == 1


@pytest.mark.parametrize("count", [2, None])
def test_chaos_injected_storage_fault(client, count):
    """An armed ``storage.request`` fault is retried like a network failure
    and surfaces once the attempts run out."""
    chaos.install(chaos.FaultPlan(rules=(chaos.FaultRule(site=chaos.SITE_STORAGE_REQUEST, kind="error",
                                                          **({"count": count} if count else {})),)))
    try:
        if count:
            client.write_bytes("s3://bkt/chaos.bin", b"ok")
            assert client.read_bytes("s3://bkt/chaos.bin") == b"ok"
            assert chaos.fire_count(chaos.SITE_STORAGE_REQUEST) == 2
        else:
            with pytest.raises(chaos.InjectedFault):
                client.read_bytes("s3://bkt/never.bin")
    finally:
        chaos.uninstall()


def test_multipart_upload(client, server, monkeypatch):
    monkeypatch.setattr(s3_rest, "MULTIPART_THRESHOLD", 1024)
    monkeypatch.setattr(s3_rest, "MULTIPART_CHUNK", 400)
    data = bytes(i % 251 for i in range(2500))
    client.write_bytes("s3://bkt/big.bin", data)
    assert client.read_bytes("s3://bkt/big.bin") == data
    assert not server.state.uploads  # the completed upload is cleaned up
    assert server.state.next_upload == 1


def test_failed_multipart_part_aborts_the_upload(client, server, monkeypatch):
    monkeypatch.setattr(s3_rest, "MULTIPART_THRESHOLD", 1024)
    monkeypatch.setattr(s3_rest, "MULTIPART_CHUNK", 400)
    server.state.fail_status = 400
    orig = S3RestClient._request

    def fail_part_two(self, method, bucket, key, *, query=None, **kw):
        if query and query.get("partNumber") == "2":
            server.state.fail_next = 1
        return orig(self, method, bucket, key, query=query, **kw)

    with unittest.mock.patch.object(S3RestClient, "_request", fail_part_two), pytest.raises(S3Error):
        client.write_bytes("s3://bkt/big.bin", bytes(2500))
    assert not server.state.uploads and ("bkt", "big.bin") not in server.state.objects


def test_storage_dispatch_uses_rest_fallback(server, monkeypatch):
    """``get_storage_client('s3://...')`` builds the REST client where boto3
    does not import and credentials are configured."""
    monkeypatch.setitem(sys.modules, "boto3", None)
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", TEST_ACCESS_KEY)
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", TEST_SECRET_KEY)
    monkeypatch.setenv("AWS_ENDPOINT_URL", server.endpoint)
    c = storage_client.get_storage_client("s3://bkt/x")
    assert isinstance(c, S3RestClient)
    c.write_bytes("s3://bkt/x", b"dispatch")
    assert storage_client.read_bytes("s3://bkt/x") == b"dispatch"


def test_bad_secret_rejected(server):
    """Signed with the wrong secret: 403, and ``exists`` surfaces it instead
    of reading it as absence."""
    bad = _client(server, secret="WRONG")
    with pytest.raises(S3Error) as ei:
        bad.write_bytes("s3://bkt/x.bin", b"data")
    assert ei.value.status == 403
    with pytest.raises(S3Error) as ei2:
        bad.exists("s3://bkt/x.bin")
    assert ei2.value.status == 403
    assert server.state.auth_failures


def test_signature_bug_is_caught_by_the_fake(client, server, monkeypatch):
    """A canonical-URI bug (the key signed without encoding) is refused."""
    import cosmos_curate_tpu_torch.storage.sigv4 as sigv4

    real = sigv4.sign_request

    def unencoded(**kw):
        return real(**{**kw, "path": kw["path"].replace("%20", " ")})

    monkeypatch.setattr(s3_rest, "sign_request", unencoded)
    with pytest.raises(S3Error) as ei:
        client.write_bytes("s3://bkt/a b.bin", b"data")
    assert ei.value.status == 403 and server.state.auth_failures


def test_endpoint_path_prefix_preserved():
    c = S3RestClient(access_key_id="k", secret_access_key="s", region="r",
                     endpoint_url="https://gw.example.com/minio")
    assert c._url_parts("bkt", "a/b.txt") == ("https", "gw.example.com", "/minio/bkt/a/b.txt")
    assert c._url_parts("bkt", "a/b.txt") == j_s3_rest.S3RestClient(
        access_key_id="k", secret_access_key="s", region="r", endpoint_url="https://gw.example.com/minio",
    )._url_parts("bkt", "a/b.txt")


def test_non_recursive_list(client):
    client.write_bytes("s3://bkt/top/a.mp4", b"1")
    client.write_bytes("s3://bkt/top/sub/b.mp4", b"2")
    assert [i.path for i in client.list_files("s3://bkt/top/", recursive=False)] == ["s3://bkt/top/a.mp4"]


def test_credentials_come_from_arguments_then_config_then_env(tmp_path, monkeypatch):
    """The reference's order (``s3_rest.py:70-80``), read by both packages
    from the same config file and environment."""
    from cosmos_curate_tpu.utils import user_config as j_user_config
    from cosmos_curate_tpu_torch.utils import user_config

    cfg = tmp_path / "config.yaml"
    cfg.write_text("s3:\n  access_key_id: from-config\n  secret_access_key: cfg-secret\n  region: eu-west-1\n")
    monkeypatch.setenv("CURATE_CONFIG_PATH", str(cfg))
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "from-env")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "env-secret")
    monkeypatch.setenv("AWS_DEFAULT_REGION", "us-west-2")
    user_config.load_user_config.cache_clear()
    j_user_config.load_user_config.cache_clear()
    try:
        for cls in (S3RestClient, j_s3_rest.S3RestClient):
            c = cls()
            assert (c._creds.access_key_id, c._creds.secret_access_key, c._region) == (
                "from-config", "cfg-secret", "eu-west-1")
            c = cls(access_key_id="arg", secret_access_key="arg-secret", region="ap-south-1")
            assert (c._creds.access_key_id, c._region) == ("arg", "ap-south-1")
        monkeypatch.delenv("CURATE_CONFIG_PATH")
        user_config.load_user_config.cache_clear()
        assert S3RestClient()._creds.access_key_id == "from-env"
        assert S3RestClient()._region == "us-west-2"
    finally:
        user_config.load_user_config.cache_clear()
        j_user_config.load_user_config.cache_clear()


@pytest.mark.parametrize("size", [11, 2500])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_objects_cross_between_the_packages(server, monkeypatch, writer, size):
    """An object one package's client writes reads back byte-equal through
    the other's, whole and ranged; 2500 bytes go up in multipart parts."""
    for mod in (s3_rest, j_s3_rest):
        monkeypatch.setattr(mod, "MULTIPART_THRESHOLD", 1024)
        monkeypatch.setattr(mod, "MULTIPART_CHUNK", 400)
    port, ref = _client(server), _client(server, j_s3_rest.S3RestClient)
    w, r = (port, ref) if writer == "port" else (ref, port)
    data = bytes((7 * i) % 256 for i in range(size))
    w.write_bytes("s3://bkt/cross/obj.bin", data)
    assert r.read_bytes("s3://bkt/cross/obj.bin") == data
    assert r.read_range("s3://bkt/cross/obj.bin", 3, 9) == data[3:10]
    assert r.size("s3://bkt/cross/obj.bin") == size
    assert [i.path for i in r.list_files("s3://bkt/cross/")] == ["s3://bkt/cross/obj.bin"]
    assert server.state.next_upload == (1 if size > 1024 else 0)
    assert not server.state.auth_failures
