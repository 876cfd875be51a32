"""Port parity: the zip transport (``storage/zip_transport.py``): the JAX
package's cases (``tests/storage/test_zip_transport.py``), the presigned
multipart upload against ``tests/storage/fake_s3.py``, archives byte-equal
to the JAX package's, and whole directories through ``s3://``, ``gs://`` and
``az://`` on the fakes, zipped by one package and extracted by the other."""

from __future__ import annotations

import io
import zipfile

import pytest

from cosmos_curate_tpu.storage import zip_transport as jzip
from cosmos_curate_tpu_torch.storage.zip_transport import (
    PresignedMultipart,
    download_and_extract,
    zip_and_upload_directory,
    zip_directory,
)
from tests.fixtures.object_stores import object_stores  # noqa: F401
from tests.storage.fake_s3 import FakeS3Server


def _tree(root):
    (root / "sub").mkdir(parents=True)
    (root / "a.txt").write_text("alpha")
    (root / "sub" / "b.bin").write_bytes(b"\x00\x01")
    return root


def test_roundtrip(tmp_path):
    src = _tree(tmp_path / "src")
    dest_zip = tmp_path / "out.zip"
    size = zip_and_upload_directory(src, str(dest_zip))
    assert size > 0 and dest_zip.exists()
    out = tmp_path / "extract"
    assert len(download_and_extract(str(dest_zip), out)) == 2
    assert (out / "a.txt").read_text() == "alpha"
    assert (out / "sub" / "b.bin").read_bytes() == b"\x00\x01"


def test_deterministic_and_equal_to_the_reference(tmp_path):
    src = _tree(tmp_path / "src")
    assert zip_directory(src) == zip_directory(src) == jzip.zip_directory(src)


def test_zip_slip_rejected(tmp_path):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("../evil.txt", "pwn")
    evil = tmp_path / "evil.zip"
    evil.write_bytes(buf.getvalue())
    with pytest.raises(ValueError, match="escapes"):
        download_and_extract(str(evil), tmp_path / "out")
    assert not (tmp_path / "evil.txt").exists()


def test_presigned_spec_from_dict():
    d = {"part_urls": ["http://h/p1", "http://h/p2"], "complete_url": "http://h/c", "part_size": 1024}
    assert PresignedMultipart.from_dict(d) == PresignedMultipart(**d)
    assert PresignedMultipart.from_dict(d).part_size == jzip.PresignedMultipart.from_dict(d).part_size


@pytest.mark.parametrize("scheme", ["s3", "gs", "az"])
@pytest.mark.parametrize("zipper", ["port", "jax"])
def test_directory_through_an_object_store(object_stores, tmp_path, scheme, zipper):  # noqa: F811
    """A directory zipped to ``<scheme>://`` by one package and extracted
    from there by the other, every file byte-equal."""
    src = _tree(tmp_path / "src")
    (src / "sub" / "big.bin").write_bytes(bytes(range(256)) * 64)
    root = {"s3": "s3://bkt", "gs": "gs://bkt", "az": "az://cont"}[scheme]
    up, down = (zip_and_upload_directory, jzip.download_and_extract) if zipper == "port" else (
        jzip.zip_and_upload_directory, download_and_extract)
    size = up(src, f"{root}/jobs/out.zip")
    files = down(f"{root}/jobs/out.zip", tmp_path / "extract")
    assert len(files) == 3 and size == len(jzip.zip_directory(src))
    for f in ("a.txt", "sub/b.bin", "sub/big.bin"):
        assert (tmp_path / "extract" / f).read_bytes() == (src / f).read_bytes()


class TestPresignedMultipart:
    """Presigned multipart upload against the fake S3 multipart handshake."""

    def _spec_and_server(self, n_parts, part_size):
        srv = FakeS3Server()
        srv.state.verify_signatures = False  # presigned URLs carry no signed headers
        srv.__enter__()
        # the submitter starts the upload and presigns a URL per part
        srv.state.next_upload += 1
        upload_id = f"up-{srv.state.next_upload}"
        srv.state.uploads[upload_id] = {}
        srv.state.upload_keys[upload_id] = ("bkt", "out.zip")
        base = f"{srv.endpoint}/bkt/out.zip"
        spec = PresignedMultipart(
            part_urls=[f"{base}?partNumber={i + 1}&uploadId={upload_id}" for i in range(n_parts)],
            complete_url=f"{base}?uploadId={upload_id}", abort_url=f"{base}?uploadId={upload_id}",
            part_size=part_size)
        return srv, spec

    def test_three_part_upload_with_injected_failure(self, tmp_path):
        src = tmp_path / "src"
        src.mkdir()
        (src / "big.bin").write_bytes(bytes(range(256)) * 300)
        srv, spec = self._spec_and_server(n_parts=8, part_size=16 * 1024)
        try:
            srv.state.fail_next = 1  # the first part's PUT gets a 503 and is retried
            size = zip_and_upload_directory(src, spec)
            assert size > 2 * spec.part_size, "the fixture must exceed 2 parts"
            obj = srv.state.objects[("bkt", "out.zip")]
            assert len(obj) == size and obj == jzip.zip_directory(src)
            up = tmp_path / "up.zip"
            up.write_bytes(obj)
            download_and_extract(str(up), tmp_path / "extract")
            assert (tmp_path / "extract" / "big.bin").read_bytes() == bytes(range(256)) * 300
        finally:
            srv.__exit__()

    def test_too_few_part_urls_rejected(self, tmp_path):
        src = tmp_path / "src"
        src.mkdir()
        (src / "a.bin").write_bytes(bytes(range(256)) * 200)
        spec = PresignedMultipart(part_urls=["http://invalid/p1"], complete_url="http://invalid/c", part_size=1024)
        with pytest.raises(ValueError, match="part URLs"):
            zip_and_upload_directory(src, spec)

    def test_abort_on_completion_failure(self, tmp_path):
        src = tmp_path / "src"
        src.mkdir()
        (src / "a.bin").write_bytes(bytes(range(256)) * 200)
        srv, spec = self._spec_and_server(n_parts=8, part_size=16 * 1024)
        try:
            spec.complete_url = f"{srv.endpoint}/bkt/out.zip"  # a POST the fake refuses with 400
            with pytest.raises(RuntimeError):
                zip_and_upload_directory(src, spec)
            assert not srv.state.uploads, "the abort must clear the pending upload"
            assert ("bkt", "out.zip") not in srv.state.objects
        finally:
            srv.__exit__()
