"""Port parity: presigned-zip job I/O, the scenarios of
``tests/service/test_presigned_zip.py`` through both packages' services.

Inputs arrive as a GET-able zip and results leave as a PUT-able zip, no
storage credentials on either side. A ``split`` job (no model stage, so it
needs no card) runs in a real job child of each package's service: both
upload a zip of the same clip, meta and summary files (names compared with
the clip uuids and video record ids, which derive from each job's own
input path, masked). The service
refuses a remote output root with a zip URL, a zip URL that is not a
string and a multipart spec without parts, as the reference does; the job
child's program routes a multipart spec through ``PresignedMultipart``.
"""

from __future__ import annotations

import io
import re
import threading
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from tests.fixtures.media import make_scene_video
from tests.fixtures.service_harness import PACKAGES, Service, config, package

PKGS = [package(name) for name in PACKAGES]
JAX, PORT = PKGS
# clip uuids and video record ids derive from each job's own input path
UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}|\b[0-9a-f]{24}\b")


class _ZipHost:
    """Serves one zip on GET /input.zip; stores PUT /output.zip bodies."""

    def __init__(self, zip_bytes: bytes) -> None:
        self.zip_bytes = zip_bytes
        self.uploaded: bytes | None = None
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                self.send_response(200)
                self.send_header("content-length", str(len(outer.zip_bytes)))
                self.end_headers()
                self.wfile.write(outer.zip_bytes)

            def do_PUT(self):
                length = int(self.headers.get("content-length", 0))
                outer.uploaded = self.rfile.read(length)
                self.send_response(200)
                self.send_header("content-length", "0")
                self.end_headers()

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)

    @property
    def base(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._server.shutdown()
        self._server.server_close()


def test_presigned_zip_round_trip(tmp_path):
    vids = tmp_path / "zin"
    vids.mkdir()
    make_scene_video(vids / "v.mp4", scene_len_frames=24, num_scenes=1)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.write(vids / "v.mp4", "v.mp4")
    names = []
    for pkg in PKGS:
        with _ZipHost(buf.getvalue()) as host:
            svc = Service(pkg, tmp_path / pkg.name, config=config(pkg))
            try:
                job_id = svc.submit(args={"fixed_stride_len_s": 1.0, "min_clip_len_s": 0.5},
                                    input_zip_url=f"{host.base}/input.zip?sig=presigned",
                                    output_zip_url=f"{host.base}/output.zip?sig=presigned")
                svc.wait_state(job_id, "done", "failed", "dead_lettered", timeout=180)
                _, prog, _ = svc.req("GET", f"/v1/progress/{job_id}")
                log = svc.req("GET", f"/v1/logs/{job_id}?tail=30")[1]["lines"]
            finally:
                svc.close()
            assert prog["state"] == "done", log
            assert host.uploaded, "no output zip was PUT back"
            with zipfile.ZipFile(io.BytesIO(host.uploaded)) as z:
                names.append(sorted(UUID.sub("<uuid>", n) for n in z.namelist() if not n.startswith("report/")))
    assert names[1] == names[0]
    assert any(n.startswith("clips/") and n.endswith(".mp4") for n in names[1]), names[1]
    assert "summary.json" in names[1]


@pytest.mark.parametrize("body,needle", [
    ({"pipeline": "split", "args": {"output_path": "s3://bucket/out"}, "output_zip_url": "http://example.invalid/o.zip"},
     "local output_path"),
    ({"pipeline": "split", "args": {}, "input_zip_url": 42}, "zip urls must be strings"),
    ({"pipeline": "split", "args": {}, "output_zip_multipart": {"part_urls": []}}, "part_urls"),
], ids=["remote-output-path-with-zip-url", "zip-url-type", "multipart-spec"])
def test_invalid_zip_requests_rejected(body, needle, tmp_path):
    outs = []
    for pkg in PKGS:
        svc = Service(pkg, tmp_path / pkg.name, config=config(pkg))
        try:
            outs.append(svc.req("POST", "/v1/invoke", json=body)[:2])
        finally:
            svc.close()
    assert outs[1] == outs[0]
    assert outs[1][0] == 400 and needle in outs[1][1]["error"]


def test_multipart_spec_reaches_runner_code():
    code = PORT.app._runner_code("split", {}, "/tmp/s.json", work_dir="/tmp/w",
                                 output_zip_multipart={"part_urls": ["u1"], "complete_url": "c"})
    assert "PresignedMultipart.from_dict" in code and "cosmos_curate_tpu_torch.storage.zip_transport" in code
    compile(code, "<runner>", "exec")
