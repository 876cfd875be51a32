"""Port parity: the image caption-family stages (``pipelines/image/filters.py``
and ``ImageCaptionStage``) and the API caption stage
(``pipelines/image/api_caption.py``) on the CPU.

- The semantic filter, the classifier and the caption stage on
  ``tiny-test``, both packages loading ONE checkpoint written by the JAX
  registry (the pattern of ``test_torch_semantic_filter.py``), on the same
  decoded images: the bf16 logits of every compared greedy step within
  ``LOGIT_TOL`` under ``test_torch_engine.py``'s rule, and for every
  request compared to its end (at least one a stage) the same text,
  verdict, label and ``filtered_by``.
- ``parse_label`` and the verdict policies on an engine that answers fixed
  texts, in both packages.
- The three stages threaded on one ``SharedCaptionEngine``, all asking
  about the SAME paths (one ``request_id`` each) at once: every stage gets
  exactly its own answers.
- ``ImageApiCaptionStage`` of both packages against one local fake
  OpenAI-compatible server: byte-equal request bodies, equal captions,
  equal retry counts on a 503, and the same error keys on a 404, on an
  unreachable server and on a malformed 200.
- The retry policy (``storage/retry.py``) against the reference's.
"""

from __future__ import annotations

import json
import random
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import cv2
import numpy as np
import pytest

from cosmos_curate_tpu.models import registry as jregistry
from cosmos_curate_tpu.models.vlm import CaptionEngine as JEngine
from cosmos_curate_tpu.models.vlm import SharedCaptionEngine as JShared
from cosmos_curate_tpu.models.vlm import VLM_TINY_TEST as J_TINY
from cosmos_curate_tpu.pipelines.image import annotate as jann
from cosmos_curate_tpu.pipelines.image import api_caption as japi
from cosmos_curate_tpu.pipelines.image import filters as jfil
from cosmos_curate_tpu.storage import retry as jretry
from cosmos_curate_tpu_torch import chaos
from cosmos_curate_tpu_torch.models.vlm import VLM_TINY_TEST, SharedCaptionEngine
from cosmos_curate_tpu_torch.pipelines.image import annotate as tann
from cosmos_curate_tpu_torch.pipelines.image import api_caption as tapi
from cosmos_curate_tpu_torch.pipelines.image import filters as tfil
from cosmos_curate_tpu_torch.storage import retry as tretry
from tests.test_torch_engine import _record_logits
from tests.test_torch_semantic_filter import _compare

MODEL_ID = "caption-vlm-tpu"


@pytest.fixture(autouse=True)
def _fresh_registries():
    JShared.reset()
    SharedCaptionEngine.reset()
    yield
    JShared.reset()
    SharedCaptionEngine.reset()


@pytest.fixture
def checkpoint(tmp_path, monkeypatch):
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(tmp_path / "weights"))
    eng = JEngine(J_TINY, max_batch=2)
    # seed 0: each stage has at least one request on these images whose
    # greedy steps hold no near-tie, so its text is compared to its end
    eng.setup(0)
    jregistry.save_params(MODEL_ID, eng.params, root=tmp_path / "weights")
    eng.shutdown()


@pytest.fixture
def images(tmp_path) -> list[Path]:
    """Eight stills of different sizes and orientations, and one that does
    not decode."""
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate([(32, 48), (48, 32), (40, 40), (24, 64), (64, 24), (33, 47), (56, 56), (20, 30)]):
        paths.append(tmp_path / f"i{i}.jpg")
        cv2.imwrite(str(paths[-1]), rng.integers(0, 255, (h, w, 3), np.uint8))
    paths.append(tmp_path / "bad.png")
    paths[-1].write_bytes(b"not an image")
    return paths


def _loaded(mod, paths):
    return mod.ImageLoadStage().process_data([mod.ImageTask(path=str(p)) for p in paths])


def _drive(stage, tasks):
    stage.setup(None)
    trace = _record_logits(stage.model.engine)
    return trace, stage.process_data(tasks)


STAGES = {
    "semantic": lambda mod, cfg, **kw: mod.ImageSemanticFilterStage(cfg=cfg, max_batch=4, **kw),
    "classifier": lambda mod, cfg, **kw: mod.ImageClassifierStage(labels=("photo", "chart", "noise"), cfg=cfg,
                                                                  max_batch=4, **kw),
    "caption": lambda mod, cfg, **kw: mod.ImageCaptionStage(cfg=cfg, max_batch=4, max_new_tokens=16, **kw),
}


def _fields(t) -> tuple:
    return t.path, t.caption, t.label, t.semantic_pass, t.filtered_by


@pytest.mark.parametrize("name", list(STAGES))
def test_caption_family_stage_matches_jax(name, checkpoint, images):
    j_stage = STAGES[name](jfil if name != "caption" else jann, J_TINY)
    t_stage = STAGES[name](tfil if name != "caption" else tann, VLM_TINY_TEST, device="cpu")
    assert t_stage.max_new_tokens == {"semantic": 8, "classifier": 12, "caption": 16}[name]
    j_trace, j_out = _drive(j_stage, _loaded(jann, images))
    t_trace, t_out = _drive(t_stage, _loaded(tann, images))
    asked = [str(p) for p in images[:-1]]
    assert sorted(t_trace) == sorted(j_trace) == sorted(asked)
    # the seeded tiny model's logits near-tie often: every request's
    # comparison runs to its first near-tie, at least one step a request
    full, compared = _compare(j_trace, t_trace, asked)
    assert compared >= len(asked) and full, (compared, full)
    for j, t in zip(j_out, t_out, strict=True):
        if t.path in full:
            assert _fields(t) == _fields(j)
    assert t_out[-1].errors.keys() == {"load"} and _fields(t_out[-1]) == (str(images[-1]), "", "", None, "")


@pytest.mark.parametrize("text", ["photo", "  CHART ", "a photo of a chart", "this is clip art", "art", "gibberish",
                                  "", "clip", "Photograph"])
def test_parse_label_matches_jax(text):
    for labels in (("photo", "chart"), ("art", "clip art"), ("photo", "illustration", "screenshot", "document")):
        t = tfil.ImageClassifierStage(labels=labels, cfg=VLM_TINY_TEST, device="cpu")
        j = jfil.ImageClassifierStage(labels=labels, cfg=J_TINY)
        assert t.parse_label(text) == j.parse_label(text), (labels, text)
        assert t.prompt == j.prompt
    with pytest.raises(ValueError, match="non-empty"):
        tfil.ImageClassifierStage(labels=(), device="cpu")


class _Result:
    def __init__(self, rid, text):
        self.request_id, self.text = rid, text


class _AnsweringEngine:
    """An engine stand-in that answers each request with a fixed text."""

    def __init__(self, answers):
        self.answers, self.requests = answers, []

    def add_request(self, req):
        self.requests.append(req)

    def run_until_complete(self, owner=None):
        return [_Result(r.request_id, self.answers[i % len(self.answers)]) for i, r in enumerate(self.requests)]


@pytest.mark.parametrize("score_only", [False, True])
@pytest.mark.parametrize("keep_on_unparseable", [True, False])
def test_verdict_policies_match_jax(score_only, keep_on_unparseable, images):
    """Each verdict's effect, in both packages, on an engine that answers
    "Yes.", "no" and "the sky" in turn; an image already filtered, and one
    without pixels, are not asked."""
    results = []
    for fmod, amod, cfg, kw in ((jfil, jann, J_TINY, {}), (tfil, tann, VLM_TINY_TEST, {"device": "cpu"})):
        stage = fmod.ImageSemanticFilterStage(cfg=cfg, score_only=score_only, keep_on_unparseable=keep_on_unparseable,
                                              user_prompt="Is it a cat?", **kw)
        stage._model.engine = engine = _AnsweringEngine(("Yes.", "no", "the sky"))
        tasks = _loaded(amod, images) + _loaded(amod, images[:1])
        tasks[-1].filtered_by = "aesthetic"
        stage.process_data(tasks)
        results.append(([_fields(t) for t in tasks],
                        [(r.request_id, r.frames.shape, r.sampling.max_new_tokens, len(r.prompt_ids))
                         for r in engine.requests]))
    assert results[1] == results[0]
    fields, requests = results[1]
    assert len(requests) == 8 and all(n == 8 for _, _, n, _ in requests)
    dropped = 0 if score_only else 3 + (0 if keep_on_unparseable else 2)
    assert sum(f[4] == "semantic" for f in fields) == dropped


def test_three_owners_get_their_own_answers_on_one_engine(checkpoint, images):
    """The semantic filter, the classifier and the caption stage resolve one
    ``SharedCaptionEngine`` and ask about the SAME paths from three threads
    at once: each gets one answer per path, of its own request (its owner
    tag, its prompt's length, at most its token budget), and none of the
    others'."""
    stages = {name: make(tfil if name != "caption" else tann, VLM_TINY_TEST, device="cpu")
              for name, make in STAGES.items()}
    for stage in stages.values():
        stage.setup(None)
    engine = stages["caption"].model.engine
    assert all(s.model.engine is engine for s in stages.values())
    assert len({s.owner for s in stages.values()}) == 3
    got: dict[str, list] = {}
    prompts = {"semantic": stages["semantic"].prompt, "classifier": stages["classifier"].prompt,
               "caption": stages["caption"].prompt_text}
    run = engine.run_until_complete

    def recording(owner=None):
        results = run(owner=owner)
        name = next(n for n, s in stages.items() if s.owner == owner)
        got[name] = results
        return results

    engine.run_until_complete = recording
    tasks = {name: _loaded(tann, images) for name in stages}
    errors = []

    def drive(name):
        try:
            stages[name].process_data(tasks[name])
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=drive, args=(name,)) for name in stages]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    paths = sorted(str(p) for p in images[:-1])
    lengths = {name: len(stages[name].tokenizer.encode(p)) for name, p in prompts.items()}
    assert len(set(lengths.values())) == 3  # a result's prompt length names its stage
    for name, stage in stages.items():
        results = got[name]
        assert sorted(r.request_id for r in results) == paths, name
        assert {r.owner for r in results} == {stage.owner}
        assert {r.num_prompt_tokens for r in results} == {lengths[name]}, name
        assert all(r.num_output_tokens <= stage.max_new_tokens for r in results)
    assert all(t.semantic_pass in (True, False, None) for t in tasks["semantic"][:-1])
    assert all(t.label in ("photo", "chart", "noise", "unknown") for t in tasks["classifier"][:-1])
    texts = {r.request_id: r.text for r in got["caption"]}
    assert [t.caption for t in tasks["caption"][:-1]] == [texts[str(p)] for p in images[:-1]]


# -- the API caption stage -----------------------------------------------------


class FakeOpenAI:
    """A local OpenAI-compatible chat endpoint: records each request's path,
    authorization and raw body; answers ``fail_first`` requests with
    ``fail_status``, then with a caption naming the body's image URL length
    (``malformed``: an empty ``choices`` list)."""

    def __init__(self, *, fail_first: int = 0, fail_status: int = 503, malformed: bool = False) -> None:
        self.requests: list[dict] = []
        self.fail_first, self.fail_status, self.malformed = fail_first, fail_status, malformed
        self.lock = threading.Lock()
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):  # noqa: N802
                raw = self.rfile.read(int(self.headers.get("content-length", "0")))
                with srv.lock:
                    srv.requests.append({"path": self.path, "auth": self.headers.get("authorization"), "raw": raw})
                    fail = srv.fail_first > 0
                    srv.fail_first -= fail
                if fail:
                    self.send_response(srv.fail_status)
                    self.end_headers()
                    return
                body = json.loads(raw)
                n = len(body["messages"][0]["content"][1]["image_url"]["url"])
                reply = {"choices": []} if srv.malformed else {
                    "choices": [{"message": {"content": f" a synthetic image ({n} b64 chars) "}}]}
                data = json.dumps(reply).encode()
                self.send_response(200)
                self.send_header("content-length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)

    @property
    def endpoint(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._server.shutdown()
        self._server.server_close()


@pytest.fixture
def api_images(tmp_path) -> list[Path]:
    rng = np.random.default_rng(1)
    paths = []
    for ext in (".jpg", ".png", ".webp", ".bmp", ".JPEG"):
        paths.append(tmp_path / f"a{len(paths)}{ext}")
        ok, buf = cv2.imencode(ext.lower(), rng.integers(0, 255, (16, 24, 3), np.uint8))
        paths[-1].write_bytes(buf.tobytes())
    return paths


def _api_run(mod, amod, paths, **kw):
    tasks = _loaded(amod, paths)
    tasks[0].filtered_by = "semantic"  # not sent
    return mod.ImageApiCaptionStage(**kw).process_data(tasks)


@pytest.mark.parametrize("suffix", ["", "/", "/v1", "/v1/"])
def test_api_caption_matches_jax_byte_for_byte(suffix, api_images):
    outs, bodies = [], []
    for mod, amod in ((japi, jann), (tapi, tann)):
        with FakeOpenAI() as api:
            outs.append([(t.path, t.caption, t.errors) for t in _api_run(
                mod, amod, api_images, base_url=api.endpoint + suffix, model="test-vlm", api_key="sk-test",
                concurrency=1)])
            bodies.append([(r["path"], r["auth"], r["raw"]) for r in api.requests])
    assert outs[1] == outs[0]
    assert bodies[1] == bodies[0] and len(bodies[1]) == 4
    assert all(p == "/v1/chat/completions" and a == "Bearer sk-test" for p, a, _ in bodies[1])
    media = [json.loads(raw)["messages"][0]["content"][1]["image_url"]["url"].split(";")[0] for _, _, raw in bodies[1]]
    assert media == ["data:image/png", "data:image/webp", "data:image/bmp", "data:image/jpeg"]
    assert all(c.startswith("a synthetic image") for _, c, _ in outs[1][1:]) and outs[1][0][1] == ""


def test_api_caption_retries_like_jax(api_images, monkeypatch):
    sleeps: dict[str, list] = {"jax": [], "port": []}
    monkeypatch.setattr(japi, "sleep_backoff", sleeps["jax"].append)
    monkeypatch.setattr(tapi, "sleep_backoff", sleeps["port"].append)
    counts = []
    for mod, amod in ((japi, jann), (tapi, tann)):
        with FakeOpenAI(fail_first=2) as api:
            out = _api_run(mod, amod, api_images[:2], base_url=api.endpoint, max_retries=3, concurrency=1)[1:]
            counts.append((len(api.requests), out[0].caption.startswith("a synthetic image"), out[0].errors))
    assert counts[1] == counts[0] == (3, True, {})
    assert sleeps["port"] == sleeps["jax"] == [0, 1]


@pytest.mark.parametrize("case", ["404", "unreachable", "malformed-200", "503-exhausted"])
def test_api_caption_errors_match_jax(case, api_images, monkeypatch):
    for mod in (japi, tapi):
        monkeypatch.setattr(mod, "sleep_backoff", lambda attempt: None)
    outs = []
    for mod, amod in ((japi, jann), (tapi, tann)):
        if case == "unreachable":
            out = _api_run(mod, amod, api_images[:3], base_url="http://127.0.0.1:1", max_retries=2, timeout_s=2,
                           concurrency=2)
            n = None
        else:
            kw = {"404": dict(fail_first=99, fail_status=404), "malformed-200": dict(malformed=True),
                  "503-exhausted": dict(fail_first=99)}[case]
            with FakeOpenAI(**kw) as api:
                out = _api_run(mod, amod, api_images[:3], base_url=api.endpoint, max_retries=3, concurrency=2)
                n = len(api.requests)
        outs.append(([(t.caption, t.errors.get("api_caption")) for t in out], n))
    assert outs[1] == outs[0]
    errors, n = outs[1]
    assert n == {"404": 2, "unreachable": None, "malformed-200": 6, "503-exhausted": 6}[case]
    kind = {"404": "HTTPError 404", "unreachable": "URLError", "malformed-200": "IndexError",
            "503-exhausted": "HTTPError 503"}[case]
    assert errors[0] == ("", None) and all(c == "" and kind in e for c, e in errors[1:]), errors


# -- the retry policy ----------------------------------------------------------


def test_retry_policy_matches_jax():
    assert tretry.RETRYABLE_STATUSES == jretry.RETRYABLE_STATUSES
    assert (tretry.DEFAULT_BASE_S, tretry.DEFAULT_CAP_S) == (jretry.DEFAULT_BASE_S, jretry.DEFAULT_CAP_S)
    for status in (200, 400, 404, 429, 500, 501, 502, 503, 504, 505):
        assert tretry.is_retryable_status(status) == jretry.is_retryable_status(status)
    for attempt in range(8):
        for kw in ({}, {"base": 0.5, "cap": 2.0}):
            assert tretry.backoff_s(attempt, rng=random.Random(attempt), **kw) == jretry.backoff_s(
                attempt, rng=random.Random(attempt), **kw)
            assert 0.0 <= tretry.backoff_s(attempt, **kw) <= min(kw.get("cap", 5.0), kw.get("base", 0.2) * 2**attempt)


def test_storage_request_chaos_site():
    from cosmos_curate_tpu import chaos as jchaos

    assert chaos.SITE_STORAGE_REQUEST == jchaos.SITE_STORAGE_REQUEST and chaos.SITE_STORAGE_REQUEST in chaos.ALL_SITES
    tretry.chaos_storage_fault()  # disarmed: a no-op
    chaos.install(chaos.FaultPlan(rules=(chaos.FaultRule(site=chaos.SITE_STORAGE_REQUEST, count=1),), seed=3))
    try:
        with pytest.raises(chaos.InjectedFault):
            tretry.chaos_storage_fault()
        tretry.chaos_storage_fault()  # its one firing is spent
        assert chaos.fire_count(chaos.SITE_STORAGE_REQUEST) == 1
    finally:
        chaos.uninstall()
