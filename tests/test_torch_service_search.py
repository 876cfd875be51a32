"""Port parity: ``POST /v1/search`` (``service/search.py``), the scenarios of
``tests/service/test_search_endpoint.py`` through both packages' apps.

One index is built from the same embeddings through each package (k-means
given the JAX package's first pick, so the clusters agree); the two
services answer the same clip and uuid queries with the same hits (ids in
order, similarities within 1e-5, a near-tie within it may swap), the same
statuses for malformed bodies, the same provenance refusal of text search,
the same 429 + Retry-After from the search lane and the same 503 without an
index. Text queries use each package's own seeded text tower, so the port's
answer is held to its ``IndexServer`` queried directly. The standalone
``build_search_app`` (``index serve``) answers as the JAX one does, and a
search server asked for the card on a host without one refuses to start.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest

from cosmos_curate_tpu.dedup import corpus_index as jci
from cosmos_curate_tpu_torch.dedup import corpus_index as tci
from tests.fixtures.service_harness import PACKAGES, Service, config, masked, package
from tests.test_torch_dedup import jax_first  # noqa: F401  (fixture)

PKGS = [package(name) for name in PACKAGES]
JAX, PORT = PKGS
DIM = 16  # clip-text-tiny-test's projection width
K = 4
ATOL = 1e-5


@pytest.fixture
def corpus(rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    centers = rng.standard_normal((K, DIM)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    vecs = np.concatenate([c + 0.05 * rng.standard_normal((20, DIM)) for c in centers]).astype(np.float32)
    return [f"c{i}" for i in range(len(vecs))], vecs


@pytest.fixture
def index_roots(tmp_path, corpus, jax_first):  # noqa: F811
    ids, vecs = corpus
    roots = {JAX.name: str(tmp_path / "idx_jax"), PORT.name: str(tmp_path / "idx_torch")}
    jci.CorpusIndex.build(roots[JAX.name], ids, vecs, model="m", k=K)
    tci.CorpusIndex.build(roots[PORT.name], ids, vecs, model="m", k=K, device="cpu")
    return roots


def _search_cfg(pkg, root, **kw):
    if pkg is PORT:
        kw.setdefault("device", "cpu")
    return pkg.search.SearchConfig(index_path=root, **kw)


def same_answer(got: list, want: list, atol: float = ATOL) -> bool:
    """Equal hit lists ([{"clip_uuid", "score"}]): similarities within
    ``atol`` position by position, the same ids, except that a near-tie
    may swap or, at the last place, differ."""
    got = [(h["clip_uuid"], h["score"]) for h in got]
    want = [(h["clip_uuid"], h["score"]) for h in want]
    if len(got) != len(want) or not np.allclose([s for _, s in got], [s for _, s in want], rtol=0, atol=atol):
        return False
    w_sim_of = dict(want)
    for i, ((g_id, g_sim), (w_id, _)) in enumerate(zip(got, want, strict=True)):
        if g_id != w_id and not (g_id in w_sim_of and abs(w_sim_of[g_id] - g_sim) <= atol) and i != len(got) - 1:
            return False
    return True


def both(tmp_path, index_roots, scenario, search_kw=None):
    """``scenario(svc)`` against each package's service with search over its
    own copy of the index; returns the (jax, port) transcripts, masked."""
    outs = []
    for pkg in PKGS:
        root = tmp_path / f"svc_{pkg.name}"
        svc = Service(pkg, root, config=config(pkg), search_config=_search_cfg(
            pkg, index_roots[pkg.name], **{"text_model": "clip-text-tiny-test", "batch_window_s": 0.001,
                                          **(search_kw or {})}))
        try:
            outs.append(masked(scenario(svc), root))
        finally:
            svc.close()
    return outs


class TestSearchEndpoint:
    def test_clip_search(self, tmp_path, index_roots, corpus):
        _ids, vecs = corpus

        def scenario(svc):
            return [svc.req("POST", "/v1/search", json={"embedding": [float(v) for v in vecs[i]], "top_k": 5})[:2]
                    for i in (3, 17, 42, 79)]

        jax_out, port_out = both(tmp_path, index_roots, scenario)
        for (js, jb), (ts, tb) in zip(jax_out, port_out, strict=True):
            assert ts == js == 200 and tb["mode"] == jb["mode"] == "clip" and tb["generation"] == jb["generation"] == 0
            assert same_answer(tb["results"], jb["results"]), (tb, jb)
        status, body = port_out[0]
        assert body["results"][0]["clip_uuid"] == "c3" and body["results"][0]["score"] == pytest.approx(1.0, abs=1e-4)
        assert len(body["results"]) == 5

    def test_uuid_search_and_404(self, tmp_path, index_roots):
        def scenario(svc):
            return [svc.req("POST", "/v1/search", json={"clip_uuid": "c7", "top_k": 3})[:2],
                    svc.req("POST", "/v1/search", json={"clip_uuid": "nope"})[:2]]

        jax_out, port_out = both(tmp_path, index_roots, scenario)
        assert port_out[0][0] == jax_out[0][0] == 200 and port_out[0][1]["mode"] == "uuid"
        assert same_answer(port_out[0][1]["results"], jax_out[0][1]["results"])
        assert port_out[0][1]["results"][0]["clip_uuid"] == "c7"
        assert port_out[1] == jax_out[1] and port_out[1][0] == 404

    def test_text_search_provenance_gate(self, tmp_path, index_roots, monkeypatch):
        from cosmos_curate_tpu_torch.dedup.index_server import IndexServer

        def scenario(svc):
            monkeypatch.delenv("CURATE_INDEX_ALLOW_RANDOM", raising=False)
            refused = svc.req("POST", "/v1/search", json={"text": "a red car"})[:2]
            monkeypatch.setenv("CURATE_INDEX_ALLOW_RANDOM", "1")
            answered = svc.req("POST", "/v1/search", json={"text": "a red car", "top_k": 4})[:2]
            return refused, answered

        jax_out, port_out = both(tmp_path, index_roots, scenario)
        # the refusal's words are the port's index server's (a colon where the reference has a dash)
        assert port_out[0][0] == jax_out[0][0] == 403
        assert "random" in port_out[0][1]["error"] and "random" in jax_out[0][1]["error"]
        assert port_out[1][0] == jax_out[1][0] == 200 and port_out[1][1]["mode"] == "text"
        assert len(port_out[1][1]["results"]) == len(jax_out[1][1]["results"]) == 4
        server = IndexServer(index_roots[PORT.name], device="cpu", text_model="clip-text-tiny-test")
        try:
            direct, _ = server.search(text="a red car", top_k=4)
        finally:
            server.close()
        assert same_answer(port_out[1][1]["results"], [{"clip_uuid": c, "score": s} for c, s in direct[0]])

    def test_validation(self, tmp_path, index_roots):
        bad = ({}, {"embedding": [1.0], "text": "x"}, {"embedding": "nope"}, {"embedding": []}, {"text": "   "},
               {"clip_uuid": 7}, {"embedding": [1.0] * DIM, "top_k": 0}, {"embedding": [1.0] * DIM, "top_k": "x"},
               {"embedding": [1.0] * DIM, "nprobe": -1}, {"embedding": [1.0] * DIM, "nprobe": 100000},
               {"embedding": [1.0] * (DIM + 1)})

        def scenario(svc):
            return ([svc.req("POST", "/v1/search", json=body)[:2] for body in bad]
                    + [svc.req("POST", "/v1/search", data=b"not json")[:2]])

        jax_out, port_out = both(tmp_path, index_roots, scenario)
        assert [s for s, _ in port_out] == [s for s, _ in jax_out] == [400] * 12
        # every refusal's message but the dimension check's (the two servers word it apart)
        assert [b for b in port_out[:-2]] == [b for b in jax_out[:-2]] and port_out[-1] == jax_out[-1]

    def test_health_carries_search_section(self, tmp_path, index_roots):
        def scenario(svc):
            health = svc.req("GET", "/health")[:2]
            stats = svc.req("GET", "/v1/search/stats")[:2]
            return health, stats

        jax_out, port_out = both(tmp_path, index_roots, scenario)
        for (status, body), _ in (port_out, jax_out):
            assert status == 200
        (_, tb), (_, ts) = port_out
        (_, jb), (_, js) = jax_out
        assert tb["search"]["enabled"] is jb["search"]["enabled"] is True
        assert tb["search"]["generation"] == jb["search"]["generation"] == tb["index_generation"] == 0
        assert tb["search"]["num_vectors"] == jb["search"]["num_vectors"] == 80
        assert set(tb["search"]) >= set(jb["search"]) - {"counts"}
        assert ts["cache"]["budget_bytes"] == js["cache"]["budget_bytes"] > 0

    def test_search_lane_sheds_independently(self, tmp_path, index_roots, corpus):
        """Lane at zero capacity: search sheds 429 + Retry-After while job
        submission still works, and the shed is counted."""
        _ids, vecs = corpus

        def scenario(svc):
            shed = svc.req("POST", "/v1/search", json={"embedding": [float(v) for v in vecs[0]]})
            job = svc.req("POST", "/v1/invoke", json={"pipeline": "split", "args": {}, "tenant": "t1"})[:2]
            svc.req("POST", f"/v1/terminate/{job[1]['job_id']}")
            return shed[0], shed[1], shed[2].get("Retry-After"), job[0], svc.app["search"].lane.shed_total

        jax_out, port_out = both(tmp_path, index_roots, scenario, {"max_inflight": 0, "max_waiting": 0})
        assert port_out == jax_out
        status, body, retry_after, job_status, shed_total = port_out
        assert status == 429 and retry_after and job_status == 200 and shed_total == 1

    def test_no_index_configured(self, tmp_path):
        def scenario(pkg):
            svc = Service(pkg, tmp_path / f"svc_{pkg.name}", config=config(pkg))
            try:
                return svc.req("POST", "/v1/search", data=b'{"text": "x"}')[0]
            except Exception:  # the 404 body is text, not JSON
                async def status():
                    resp = await svc.client.request("POST", "/v1/search", json={"text": "x"})
                    return resp.status

                return svc.loop.run_until_complete(status())
            finally:
                svc.close()

        assert [scenario(pkg) for pkg in PKGS] == [404, 404]

    def test_missing_index_dir_gives_503(self, tmp_path):
        outs = []
        for pkg in PKGS:
            svc = Service(pkg, tmp_path / f"svc_{pkg.name}", config=config(pkg),
                          search_config=_search_cfg(pkg, str(tmp_path / "no-such-index")))
            try:
                outs.append(svc.req("POST", "/v1/search", json={"text": "x"})[:2])
            finally:
                svc.close()
        assert outs[1] == outs[0] and outs[1][0] == 503


def _client(app):
    from aiohttp.test_utils import TestClient, TestServer

    async def make():
        client = TestClient(TestServer(app))
        try:
            await client.start_server()
        except BaseException:
            await client.close()
            raise
        return client

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(make()), loop
    except BaseException:
        loop.close()
        raise


def _req(client, loop, method, path, **kw):
    async def go():
        resp = await client.request(method, path, **kw)
        return resp.status, await resp.json()

    return loop.run_until_complete(go())


class TestStandaloneSearchApp:
    def test_index_serve_app(self, index_roots, corpus):
        _ids, vecs = corpus
        outs = []
        for pkg in PKGS:
            client, loop = _client(pkg.search.build_search_app(_search_cfg(pkg, index_roots[pkg.name])))
            try:
                outs.append((_req(client, loop, "GET", "/health"),
                             _req(client, loop, "POST", "/v1/search",
                                  json={"embedding": [float(v) for v in vecs[10]], "top_k": 3})))
            finally:
                loop.run_until_complete(client.close())
                loop.close()
        (jh, (js, jb)), (th, (ts, tb)) = outs
        assert th[0] == jh[0] == 200 and th[1]["status"] == jh[1]["status"] == "ok"
        assert ts == js == 200 and same_answer(tb["results"], jb["results"])
        assert tb["results"][0]["clip_uuid"] == "c10"

    def test_a_missing_card_refuses_to_start(self, index_roots):
        """``device="cuda"`` on a host without one: the app's startup raises
        (never a search answered from the CPU in its place)."""
        import torch

        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA device")
        app = PORT.search.build_search_app(PORT.search.SearchConfig(index_path=index_roots[PORT.name]))
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            _client(app)


class TestSearchLaneUnit:
    def test_acquire_release_and_retry_after(self):
        outs = []
        for pkg in PKGS:
            lane = pkg.search.SearchLane(pkg.search.SearchConfig(max_inflight=2, max_waiting=1, retry_after_s=2.0))
            steps = [lane.try_acquire() for _ in range(4)]
            shed, retry = lane.shed_total, lane.retry_after_s()
            lane.release()
            outs.append((steps, shed, retry, lane.try_acquire()))
        assert outs[1] == outs[0]
        steps, shed, retry, again = outs[1]
        assert steps == [True, True, True, False] and shed == 1 and retry >= 2.0 and again

    def test_search_config_is_the_reference_config_plus_device(self):
        import dataclasses

        port = {f.name: f.default for f in dataclasses.fields(PORT.search.SearchConfig)}
        assert port.pop("device") == "cuda"
        assert port == {f.name: f.default for f in dataclasses.fields(JAX.search.SearchConfig)}
