"""``POST /v1/search`` — the service surface of the index-server read path
(port of ``cosmos_curate_tpu/service/search.py``: the same routes, bodies
and status codes).

Similarity search over the corpus index (dedup/index_server.py) exposed
next to the job API (service/app.py), with its OWN admission lane: search
is an interactive workload with millisecond budgets, so it sheds under
its own quota (``max_inflight`` + ``max_waiting``, 429 + Retry-After)
completely independently of the job queue — a batch-job backlog can never
starve search, and a search herd can never eat job dispatch capacity.

Request body (exactly one of ``embedding`` / ``clip_uuid`` / ``text``):

    {"embedding": [...float, index dim], "top_k": 8, "nprobe": 0}
    {"clip_uuid": "<indexed clip id>", ...}
    {"text": "a red car at night", ...}        # CLIP text tower, provenance-gated

Response:

    {"mode": "clip|uuid|text", "generation": N,
     "results": [{"clip_uuid": ..., "score": ...}, ...],
     "latency_ms": 3.1}

``generation`` is the manifest generation that answered — queries running
concurrently with background compaction return generation-consistent
results (one snapshot per micro-batch, never a half-published manifest).
Errors: 400 malformed, 403 provenance-refused text search, 404 unknown
clip_uuid, 429 lane over capacity, 503 no index configured.

The index server's scoring products and the CLIP text tower run on
``SearchConfig.device`` ("cuda" unless the caller asks for the CPU; on the
card the text tower runs the flash kernel's causal branch). A search server
asked for a card on a host without one refuses to start: it never moves to
the CPU. The server (and with it torch) is imported only when a search
state starts, so a job service without an index does not load torch for it.
"""

from __future__ import annotations

import asyncio
import json
import time
from dataclasses import dataclass

from aiohttp import web

from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass(frozen=True)
class SearchConfig:
    """Knobs for the in-service index server (see `serve` / `index serve`
    CLI). ``index_path`` empty = search disabled."""

    index_path: str = ""
    # where the scoring products and the text tower run; never falls back
    device: str = "cuda"
    # admission lane: requests actively being served + waiting in the
    # micro-batch queue; beyond the sum, shed with 429
    max_inflight: int = 8
    max_waiting: int = 32
    retry_after_s: float = 1.0
    top_k_max: int = 64
    text_model: str = "clip-text-b-tpu"
    cache_bytes: int | None = None
    warmup: bool = True
    batch_window_s: float = 0.002
    max_batch: int = 64
    adopt_interval_s: float = 1.0
    # background compaction cadence; 0 disables the thread (use
    # `index compact` out of band instead)
    compact_interval_s: float = 0.0
    metrics_name: str = "index_server"


class SearchLane:
    """Search's own admission: a bounded in-flight + waiting counter,
    deliberately NOT the job AdmissionController — searches shed on their
    own quota so the two workloads degrade independently. Async-safe
    (driven from one event loop, like the job admission)."""

    def __init__(self, cfg: SearchConfig) -> None:
        self.cfg = cfg
        self.active = 0
        self.shed_total = 0

    def try_acquire(self) -> bool:
        if self.active >= self.cfg.max_inflight + self.cfg.max_waiting:
            self.shed_total += 1
            return False
        self.active += 1
        return True

    def release(self) -> None:
        self.active = max(0, self.active - 1)

    def retry_after_s(self) -> float:
        backlog = max(0, self.active - self.cfg.max_inflight)
        return round(
            self.cfg.retry_after_s * (1.0 + backlog / max(1, self.cfg.max_inflight)), 1
        )


class SearchState:
    """Owns the IndexServer + optional CompactionThread for one app."""

    def __init__(self, cfg: SearchConfig) -> None:
        self.cfg = cfg
        self.lane = SearchLane(cfg)
        self.server = None
        self.compactor = None

    def check_device(self) -> None:
        """Raise where the configured device is a card this host lacks."""
        from cosmos_curate_tpu_torch.core.model import model_device

        model_device(self.cfg.device, "the search server")

    def start(self) -> None:
        from cosmos_curate_tpu_torch.dedup.index_server import IndexServer

        self.server = IndexServer(
            self.cfg.index_path,
            device=self.cfg.device,
            cache_bytes=self.cfg.cache_bytes,
            warmup=self.cfg.warmup,
            text_model=self.cfg.text_model,
            metrics_name=self.cfg.metrics_name,
            batch_window_s=self.cfg.batch_window_s,
            max_batch=self.cfg.max_batch,
            adopt_interval_s=self.cfg.adopt_interval_s,
            gc_drained=self.cfg.compact_interval_s > 0,
        )
        if self.cfg.compact_interval_s > 0:
            from cosmos_curate_tpu_torch.dedup.compaction import CompactionThread

            self.compactor = CompactionThread(
                self.cfg.index_path,
                interval_s=self.cfg.compact_interval_s,
                device=self.cfg.device,
                metrics_name=f"{self.cfg.metrics_name}/compaction",
            )
            self.compactor.start()

    def stop(self) -> None:
        if self.compactor is not None:
            self.compactor.stop()
            self.compactor = None
        if self.server is not None:
            self.server.close()
            self.server = None

    def stats(self) -> dict:
        out = {
            "enabled": bool(self.server),
            "inflight": self.lane.active,
            "shed_total": self.lane.shed_total,
        }
        if self.server is not None:
            out.update(self.server.stats())
        if self.compactor is not None:
            out["compaction_passes"] = self.compactor.passes
        return out


def _shed_metric(name: str, reason: str) -> None:
    try:
        from cosmos_curate_tpu_torch.engine.metrics import get_metrics
        from cosmos_curate_tpu_torch.observability.stage_timer import record_search

        get_metrics().observe_search_shed(name, reason)
        record_search(name, shed=1)
    except Exception:
        logger.debug("search shed metric failed", exc_info=True)


def register_search_routes(app: web.Application, search: SearchState) -> None:
    """Mount ``POST /v1/search`` (+ ``GET /v1/search/stats``) on ``app``.
    The IndexServer starts on app startup (after the event loop exists)
    and closes on cleanup."""

    async def _start(app: web.Application) -> None:
        # a card asked for and missing fails the app's startup: the search
        # never answers from the CPU in its place
        search.check_device()
        try:
            search.start()
            logger.info(
                "search serving index at %s (generation %d, %d vectors)",
                search.cfg.index_path,
                search.server.generation,
                search.server.stats()["num_vectors"],
            )
        except Exception:
            # the job service must still come up when the index is absent
            # or unreadable (missing dir, corrupt manifest pointer, ...);
            # /v1/search answers 503 until an index exists and the service
            # restarts — a read-path artifact must never take down the
            # job queue
            logger.exception("search disabled (index at %s unusable)", search.cfg.index_path)
            search.stop()

    async def _stop(app: web.Application) -> None:
        search.stop()

    async def handle_search(request: web.Request) -> web.Response:
        if search.server is None:
            return web.json_response(
                {"error": "no corpus index configured (serve --index-path)"},
                status=503,
            )
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return web.json_response({"error": "invalid JSON body"}, status=400)
        if not isinstance(body, dict):
            return web.json_response({"error": "body must be a JSON object"}, status=400)
        embedding = body.get("embedding")
        clip_uuid = body.get("clip_uuid")
        text = body.get("text")
        given = [x is not None for x in (embedding, clip_uuid, text)]
        if sum(given) != 1:
            return web.json_response(
                {"error": "exactly one of embedding/clip_uuid/text"}, status=400
            )
        if embedding is not None and (
            not isinstance(embedding, list)
            or not embedding
            or not all(isinstance(v, (int, float)) for v in embedding)
        ):
            return web.json_response(
                {"error": "embedding must be a non-empty list of numbers"}, status=400
            )
        if clip_uuid is not None and not isinstance(clip_uuid, str):
            return web.json_response({"error": "clip_uuid must be a string"}, status=400)
        if text is not None and (not isinstance(text, str) or not text.strip()):
            return web.json_response(
                {"error": "text must be a non-empty string"}, status=400
            )
        try:
            top_k = int(body.get("top_k", 8))
            nprobe = int(body.get("nprobe", 0))
        except (TypeError, ValueError):
            return web.json_response({"error": "top_k/nprobe must be ints"}, status=400)
        if not 1 <= top_k <= search.cfg.top_k_max:
            return web.json_response(
                {"error": f"top_k must be in [1, {search.cfg.top_k_max}]"}, status=400
            )
        if not 0 <= nprobe <= 4096:
            # 0 = the index default; a negative or absurd fan-out must not
            # fault the whole corpus through the warm cache
            return web.json_response(
                {"error": "nprobe must be in [0, 4096]"}, status=400
            )
        if not search.lane.try_acquire():
            retry = search.lane.retry_after_s()
            _shed_metric(search.cfg.metrics_name, "lane_full")
            return web.json_response(
                {"error": "search over capacity, retry later", "retry_after_s": retry},
                status=429,
                headers={"Retry-After": str(int(retry) or 1)},
            )
        t0 = time.monotonic()
        try:
            import numpy as np

            from cosmos_curate_tpu_torch.dedup.index_server import ProvenanceError

            loop = asyncio.get_running_loop()
            kwargs = {"top_k": top_k, "nprobe": nprobe or None}
            if embedding is not None:
                mode = "clip"
                vec = np.asarray(embedding, np.float32)
                call = lambda: search.server.search(vec, **kwargs)  # noqa: E731
            elif clip_uuid is not None:
                mode = "uuid"
                call = lambda: search.server.search(clip_uuid=clip_uuid, **kwargs)  # noqa: E731
            else:
                mode = "text"
                call = lambda: search.server.search(text=text, **kwargs)  # noqa: E731
            try:
                results, generation = await loop.run_in_executor(None, call)
            except ProvenanceError as e:
                return web.json_response({"error": str(e)}, status=403)
            except KeyError as e:
                return web.json_response({"error": str(e.args[0] if e.args else e)}, status=404)
            except ValueError as e:
                return web.json_response({"error": str(e)}, status=400)
            return web.json_response(
                {
                    "mode": mode,
                    "generation": generation,
                    "results": [
                        {"clip_uuid": cid, "score": score} for cid, score in results[0]
                    ],
                    "latency_ms": round((time.monotonic() - t0) * 1e3, 3),
                }
            )
        finally:
            search.lane.release()

    async def handle_stats(request: web.Request) -> web.Response:
        return web.json_response(search.stats())

    app.on_startup.append(_start)
    app.on_cleanup.append(_stop)
    app.router.add_post("/v1/search", handle_search)
    app.router.add_get("/v1/search/stats", handle_stats)


def build_search_app(cfg: SearchConfig) -> web.Application:
    """A standalone search-only app (the ``index serve`` CLI): /health +
    /v1/search, no job queue, no dispatcher."""
    app = web.Application()
    search = SearchState(cfg)
    app["search"] = search

    async def health(request: web.Request) -> web.Response:
        return web.json_response(
            {
                "status": "ok" if search.server is not None else "no-index",
                "search": search.stats(),
            }
        )

    app.router.add_get("/health", health)
    register_search_routes(app, search)
    return app


def serve_index(
    host: str = "0.0.0.0",
    port: int = 8081,
    cfg: SearchConfig | None = None,
) -> None:
    """Run the standalone index server until SIGTERM/SIGINT."""
    import signal

    config = cfg or SearchConfig()

    async def _main() -> None:
        app = build_search_app(config)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, host, port)
        await site.start()
        logger.info(
            "index server on %s:%d (index=%s)", host, port, config.index_path
        )
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        await runner.cleanup()

    asyncio.run(_main())
