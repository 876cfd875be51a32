"""``cosmos-curate-tpu-torch serve``: run the durable multi-tenant job
service (port of ``cosmos_curate_tpu/cli/serve_cli.py``).

See docs/SERVICE.md for the API, tenancy/quota model, journal layout and
drain semantics. The defaults match :class:`ServiceConfig` /
:class:`QuotaConfig`; every admission knob is exposed so a deployment can
size quotas to its box without code changes. The reference's flags, plus
``--device``: where the search server (``--index-path``) scores and runs
its text tower. Jobs pick their own device in their ``args`` (``"device":
"cpu"``; without it a job runs on the card).
"""

from __future__ import annotations

import argparse


def register(sub: argparse._SubParsersAction) -> None:
    serve = sub.add_parser("serve", help="run the HTTP job service")
    serve.add_argument("--host", default="0.0.0.0")
    serve.add_argument("--port", type=int, default=8080)
    serve.add_argument(
        "--work-root", default="/tmp/curate_service",
        help="job work dirs + the crash-safe journal live here; restart "
        "against the same root to resume interrupted jobs",
    )
    serve.add_argument(
        "--max-concurrent", type=int, default=2,
        help="dispatcher cap (additionally clamped by host CPU/memory)",
    )
    serve.add_argument("--max-running-per-tenant", type=int, default=2)
    serve.add_argument("--max-queued-per-tenant", type=int, default=8)
    serve.add_argument("--max-queued-total", type=int, default=64)
    serve.add_argument(
        "--cpus-per-job", type=float, default=1.0,
        help="host-budget cost estimate per job (0 disables the CPU clamp)",
    )
    serve.add_argument(
        "--memory-gb-per-job", type=float, default=0.0,
        help="host-budget memory cost per job (0 disables the memory clamp)",
    )
    serve.add_argument(
        "--max-attempts", type=int, default=3,
        help="per-job retry budget before dead_lettered (request may lower it)",
    )
    serve.add_argument(
        "--drain-s", type=float, default=30.0,
        help="SIGTERM grace: running jobs get this long to finish before "
        "being checkpointed as interrupted for the next boot",
    )
    serve.add_argument(
        "--term-grace-s", type=float, default=5.0,
        help="terminate endpoint: SIGTERM → SIGKILL escalation window",
    )
    serve.add_argument(
        "--metrics-port", type=int, default=None,
        help="expose service_*/pipeline_* prometheus metrics on this port",
    )
    serve.add_argument(
        "--slo-queue-wait-s", type=float, default=0.0,
        help="per-tenant SLO: max pending->running wait before a breach "
        "(0 disables; breaches land in service_slo_breaches_total and "
        "GET /v1/slo)",
    )
    serve.add_argument(
        "--slo-run-duration-s", type=float, default=0.0,
        help="per-tenant SLO: max run duration for a successful job (0 "
        "disables)",
    )
    serve.add_argument(
        "--slo-success-rate", type=float, default=0.0,
        help="per-tenant SLO: min done-fraction over the rolling outcome "
        "window, in (0, 1] (0 disables)",
    )
    serve.add_argument(
        "--slo-window", type=int, default=100,
        help="rolling terminal-outcome window per tenant for the "
        "success-rate SLO",
    )
    serve.add_argument(
        "--index-path", default="",
        help="corpus index root: enables POST /v1/search (index-server "
        "read path with its own admission lane — see docs/SERVICE.md)",
    )
    serve.add_argument(
        "--search-max-inflight", type=int, default=8,
        help="search admission lane: requests actively served",
    )
    serve.add_argument(
        "--search-max-waiting", type=int, default=32,
        help="search admission lane: queued beyond inflight before 429",
    )
    serve.add_argument(
        "--search-text-model", default="clip-text-b-tpu",
        help="CLIP text tower for text-to-clip queries (provenance-gated)",
    )
    serve.add_argument(
        "--search-cache-mb", type=int, default=0,
        help="warm shard cache byte budget in MB (0 = "
        "CURATE_INDEX_CACHE_BYTES or the 256 MB default)",
    )
    serve.add_argument(
        "--compact-interval-s", type=float, default=0.0,
        help="background index compaction cadence (0 disables; readers "
        "adopt new generations between requests)",
    )
    serve.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where the search server runs with --index-path (default: cuda; "
        "never falls back to the CPU)",
    )
    serve.set_defaults(func=_cmd_serve)


def _cmd_serve(args: argparse.Namespace) -> int:
    from cosmos_curate_tpu_torch.service.admission import QuotaConfig
    from cosmos_curate_tpu_torch.service.app import ServiceConfig, serve
    from cosmos_curate_tpu_torch.service.slo import SloConfig

    config = ServiceConfig(
        slo=SloConfig(
            queue_wait_s=args.slo_queue_wait_s,
            run_duration_s=args.slo_run_duration_s,
            success_rate=args.slo_success_rate,
            window=args.slo_window,
        ),
        quota=QuotaConfig(
            max_concurrent_jobs=args.max_concurrent,
            max_running_per_tenant=args.max_running_per_tenant,
            max_queued_per_tenant=args.max_queued_per_tenant,
            max_queued_total=args.max_queued_total,
            cpus_per_job=args.cpus_per_job,
            memory_gb_per_job=args.memory_gb_per_job,
        ),
        max_attempts=args.max_attempts,
        drain_s=args.drain_s,
        term_grace_s=args.term_grace_s,
        metrics_port=args.metrics_port,
    )
    search_config = None
    if args.index_path:
        from cosmos_curate_tpu_torch.service.search import SearchConfig

        search_config = SearchConfig(
            index_path=args.index_path,
            device=args.device,
            max_inflight=args.search_max_inflight,
            max_waiting=args.search_max_waiting,
            text_model=args.search_text_model,
            cache_bytes=(args.search_cache_mb << 20) or None,
            compact_interval_s=args.compact_interval_s,
        )
    serve(
        host=args.host, port=args.port, work_root=args.work_root, config=config,
        search_config=search_config,
    )
    return 0
