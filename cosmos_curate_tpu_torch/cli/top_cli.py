"""``cosmos-curate-tpu-torch top …``: htop for pipelines (port of
``cosmos_curate_tpu/cli/top_cli.py``).

Renders a refreshing per-stage table from the live status:

- ``top <run-output-dir>``: the run's atomically swapped live snapshot
  (``<out>/report/live/status.json``) read off disk; any local run;
- ``top http://host:port``: a job service: readiness and queue depths
  (``/health``), per-tenant SLO standing (``/v1/slo``) and running jobs;
- ``top http://host:port --job <id>`` (or a full ``…/v1/jobs/<id>/status``
  URL): one job's live snapshot as the service serves it.

The service views read the endpoints of the port's job service
(service/app.py), which are the reference's, so they work against either
package's service. ``--once`` prints one frame; otherwise the screen refreshes every
``--interval`` seconds until Ctrl-C. A stale snapshot (a publisher that
stopped while the run claims to be running) is flagged: that staleness is
the wedged-run signal of a single-threaded runner. Host code: no torch.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def register(sub: argparse._SubParsersAction) -> None:
    top = sub.add_parser(
        "top",
        help="live per-stage view of a running pipeline or job service "
        "(reads the live ops snapshot / service status endpoints)",
    )
    top.add_argument(
        "target",
        help="run output dir, service URL (http://host:port), or a full "
        "/v1/jobs/<id>/status URL",
    )
    top.add_argument("--job", default="", help="job id (with a service URL)")
    top.add_argument(
        "--interval", type=float, default=2.0, help="refresh period seconds"
    )
    top.add_argument("--once", action="store_true", help="print one frame and exit")
    top.add_argument("--json", action="store_true", dest="as_json", help="raw JSON frame")
    top.set_defaults(func=_cmd_top)


def _http_get(url: str, timeout: float = 5.0) -> dict:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:  # noqa: S310
        return json.loads(resp.read().decode("utf-8"))


def _render_service(base: str) -> tuple[str, dict]:
    """(rendered text, raw payload) for a bare service URL — the payload
    carries the actual health + SLO documents so --json is scriptable."""
    from cosmos_curate_tpu_torch.service.job_queue import LANES

    health = _http_get(f"{base}/health")
    lines = [
        f"service: {base}  status={health.get('status')}  "
        f"ready={health.get('ready')}  dispatcher={health.get('dispatcher_running')}  "
        f"journal_writable={health.get('journal_writable')}"
    ]
    queued = health.get("queued") or {}
    lines.append(
        "queues: "
        + "  ".join(f"{lane}={queued.get(lane, 0)}" for lane in LANES)
        + f"  max_concurrent={health.get('max_concurrent')}"
    )
    states = health.get("states") or {}
    if states:
        lines.append(
            "jobs: " + "  ".join(f"{s}={n}" for s, n in sorted(states.items()) if n)
        )
    if "index_generation" in health:
        lines.append(f"search: serving index generation {health['index_generation']}")
    running = health.get("running_jobs") or []
    if running:
        lines.append(f"running: {', '.join(running)}  (drill in with --job <id>)")
    try:
        slo = _http_get(f"{base}/v1/slo")
    except Exception:
        slo = None
    if slo and slo.get("tenants"):
        lines.append("per-tenant SLO standing:")
        lines.append(
            f"  {'tenant':<20} {'wait mean/max':>14} {'dur mean/max':>14} "
            f"{'success':>8} {'breaches':>8}"
        )
        for tenant, t in slo["tenants"].items():
            qw, rd, sr = t["queue_wait"], t["run_duration"], t["success_rate"]
            rate = sr.get("rate")
            lines.append(
                f"  {tenant:<20} "
                f"{qw['mean_s']:>6.1f}/{qw['max_s']:<6.1f} "
                f"{rd['mean_s']:>6.1f}/{rd['max_s']:<6.1f} "
                f"{(f'{rate:.0%}' if rate is not None else '—'):>8} "
                f"{t['breaches_total']:>8}"
            )
    return "\n".join(lines), {"health": health, "slo": slo}


def _frame(args: argparse.Namespace) -> tuple[str, dict | None]:
    """One rendered frame + the raw payload (None = nothing to show yet)."""
    from cosmos_curate_tpu_torch.observability.live_status import read_status, render_status

    target = args.target.rstrip("/")
    if target.startswith(("http://", "https://")):
        if "/v1/jobs/" in target:
            doc = _http_get(target)
        elif args.job:
            doc = _http_get(f"{target}/v1/jobs/{args.job}/status")
        else:
            return _render_service(target)
        snap = doc.get("snapshot")
        header = (
            f"job {doc.get('job_id')}  state={doc.get('state')}  "
            f"tenant={doc.get('tenant')}  attempts={doc.get('attempts')}"
        )
        if snap is None:
            return f"{header}\n  {doc.get('detail', 'no live snapshot')}", doc
        return f"{header}\n{render_status(snap)}", doc
    snap = read_status(target)
    if snap is None:
        return (
            f"no live snapshot under {target} (run not started, finished "
            "long ago, or live status disabled)",
            None,
        )
    return render_status(snap), snap


def _cmd_top(args: argparse.Namespace) -> int:
    try:
        while True:
            try:
                rendered, payload = _frame(args)
            except Exception as e:
                rendered, payload = f"error: {e}", None
            if args.as_json:
                print(json.dumps(payload or {}))
            else:
                if not args.once:
                    sys.stdout.write("\x1b[2J\x1b[H")  # clear screen, home
                print(rendered)
            if args.once:
                return 0 if payload is not None else 2
            sys.stdout.flush()
            time.sleep(max(0.2, args.interval))
    except KeyboardInterrupt:
        return 130
