"""``cosmos-curate-tpu-torch report …``: render a run's flight-recorder
report (port of ``cosmos_curate_tpu/cli/report_cli.py``).

The flight recorder (observability/flight_recorder.py) writes
``<output>/report/run_report.json`` at the end of a traced run. This
command renders it: trace connectivity (ONE trace id means the propagation
held), the span tree's critical path, and the per-stage, device-dispatch
and flow time breakdowns.

``RUN`` is the pipeline output root (or a path to a ``run_report.json``).
``--rebuild`` regenerates the report from the run's collected trace
artifacts, carrying over what only the original driver could source.

A run still going has no ``run_report.json`` yet: the command then renders
the run's live snapshot (``<out>/report/live/status.json``) under a ``RUN
IN PROGRESS`` banner; ``--follow`` refreshes that view and renders the
final report once the run writes it. Host code: no torch.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def register(sub: argparse._SubParsersAction) -> None:
    rep = sub.add_parser(
        "report",
        help="render a run's flight-recorder report (critical path, "
        "per-stage time, trace connectivity); live runs render their "
        "in-flight snapshot instead",
    )
    rep.add_argument("run", help="pipeline output root (or a run_report.json path)")
    rep.add_argument("--json", action="store_true", dest="as_json", help="raw JSON")
    rep.add_argument(
        "--rebuild",
        action="store_true",
        help="regenerate the report from the run's trace artifacts first",
    )
    rep.add_argument(
        "--follow",
        action="store_true",
        help="refresh the live view until the final report lands, then "
        "render it",
    )
    rep.add_argument(
        "--interval", type=float, default=2.0, help="--follow refresh seconds"
    )
    rep.set_defaults(func=_cmd_report)


def _render_live(root: str, as_json: bool) -> bool:
    """Render the live snapshot under a RUN IN PROGRESS banner; False when
    there is no snapshot to show."""
    from cosmos_curate_tpu_torch.observability.live_status import read_status, render_status

    snap = read_status(root)
    if snap is None:
        return False
    if as_json:
        print(json.dumps(snap))
        return True
    state = str(snap.get("state", "running")).upper()
    banner = "RUN IN PROGRESS" if state == "RUNNING" else f"RUN {state}"
    print("=" * 22, banner, "=" * 22)
    print("(no run_report.json yet — rendering the live ops snapshot)")
    print(render_status(snap))
    return True


def _cmd_report(args: argparse.Namespace) -> int:
    from cosmos_curate_tpu_torch.observability.flight_recorder import (
        REPORT_REL,
        load_report,
        render_report,
        report_path,
        write_run_report,
    )

    run = args.run
    suffix = f"/{REPORT_REL}"
    if run.endswith(".json"):
        path = run
        # the run root is only derivable when the json sits at its
        # canonical in-run location; a bare copied file has no root
        root = run[: -len(suffix)] if run.endswith(suffix) and len(run) > len(suffix) else None
    else:
        path = report_path(run)
        root = run
    if args.follow and root is not None:
        # live loop: render the in-flight snapshot until finalize writes
        # the real report (then fall through and render that) — or until
        # the snapshot goes terminal on an UNTRACED run, which never
        # writes run_report.json (the final live frame is the exit)
        from cosmos_curate_tpu_torch.observability.live_status import read_status

        while load_report(path) is None:
            if not args.as_json:
                sys.stdout.write("\x1b[2J\x1b[H")
            snap = read_status(root)
            if not _render_live(root, args.as_json):
                print(f"waiting for a live snapshot under {root} ...")
            sys.stdout.flush()
            if snap is not None and snap.get("state") != "running":
                # run over. Traced runs write the report a few seconds
                # AFTER the terminal snapshot (artifact collection runs in
                # between) — grace-poll before concluding this run is
                # untraced and the live frame is final.
                deadline = time.monotonic() + max(2.0, 3 * args.interval)
                while load_report(path) is None:
                    if time.monotonic() >= deadline:
                        return 0  # untraced: no report is ever coming
                    time.sleep(0.2)
                break  # report landed: fall through and render it
            time.sleep(max(0.2, args.interval))
    existing: dict | None = None
    try:
        existing = load_report(path, strict=True)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        if not args.rebuild:
            return 2
    if existing is None and not args.rebuild and root is not None:
        # a LIVE run has no report yet: show the in-flight view with a
        # clear banner instead of failing on the missing artifact.
        # Finished runs fall through to the rebuild-from-traces path — a
        # terminal snapshot is strictly poorer than a rebuilt report.
        from cosmos_curate_tpu_torch.observability.live_status import read_status

        snap = read_status(root)
        if snap is not None and snap.get("state") == "running":
            _render_live(root, args.as_json)
            return 0
    if args.rebuild or existing is None:
        if root is None:
            print(
                f"error: cannot rebuild from {run!r} — pass the run's "
                "output root instead of a detached json file",
                file=sys.stderr,
            )
            return 2
        if not args.rebuild:
            print(
                f"no report at {path}; rebuilding from trace artifacts",
                file=sys.stderr,
            )
        # `prior` carries over the sections only the original driver could
        # source (dispatch/flow aggregates, runner stage times) — a rebuild
        # refreshes the span analysis without degrading the artifact
        report = write_run_report(root, prior=existing, require_spans=True)
        if not report["span_count"]:
            print(
                f"error: no trace spans under {root}/profile — was the run "
                "traced (--tracing)?",
                file=sys.stderr,
            )
            return 2
    else:
        report = existing
    if args.as_json:
        print(json.dumps(report, indent=2))
    else:
        print(render_report(report))
    return 0
