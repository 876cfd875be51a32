"""``cosmos-curate-tpu-torch dlq …``: inspect and re-run dead-lettered
batches (port of ``cosmos_curate_tpu/cli/dlq_cli.py``).

Every runner persists a batch it gives up on (retry budget or
worker-death budget exhausted) to the dead-letter queue
(engine/dead_letter.py). This command makes that lost work visible and
recoverable:

- ``dlq list``: every entry, newest run first;
- ``dlq show ENTRY``: one entry's metadata and task summaries;
- ``dlq requeue ENTRY``: write the entry's tasks to a cloudpickle file
  (``--out``) to feed a pipeline run again, and stamp the entry requeued.
  Library callers use ``DlqEntry.load_tasks()``.

``ENTRY`` is ``<run_id>/<batch-dir>`` as ``list`` prints it (any unique
suffix works). Host code: no torch.
"""

from __future__ import annotations

import argparse
import json
import sys


def register(sub: argparse._SubParsersAction) -> None:
    dlq = sub.add_parser("dlq", help="inspect/re-run dead-lettered batches")
    dsub = dlq.add_subparsers(dest="subcommand", metavar="action")

    ls = dsub.add_parser("list", help="list dead-lettered batches")
    ls.add_argument("--dlq-dir", default=None, help="DLQ root (default: CURATE_DLQ_DIR)")
    ls.add_argument("--run-id", default=None, help="restrict to one run")
    ls.add_argument("--json", action="store_true", dest="as_json")
    ls.set_defaults(func=_cmd_list)

    show = dsub.add_parser("show", help="show one entry's metadata and tasks")
    show.add_argument("entry", help="<run_id>/<batch-dir> (unique suffix ok)")
    show.add_argument("--dlq-dir", default=None)
    show.set_defaults(func=_cmd_show)

    rq = dsub.add_parser(
        "requeue", help="export an entry's tasks for re-running and mark it requeued"
    )
    rq.add_argument("entry", help="<run_id>/<batch-dir> (unique suffix ok)")
    rq.add_argument("--dlq-dir", default=None)
    rq.add_argument(
        "--out",
        default="",
        help="write tasks to this cloudpickle file (default: <entry>/requeued-tasks.pkl)",
    )
    rq.set_defaults(func=_cmd_requeue)

    dlq.set_defaults(func=lambda args: (dlq.print_help(), 2)[1])


def _cmd_list(args: argparse.Namespace) -> int:
    from cosmos_curate_tpu_torch.engine.dead_letter import list_entries

    entries = list_entries(args.dlq_dir, run_id=args.run_id)
    if args.as_json:
        print(json.dumps([{"entry": e.entry_id, **e.meta} for e in entries], indent=2))
        return 0
    if not entries:
        print("dead-letter queue is empty")
        return 0
    for e in entries:
        m = e.meta
        requeued = " [requeued]" if m.get("requeued_at") else ""
        trace = f" trace={m['trace_id']}" if m.get("trace_id") else ""
        # owner-loss drops name the dead node: "node died past budget"
        # reads differently from "batch is poison"
        lost = f" lost_node={m['lost_node']}" if m.get("lost_node") else ""
        print(
            f"{e.entry_id}: stage={m.get('stage')} tasks={m.get('num_tasks')} "
            f"attempts={m.get('attempts')} worker_deaths={m.get('worker_deaths')} "
            f"reason={m.get('reason', '')!r}{lost}{trace}{requeued}"
        )
    return 0


def _cmd_show(args: argparse.Namespace) -> int:
    from cosmos_curate_tpu_torch.engine.dead_letter import find_entry

    try:
        entry = find_entry(args.entry, args.dlq_dir)
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(json.dumps(entry.meta, indent=2))
    if entry.meta.get("lineage"):
        # the producer chain reconstruction walked before giving up
        print("lineage chain (reconstruction gave up here):")
        for hop in entry.meta["lineage"]:
            print(
                f"  {hop.get('ref')} <- {hop.get('produced_by_stage')} "
                f"(inputs: {', '.join(hop.get('inputs', [])) or '-'})"
            )
    try:
        tasks = entry.load_tasks()
    except Exception as e:  # payloads can outlive their class definitions
        print(f"tasks.pkl unreadable: {e}", file=sys.stderr)
        return 1
    for i, t in enumerate(tasks):
        print(f"[{i}] {type(t).__name__}: {_clip(repr(t))}")
    return 0


def _cmd_requeue(args: argparse.Namespace) -> int:
    import cloudpickle

    from cosmos_curate_tpu_torch.engine.dead_letter import find_entry

    try:
        entry = find_entry(args.entry, args.dlq_dir)
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        tasks = entry.load_tasks()
    except Exception as e:
        print(f"error: tasks.pkl unreadable: {e}", file=sys.stderr)
        return 1
    out = args.out or str(entry.path / "requeued-tasks.pkl")
    with open(out, "wb") as f:
        f.write(cloudpickle.dumps(tasks))
    entry.mark_requeued()
    print(f"{len(tasks)} task(s) from {entry.entry_id} -> {out}")
    return 0


def _clip(s: str, n: int = 200) -> str:
    return s if len(s) <= n else s[: n - 1] + "…"
