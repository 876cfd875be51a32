"""``cosmos-curate-tpu-torch lint``: run the static-analysis passes over the
port (port of ``cosmos_curate_tpu/cli/lint_cli.py``, with the same flags).

Usage:

    cosmos-curate-tpu-torch lint                     # AST rules over cosmos_curate_tpu_torch/
    cosmos-curate-tpu-torch lint path/a.py dir/      # specific targets
    cosmos-curate-tpu-torch lint --rules min-python  # subset of rules
    cosmos-curate-tpu-torch lint --concurrency       # + whole-repo lock analysis
    cosmos-curate-tpu-torch lint --schema [--update] # + golden-schema diff
    cosmos-curate-tpu-torch lint --json              # NDJSON findings (CI)
    cosmos-curate-tpu-torch lint --list-rules

``--concurrency`` adds the whole-repo concurrency verifier
(analysis/concurrency_check.py): lock registry + acquisition-order graph
(cycle = potential deadlock), blocking-calls-under-lock, and
guarded-by/holds-lock contract checking.

``--schema`` diffs the port's protocol frames and durable formats against
the goldens under ``cosmos_curate_tpu_torch/analysis/schemas/`` (the
reference's, byte for byte); ``--update`` regenerates them.

``--shard-check`` (with ``--mesh``, ``--devices`` and ``--hbm-gb``) is the
reference's device-free sharding pass over JAX's mesh API; the port has no
mesh layer yet (ROADMAP queue A item 7), so it exits 2 saying so.

Exit status: 0 clean, 1 error findings, 2 usage error. Warnings print but
do not fail the gate. Findings print as ``file:line rule-id message``;
suppress an AST rule with ``# curate-lint: disable=<rule>`` on (or
directly above) the flagged line.
"""

from __future__ import annotations

import argparse
import sys


def register(sub: "argparse._SubParsersAction") -> None:
    lint = sub.add_parser(
        "lint",
        help="static analysis: engine lock discipline, interpreter-floor "
        "APIs, jit transfer smells, silent exception swallows, mesh-axis "
        "hygiene; --shard-check adds device-free sharding contracts",
    )
    lint.add_argument(
        "paths",
        nargs="*",
        default=["cosmos_curate_tpu_torch"],
        help="files or directories to lint (default: cosmos_curate_tpu_torch/)",
    )
    lint.add_argument(
        "--rules",
        default=None,
        help="comma-separated rule ids to run (default: all enabled in "
        "[tool.curate-lint])",
    )
    lint.add_argument(
        "--shard-check",
        action="store_true",
        help="also run the sharding/shape contract pass (device-free: "
        "jax.eval_shape over an AbstractMesh, no TPUs needed)",
    )
    lint.add_argument(
        "--mesh",
        default=None,
        help='mesh extents for --shard-check, e.g. "data=2,seq=2" '
        "(unnamed axes = 1; default from [tool.curate-lint] shard-mesh)",
    )
    lint.add_argument(
        "--devices",
        type=int,
        default=None,
        help="device count a -1 mesh axis absorbs (default: the product of "
        "the fixed extents — still zero device discovery)",
    )
    lint.add_argument(
        "--hbm-gb",
        type=float,
        default=None,
        help="per-device HBM budget in GiB for the replicated-params "
        "estimate (default from [tool.curate-lint] shard-hbm-gb; 0 skips)",
    )
    lint.add_argument(
        "--concurrency",
        action="store_true",
        help="also run the whole-repo concurrency verifier: lock-order "
        "graph (deadlock cycles), blocking-under-lock, guarded-by / "
        "holds-lock contracts",
    )
    lint.add_argument(
        "--schema",
        action="store_true",
        help="also run the schema & wire-compat verifier: protocol frames "
        "and durable JSON formats diffed against analysis/schemas/ goldens; "
        "drift without a version bump (or without a migration shim for "
        "breaking durable drift) fails the gate",
    )
    lint.add_argument(
        "--update",
        action="store_true",
        help="with --schema: regenerate the golden snapshots under "
        "analysis/schemas/ from the current code instead of diffing",
    )
    lint.add_argument(
        "--json",
        action="store_true",
        dest="as_json",
        help="emit findings as NDJSON (rule/file/line/severity/message), "
        "one object per line, across all pillars",
    )
    lint.add_argument(
        "--list-rules", action="store_true", help="print the rule catalogue and exit"
    )
    lint.set_defaults(func=_cmd_lint)


def _cmd_lint(args: argparse.Namespace) -> int:
    from cosmos_curate_tpu_torch.analysis.ast_lint import run_lint
    from cosmos_curate_tpu_torch.analysis.common import Severity
    from cosmos_curate_tpu_torch.analysis.rules import all_rules

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.rule_id:32s} {rule.description}")
        print(f"{'(pass) shard-check':32s} device-free sharding/shape contracts "
              "(--shard-check; waits for the mesh layer, ROADMAP queue A item 7)")
        print(f"{'(pass) concurrency':32s} whole-repo lock-order graph, "
              "blocking-under-lock, guarded-by contracts (--concurrency; "
              "rule ids lock-order, lock-blocking, unguarded-shared)")
        print(f"{'(pass) schema':32s} protocol-frame + durable-format "
              "golden-schema diff (--schema [--update]; rule ids schema-*)")
        return 0
    if args.shard_check:
        print(
            "error: --shard-check checks sharded entry points against a device mesh, "
            "and the port has no mesh layer yet (ROADMAP queue A item 7)",
            file=sys.stderr,
        )
        return 2
    rule_ids = [r.strip() for r in args.rules.split(",")] if args.rules else None
    try:
        findings = run_lint(args.paths, rule_ids=rule_ids)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.concurrency:
        from cosmos_curate_tpu_torch.analysis.concurrency_check import run_concurrency_check

        try:
            findings.extend(run_concurrency_check(args.paths))
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    if args.update and not args.schema:
        print("error: --update requires --schema", file=sys.stderr)
        return 2
    if args.schema:
        from cosmos_curate_tpu_torch.analysis.schema_check import run_schema_check

        findings.extend(run_schema_check(update=args.update))
        if args.update:
            print(
                "curate-lint: schema goldens regenerated under "
                "cosmos_curate_tpu_torch/analysis/schemas/ — review and commit them",
                file=sys.stderr,
            )
    for f in findings:
        print(f.to_json() if args.as_json else f.render())
    errors = [f for f in findings if f.severity is Severity.ERROR]
    n_files = len(args.paths)
    if errors:
        print(
            f"curate-lint: {len(errors)} error(s), "
            f"{len(findings) - len(errors)} warning(s) "
            f"(suppress AST rules with '# curate-lint: disable=<rule>')",
            file=sys.stderr,
        )
        return 1
    if findings:
        print(f"curate-lint: {len(findings)} warning(s), no errors", file=sys.stderr)
        return 0
    print(f"curate-lint: clean ({n_files} target(s))", file=sys.stderr)
    return 0
