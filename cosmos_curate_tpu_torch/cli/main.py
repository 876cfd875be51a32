"""``cosmos-curate-tpu-torch`` command line root (port of
``cosmos_curate_tpu/cli/main.py``).

The same argparse tree as the reference's, with the groups the port has:
``info``, ``export-lance`` (a run's embeddings parquet to lance datasets,
storage/lance_export.py), ``local`` (run the pipelines, ``cli/local_cli.py``), ``serve``
(the job service, ``cli/serve_cli.py``), ``view`` (a clip viewer over a
split output, ``cli/view_cli.py``), ``slurm`` (sbatch scripts and job
management, ``cli/slurm_cli.py``), ``models`` (the weights registry:
list, stage, seeded checkpoints, hub pulls, ``cli/models_cli.py``),
``postgres`` (the AV state database's
admin commands, ``cli/postgres_cli.py``), ``dlq`` (dead-lettered batches,
``cli/dlq_cli.py``), ``report`` (a run's flight recorder report,
``cli/report_cli.py``), ``top`` (live status, ``cli/top_cli.py``),
``index`` (the corpus index, ``cli/index_cli.py``), ``lint`` (the static
analysis passes over the port, ``cli/lint_cli.py``) and ``agent`` (join a
driver's cross-node engine plane as a worker node,
engine/remote_agent.py), registered in the reference's order. The
reference's ``image`` and ``deploy`` groups wait for the port's container
image (ROADMAP queue A item 23).

Run it as ``python -m cosmos_curate_tpu_torch.cli.main`` or through the
``cosmos-curate-tpu-torch`` console script. Every command that runs a model
runs it on the GPU unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys

from cosmos_curate_tpu_torch import __version__
from cosmos_curate_tpu_torch.cli import (
    dlq_cli,
    index_cli,
    lint_cli,
    local_cli,
    models_cli,
    postgres_cli,
    report_cli,
    serve_cli,
    slurm_cli,
    top_cli,
    view_cli,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="cosmos-curate-tpu-torch",
        description="video curation pipelines on PyTorch and CUDA",
    )
    parser.add_argument("--version", action="version", version=__version__)
    sub = parser.add_subparsers(dest="command", metavar="command")

    info = sub.add_parser("info", help="show environment and device info")
    info.set_defaults(func=_cmd_info)

    lance = sub.add_parser(
        "export-lance",
        help="convert a run's embeddings parquet output to lance datasets "
        "(requires `pip install pylance` in the target environment)",
    )
    lance.add_argument("--src", required=True, help="embeddings/ dir (or one model subdir)")
    lance.add_argument("--dest", required=True, help="output root for <model>.lance datasets")
    lance.add_argument("--mode", default="create", choices=["create", "overwrite", "append"])
    lance.set_defaults(func=_cmd_export_lance)

    local_cli.register(sub)
    serve_cli.register(sub)
    view_cli.register(sub)
    slurm_cli.register(sub)
    models_cli.register(sub)
    lint_cli.register(sub)
    postgres_cli.register(sub)
    dlq_cli.register(sub)
    report_cli.register(sub)
    top_cli.register(sub)
    index_cli.register(sub)

    agent = sub.add_parser("agent", help="join a driver's cross-node engine plane as a worker node")
    agent.add_argument("--driver", required=True, help="driver HOST:PORT")
    agent.add_argument("--node-id", default=None)
    agent.add_argument("--num-cpus", type=float, default=None)
    agent.set_defaults(func=_cmd_agent)
    return parser


def _cmd_export_lance(args: argparse.Namespace) -> int:
    from cosmos_curate_tpu_torch.storage.lance_export import export_parquet_to_lance

    try:
        written = export_parquet_to_lance(args.src, args.dest, mode=args.mode)
    except (RuntimeError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for uri, rows in written.items():
        print(f"{uri}: {rows} rows")
    return 0


def _cmd_agent(args: argparse.Namespace) -> int:
    from cosmos_curate_tpu_torch import chaos
    from cosmos_curate_tpu_torch.engine.remote_agent import NodeAgent
    from cosmos_curate_tpu_torch.observability.tracing import setup_tracing_from_env

    # as the agent's own entry point does: a fault plan and tracing ride
    # the environment
    chaos.install_from_env()
    setup_tracing_from_env()
    return NodeAgent(args.driver, node_id=args.node_id, num_cpus=args.num_cpus).run()


def _cmd_info(args: argparse.Namespace) -> int:
    """A report of the environment: a host without a card says so."""
    import platform

    import torch

    print(f"cosmos-curate-tpu-torch {__version__}")
    print(f"python {platform.python_version()} on {platform.system().lower()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda or 'none (CPU build)'}")
    if torch.cuda.is_available():
        # host inventory until the mesh layer owns device counts (ROADMAP queue A item 7)
        # curate-lint: disable=hardcoded-device-count
        count = torch.cuda.device_count()
        print(f"{count} CUDA device(s): {', '.join(torch.cuda.get_device_name(i) for i in range(count))}")
    else:
        print("no CUDA device: pass --device cpu to run the pipelines on the CPU")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not getattr(args, "command", None):
        parser.print_help()
        return 2
    try:
        return int(args.func(args) or 0)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return 130


if __name__ == "__main__":
    sys.exit(main())
