"""``cosmos-curate-tpu-torch slurm``: submit and manage pipeline jobs on
Slurm (port of ``cosmos_curate_tpu/cli/slurm_cli.py``: the same scripts,
launching the port's command line and node agent).

Equivalent capability of the reference's slurm CLI
(cosmos_curate/client/slurm_cli/slurm.py:244-564 + scripts/onto_slurm.py +
prometheus_service_discovery.py): sbatch generation, local or SSH remote
submission with job-id parsing, job status/log/cancel management, and
Prometheus service-discovery file generation so a fleet dashboard scrapes
per-node engine metrics.

Topology: the reference runs node 0 as a Ray head plus driver and the rest
as Ray workers; here every node runs the same program, which joins a
``torch.distributed`` gloo group under ``CURATE_COORDINATOR_ADDRESS``
(cosmos_curate_tpu_torch/parallel/distributed.py), with deterministic task
partitioning and convergent resume across nodes — node 0 is only special
as the coordinator address.

Subcommands:
  submit   generate an sbatch script; print, write, or submit it
           (``--remote-host user@host`` scp+sbatch's it over SSH)
  status   squeue/sacct for a job id
  logs     tail the job's output file
  cancel   scancel a job id
  prom-sd  write a Prometheus HTTP-SD JSON from a hostfile
"""

from __future__ import annotations

import argparse
import json
import re
import os
import shlex
import subprocess
from pathlib import Path

_SBATCH_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={job_name}
#SBATCH --nodes={nodes}
#SBATCH --ntasks-per-node=1
#SBATCH --cpus-per-task={cpus_per_task}
#SBATCH --time={time_limit}
#SBATCH --output={log_dir}/%x-%j.out
{extra_directives}
set -euo pipefail

# coordinator = first node in the allocation (the gloo group's rank 0);
# CURATE_NODE_RANK is resolved per task by srun via SLURM_NODEID.
COORD=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n1)
export CURATE_COORDINATOR_ADDRESS="$COORD:{coordinator_port}"
export CURATE_NUM_NODES="$SLURM_JOB_NUM_NODES"
{env_exports}
{prom_sd_step}
{engine_plane_exports}# srun exports the environment; no nested shell, so arbitrary quoting in
# the command survives verbatim. Node rank is read from SLURM_NODEID by
# cosmos_curate_tpu_torch.parallel.distributed in each task.
{srun_step}
{merge_step}"""

_SRUN_DEFAULT = "srun --kill-on-bad-exit=1 {python} -m cosmos_curate_tpu_torch.cli.main {command}"
# engine-plane topology: node 0 runs the driver (the pipeline command,
# carried shlex-quoted in CURATE_DRIVER_CMD and re-parsed by eval); every
# other node runs an agent that joins the driver's CPU-stage pools
_SRUN_ENGINE_PLANE = (
    "srun --kill-on-bad-exit=1 bash -c 'if [ \"$SLURM_NODEID\" = 0 ]; then "
    # the driver is a SINGLE-node pipeline whose extra capacity arrives via
    # agents — the process-group/partition contract must not see N nodes
    # (it would block in init_process_group waiting for peers that run agents, and
    # partition away (N-1)/N of the input)
    "export CURATE_NUM_NODES=1; unset CURATE_COORDINATOR_ADDRESS; "
    'eval "exec {python} -m cosmos_curate_tpu_torch.cli.main $CURATE_DRIVER_CMD"; else '
    "unset CURATE_ENGINE_DRIVER_PORT; "
    "exec {python} -m cosmos_curate_tpu_torch.engine.remote_agent "
    '--driver "$COORD:{engine_port}"; fi\''
)


def parse_job_id(sbatch_output: str) -> str:
    """'Submitted batch job 12345' -> '12345' (reference slurm.py:302)."""
    m = re.search(r"Submitted batch job (\d+)", sbatch_output)
    if not m:
        raise ValueError(f"cannot parse job id from sbatch output: {sbatch_output!r}")
    return m.group(1)


def write_prometheus_sd(
    path: Path,
    hosts: list[str],
    *,
    port: int,
    job_id: str = "",
    job_name: str = "",
    job_user: str = "",
) -> None:
    """Prometheus HTTP-SD / file-SD JSON listing every node's metrics
    endpoint (reference prometheus_service_discovery.py:53-71; our engine
    serves the `pipeline_*` gauges on --metrics-port)."""
    data = [
        {
            "labels": {
                "job": "cosmos-curate-tpu",
                "slurm_job_user": job_user,
                "slurm_job_id": job_id,
                "slurm_job_name": job_name,
            },
            "targets": [f"{h}:{port}" for h in hosts if h],
        }
    ]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(data, indent=2))


def render_sbatch(args: argparse.Namespace, command: list[str]) -> str:
    extra = []
    if args.partition:
        extra.append(f"#SBATCH --partition={args.partition}")
    if args.account:
        extra.append(f"#SBATCH --account={args.account}")
    env_exports = "\n".join(f"export {shlex.quote(e)}" for e in args.env)
    merge_step = ""
    if args.merge_output:
        merge_step = (
            "\n# all partitions done: fold per-node summaries into one\n"
            f"python -m cosmos_curate_tpu_torch.cli.main local merge-summaries "
            f"--output-path {shlex.quote(args.merge_output)}\n"
        )
    prom_sd_step = ""
    if args.prom_sd_file:
        # monitoring registration must never kill the compute job (the
        # template runs under set -e), hence the || warning; the nodes temp
        # file is removed either way
        prom_sd_step = (
            "# register every node with the metrics scraper before the run\n"
            'NODES_FILE=$(mktemp)\n'
            'scontrol show hostnames "$SLURM_JOB_NODELIST" > "$NODES_FILE"\n'
            f"python -m cosmos_curate_tpu_torch.cli.main slurm prom-sd "
            f"--path {shlex.quote(args.prom_sd_file)} "
            f'--hostfile "$NODES_FILE" '
            f"--port {args.metrics_port} "
            '--job-id "$SLURM_JOB_ID" --job-name "$SLURM_JOB_NAME" --job-user "$USER" '
            '|| echo "warning: prometheus service-discovery registration failed" >&2\n'
            'rm -f "$NODES_FILE"\n'
        )
    quoted_command = " ".join(shlex.quote(c) for c in command)
    engine_plane_exports = ""
    if getattr(args, "engine_plane", False):
        engine_plane_exports = (
            "# cross-node engine plane: node 0 drives, other nodes run agents\n"
            "export CURATE_ENGINE_TOKEN=\"${CURATE_ENGINE_TOKEN:-"
            "$(head -c16 /dev/urandom | od -An -tx1 | tr -d ' \\n')}\"\n"
            f"export CURATE_ENGINE_DRIVER_PORT={args.engine_port}\n"
            'export CURATE_ENGINE_WAIT_NODES="$((SLURM_JOB_NUM_NODES - 1))"\n'
            f"export CURATE_DRIVER_CMD={shlex.quote(quoted_command)}\n"
        )
        srun_step = _SRUN_ENGINE_PLANE.format(
            python="python", engine_port=args.engine_port
        )
    else:
        srun_step = _SRUN_DEFAULT.format(python="python", command=quoted_command)
    return _SBATCH_TEMPLATE.format(
        merge_step=merge_step,
        prom_sd_step=prom_sd_step,
        job_name=args.job_name,
        nodes=args.nodes,
        cpus_per_task=args.cpus_per_task,
        time_limit=args.time_limit,
        log_dir=args.log_dir,
        extra_directives="\n".join(extra),
        coordinator_port=args.coordinator_port,
        env_exports=env_exports,
        engine_plane_exports=engine_plane_exports,
        srun_step=srun_step,
    )


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True)


def _remote(host: str, cmd: list[str]) -> subprocess.CompletedProcess:
    return _run(["ssh", "-o", "BatchMode=yes", host, shlex.join(cmd)])


# -- commands --------------------------------------------------------------


def _cmd_submit(args: argparse.Namespace) -> int:
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        print(
            "error: pass the pipeline command after '--', e.g. "
            "slurm submit --nodes 4 -- local split --config run.yaml"
        )
        return 2
    script = render_sbatch(args, command)
    if args.output:
        Path(args.output).write_text(script)
        print(f"wrote {args.output}")
    else:
        print(script)
    if not args.submit:
        return 0
    if args.output:
        target = args.output
    else:
        # Unpredictable per-invocation name: a fixed path in world-writable
        # /tmp is clobbered by concurrent submitters and invites symlink
        # pre-creation races on shared login nodes.
        import tempfile

        fd, target = tempfile.mkstemp(prefix="cosmos_curate_tpu_", suffix=".sbatch")
        with os.fdopen(fd, "w") as fh:
            fh.write(script)
    if args.remote_host:
        mk = _remote(args.remote_host, ["mktemp", "-t", "cosmos_curate_tpu_XXXXXX.sbatch"])
        if mk.returncode != 0:
            print(mk.stderr)
            return mk.returncode
        remote_path = mk.stdout.strip()
        scp = _run(["scp", "-o", "BatchMode=yes", target, f"{args.remote_host}:{remote_path}"])
        if scp.returncode != 0:
            print(scp.stderr)
            return scp.returncode
        result = _remote(args.remote_host, ["sbatch", remote_path])
    else:
        result = _run(["sbatch", target])
    out = result.stdout or result.stderr
    print(out.strip())
    if result.returncode == 0:
        try:
            print(f"job-id: {parse_job_id(out)}")
        except ValueError:
            pass
    return result.returncode


def _cmd_status(args: argparse.Namespace) -> int:
    cmd = ["squeue", "-j", args.job_id, "-o", "%i %j %T %M %D %R"]
    result = _remote(args.remote_host, cmd) if args.remote_host else _run(cmd)
    out = (result.stdout or "").strip()
    # a finished job drops out of squeue; fall back to accounting
    if result.returncode != 0 or len(out.splitlines()) < 2:
        cmd = ["sacct", "-j", args.job_id, "--format=JobID,JobName,State,Elapsed", "-n"]
        result = _remote(args.remote_host, cmd) if args.remote_host else _run(cmd)
        out = (result.stdout or result.stderr).strip()
    print(out)
    return result.returncode


def _cmd_logs(args: argparse.Namespace) -> int:
    log = str(Path(args.log_dir) / f"{args.job_name}-{args.job_id}.out")
    cmd = ["tail", "-n", str(args.lines), log]
    if args.follow:
        cmd.insert(1, "-f")
        # follow streams to the terminal; no capture
        if args.remote_host:
            return subprocess.run(
                ["ssh", "-o", "BatchMode=yes", args.remote_host, shlex.join(cmd)]
            ).returncode
        return subprocess.run(cmd).returncode
    result = _remote(args.remote_host, cmd) if args.remote_host else _run(cmd)
    print(result.stdout or result.stderr)
    return result.returncode


def _cmd_cancel(args: argparse.Namespace) -> int:
    cmd = ["scancel", args.job_id]
    result = _remote(args.remote_host, cmd) if args.remote_host else _run(cmd)
    if result.returncode == 0:
        print(f"cancelled {args.job_id}")
    else:
        print(result.stderr.strip())
    return result.returncode


def _cmd_prom_sd(args: argparse.Namespace) -> int:
    hosts = [
        line.strip()
        for line in Path(args.hostfile).read_text().splitlines()
        if line.strip()
    ]
    write_prometheus_sd(
        Path(args.path),
        hosts,
        port=args.port,
        job_id=args.job_id,
        job_name=args.job_name,
        job_user=args.job_user,
    )
    print(f"wrote {args.path} ({len(hosts)} targets)")
    return 0


def register(sub: argparse._SubParsersAction) -> None:
    slurm = sub.add_parser("slurm", help="submit/manage pipeline jobs on Slurm")
    ssub = slurm.add_subparsers(dest="slurm_command", metavar="subcommand", required=True)

    sb = ssub.add_parser("submit", help="generate/submit an sbatch script")
    sb.add_argument("--job-name", default="cosmos-curate-tpu")
    sb.add_argument("--nodes", type=int, default=1)
    sb.add_argument("--cpus-per-task", type=int, default=96)
    sb.add_argument("--time-limit", default="04:00:00")
    sb.add_argument("--log-dir", default="slurm_logs")
    sb.add_argument("--partition", default="")
    sb.add_argument("--account", default="")
    sb.add_argument("--coordinator-port", type=int, default=8476)
    sb.add_argument(
        "--engine-plane",
        action="store_true",
        help="node 0 drives the streaming engine; other nodes run "
        "engine.remote_agent workers joined over the cross-node data plane",
    )
    sb.add_argument("--engine-port", type=int, default=8478)
    sb.add_argument("--env", action="append", default=[], metavar="K=V")
    sb.add_argument(
        "--merge-output",
        default="",
        metavar="PATH",
        help="after all nodes finish, merge per-node summaries under PATH "
        "into summary-merged.json (runs once, on the batch host)",
    )
    sb.add_argument(
        "--prom-sd-file",
        default="",
        metavar="PATH",
        help="write a Prometheus service-discovery JSON for the allocation's "
        "nodes at job start",
    )
    sb.add_argument("--metrics-port", type=int, default=9002)
    sb.add_argument("--output", default="", help="write script here instead of printing")
    sb.add_argument("--submit", action="store_true", help="sbatch the generated script")
    sb.add_argument(
        "--remote-host", default="", metavar="USER@HOST",
        help="scp the script to this host and sbatch there over SSH",
    )
    sb.add_argument("command", nargs=argparse.REMAINDER, help="cosmos-curate-tpu subcommand")
    sb.set_defaults(func=_cmd_submit)

    st = ssub.add_parser("status", help="squeue/sacct for a job")
    st.add_argument("--job-id", required=True)
    st.add_argument("--remote-host", default="")
    st.set_defaults(func=_cmd_status)

    lg = ssub.add_parser("logs", help="show the job's output log")
    lg.add_argument("--job-id", required=True)
    lg.add_argument("--job-name", default="cosmos-curate-tpu")
    lg.add_argument("--log-dir", default="slurm_logs")
    lg.add_argument("--lines", type=int, default=100)
    lg.add_argument("--follow", action="store_true")
    lg.add_argument("--remote-host", default="")
    lg.set_defaults(func=_cmd_logs)

    ca = ssub.add_parser("cancel", help="scancel a job")
    ca.add_argument("--job-id", required=True)
    ca.add_argument("--remote-host", default="")
    ca.set_defaults(func=_cmd_cancel)

    pd = ssub.add_parser("prom-sd", help="write Prometheus service-discovery JSON")
    pd.add_argument("--path", required=True)
    pd.add_argument("--hostfile", required=True)
    pd.add_argument("--port", type=int, default=9002)
    pd.add_argument("--job-id", default="")
    pd.add_argument("--job-name", default="")
    pd.add_argument("--job-user", default="")
    pd.set_defaults(func=_cmd_prom_sd)
