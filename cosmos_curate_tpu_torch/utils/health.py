"""Accelerator health gate: a retrying CUDA liveness probe (port of
``cosmos_curate_tpu/utils/health.py``).

The gate blocks a run's start until the card answers, so a dead card is one
clear error up front, not a crashed model setup in the middle of a run. The
probe always runs in a subprocess with a timeout: a wedged driver can make
CUDA initialisation itself block, and the probing process stays healthy
whatever the child does. It checks ``torch.cuda.is_available()``, then runs
one small CUDA op and a synchronize.

The port's one divergence: it never degrades to the CPU. The reference's
``CURATE_HEALTH_GATE=on`` moves an unhealthy run to the CPU
(``JAX_PLATFORMS=cpu``); here ``on`` means the same as ``strict``, and an
unhealthy card raises ``RuntimeError`` naming the probe. A run on the CPU
is asked for with ``device="cpu"``, and has no card to gate.
"""

from __future__ import annotations

import subprocess
import sys
import time

from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

PROBE = (
    "import sys, torch\n"
    "if not torch.cuda.is_available():\n"
    "    sys.exit(1)\n"
    "x = torch.ones(1024, device='cuda')\n"
    "assert float((x + x).sum()) == 2048.0\n"
    "torch.cuda.synchronize()\n"
)


def probe_accelerator(timeout_s: float = 120.0) -> bool:
    """One subprocess probe: does a CUDA device run a small op and
    synchronize within the timeout?"""
    try:
        r = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return False
    return r.returncode == 0


def accelerator_health_gate(
    *,
    attempts: int = 3,
    probe_timeout_s: float = 120.0,
    backoff_s: float = 30.0,
    require: bool = False,
) -> bool:
    """Probe up to ``attempts`` times, ``backoff_s`` apart. True once the
    card answers; after the last failed probe, raise when ``require`` is
    set, else return False (``run_split`` always requires)."""
    for i in range(attempts):
        if probe_accelerator(probe_timeout_s):
            if i:
                logger.info("accelerator answered on probe %d/%d", i + 1, attempts)
            return True
        if i + 1 < attempts:
            logger.warning("accelerator probe %d/%d failed; retrying in %.0fs", i + 1, attempts, backoff_s)
            time.sleep(backoff_s)
    if require:
        raise RuntimeError(
            f"accelerator unhealthy after {attempts} probes x {probe_timeout_s:.0f}s: the CUDA probe "
            "(torch.cuda.is_available(), one small op, synchronize) did not pass; the port does not "
            "fall back to the CPU (rerun with device='cpu' to ask for it)"
        )
    return False
