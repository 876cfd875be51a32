"""Port parity: the accelerator health gate (``utils/health.py``), the cases
of ``tests/core/test_health_gate.py`` in the port's terms.

The reference returns False for a CPU-pinned process (``JAX_PLATFORMS=cpu``)
and lets ``CURATE_HEALTH_GATE=on`` move a run to the CPU; the port has no
such path (a CPU run is ``device="cpu"``, which ``run_split`` does not gate,
and ``on`` aborts as ``strict`` does: ``tests/test_torch_split.py``). The
retry loop is the reference's: the same probe count, backoff and outcome on
the same answers.
"""

from __future__ import annotations

import pytest
import torch

from cosmos_curate_tpu.utils import health as jhealth
from cosmos_curate_tpu_torch.utils import health


def _gate(mod, monkeypatch, answers, **kw):
    calls, sleeps = [], []
    it = iter(answers)
    monkeypatch.setattr(mod, "probe_accelerator", lambda timeout_s=0: calls.append(timeout_s) or next(it))
    monkeypatch.setattr(mod.time, "sleep", sleeps.append)
    try:
        out = mod.accelerator_health_gate(**kw)
    except RuntimeError as e:
        out = e
    return out, calls, sleeps


@pytest.mark.parametrize("answers", [[False, False, False], [False, True], [True], [False, False, True]],
                         ids=["gives_up", "recovers", "first_try", "last_try"])
@pytest.mark.parametrize("require", [False, True])
def test_retries_match_the_reference(answers, require, monkeypatch):
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    kw = dict(attempts=3, probe_timeout_s=7, backoff_s=5, require=require)
    got, calls, sleeps = _gate(health, monkeypatch, answers, **kw)
    want, j_calls, j_sleeps = _gate(jhealth, monkeypatch, answers, **kw)
    assert (calls, sleeps) == (j_calls, j_sleeps)
    assert type(got) is type(want)
    if isinstance(want, RuntimeError):
        assert "accelerator unhealthy after 3 probes" in str(got)
        assert "CUDA probe" in str(got) and "does not fall back to the CPU" in str(got)
    else:
        assert got == want


def test_probe_subprocess_times_out_cleanly():
    """A wedged driver must surface as False after the timeout, never hang
    the prober: even a healthy torch import cannot finish in 0.2 s."""
    assert health.probe_accelerator(timeout_s=0.2) is False


def test_probe_answers_as_this_host_does():
    assert health.probe_accelerator(timeout_s=120) is torch.cuda.is_available()
