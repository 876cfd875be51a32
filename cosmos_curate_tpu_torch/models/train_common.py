"""What the port's trainers share (``models/*_train.py``): optax's
optimizers in torch, one optimizer step, and the step loop with its
per-step log.

**Optimizers.** ``optax.adamw(lr)`` and ``optax.adam(lr)`` with their
defaults: betas (0.9, 0.999), ``eps`` 1e-8 added outside the square root,
and for AdamW a decoupled weight decay of 1e-4 on every parameter (torch's
default is 1e-2). Both libraries compute ``mu_hat / (sqrt(nu_hat) + eps)``
and decay from the parameter before the step, so the updates agree to
rounding.

**The loop.** Each step synthesizes a batch on the host (numpy and cv2,
``synthesize``), then runs ``step`` on it: the copy to the device, the
forward, the backward and the optimizer step, eagerly. ``StepLog`` keeps
the host seconds of each synthesis, each step's loss as a device tensor
(read once, after the run: the loop never waits for the device), and, with
``device_timing``, a CUDA event pair around each step.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Callable, Iterable

import torch

OPTAX_BETAS = (0.9, 0.999)
OPTAX_EPS = 1e-8
OPTAX_ADAMW_DECAY = 1e-4


def optax_adamw(params: Iterable[torch.nn.Parameter], lr: float) -> torch.optim.AdamW:
    """``optax.adamw(lr)``."""
    return torch.optim.AdamW(params, lr=lr, betas=OPTAX_BETAS, eps=OPTAX_EPS, weight_decay=OPTAX_ADAMW_DECAY)


def optax_adam(params: Iterable[torch.nn.Parameter], lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``."""
    return torch.optim.Adam(params, lr=lr, betas=OPTAX_BETAS, eps=OPTAX_EPS)


def optimizer_step(opt: torch.optim.Optimizer, loss_fn: Callable[[], torch.Tensor]) -> torch.Tensor:
    """One step: gradients of ``loss_fn()`` applied by ``opt``; the loss,
    detached, on its device."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    opt.step()
    return loss.detach()


class StepLog:
    """Per-step records of one training run."""

    def __init__(self, device_timing: bool = False) -> None:
        self.device_timing = device_timing
        self.synth_s: list[float] = []
        self.losses: list[torch.Tensor] = []
        self.events: list[tuple[torch.cuda.Event, torch.cuda.Event]] = []

    @contextlib.contextmanager
    def synth(self):
        t0 = time.perf_counter()
        yield
        self.synth_s.append(time.perf_counter() - t0)

    @contextlib.contextmanager
    def step(self):
        if not self.device_timing:
            yield
            return
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self.events.append((start, end))

    def loss(self, value: torch.Tensor) -> None:
        self.losses.append(value)

    def loss_values(self) -> list[float]:
        return torch.stack(self.losses).float().cpu().tolist() if self.losses else []

    def device_ms(self) -> list[float]:
        """Each step's device milliseconds, start event to end event (waits
        for the last)."""
        if self.events:
            self.events[-1][1].synchronize()
        return [start.elapsed_time(end) for start, end in self.events]


def run_steps(steps: int, synthesize: Callable[[], tuple], step: Callable[..., torch.Tensor],
              log: StepLog | None, *, log_every: int, label: str, logger, fmt: str = "%.4f") -> float:
    """``steps`` steps of ``step(*synthesize())``; the last step's loss
    (nan after none). Every ``log_every`` steps the loss is logged, which
    reads it back."""
    log = log if log is not None else StepLog()
    loss = None
    for i in range(steps):
        with log.synth():
            batch = synthesize()
        with log.step():
            loss = step(*batch)
        log.loss(loss)
        if log_every and (i + 1) % log_every == 0:
            logger.info(f"%s step %d/%d loss {fmt}", label, i + 1, steps, float(loss))
    return float(loss) if loss is not None else math.nan
