"""Asynchronous device pipeline for model stages (port of
``cosmos_curate_tpu/models/device_pipeline.py``).

A model stage's loop is: build a host batch, copy it to the device,
compute, read the result back. Run in that order, the host, the copy
engines and the SMs take turns. ``DevicePipeline`` overlaps them with the
reference's contract:

- **micro-batching**: a host batch splits into power-of-two bucket
  micro-batches (``plan_micro_batches``, default cap 32), so one logical
  batch becomes several dispatches that can overlap;
- **host staging behind the device**: :meth:`DevicePipeline.run` takes a
  batch as a sequence of rows and stacks each micro-batch's rows into
  pinned host memory just before dispatching it, so the host builds
  micro-batch k + 1 while the device computes k;
- **double buffering**: each micro-batch is copied from pinned host memory
  on a side stream; the compute stream waits on that copy's event only, so
  micro-batch k + 1's copy runs while k computes. A bounded in-flight window
  (2) applies backpressure by settling the oldest dispatch;
- **deferred readback**: right after its compute, a result is copied into
  pinned host memory on a second side stream that waits on the compute's
  event (not behind later compute), and it is read back when its dispatch
  settles, waiting on that copy's event alone, never on the whole device.
  Results are handed out in submission order at drain;
- **abort**: any failure drops the whole burst before it propagates, so a
  caller that catches it can never pair leftover results with the wrong
  submissions.

Buffer donation, the XLA compile cache and the ``CURATE_MICRO_BATCH``
environment variable have no counterpart: PyTorch compiles nothing per
shape, and the cap is the ``micro_batch`` constructor argument.

Each dispatch leaves a :class:`DispatchRecord` in ``records``: its
host-to-device, compute and device-to-host times (CUDA events on the GPU,
the host clock on the CPU) and the device idle gap before its compute.
"""

from __future__ import annotations

import time
from collections import deque
from collections.abc import Sequence
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from cosmos_curate_tpu_torch.models.batching import next_pow2

DEFAULT_MICRO_BATCH = 32
IN_FLIGHT = 2  # dispatches holding device buffers at once
MAX_RECORDS = 4096


def micro_batch_cap(override: int | None = None) -> int:
    """Micro-batch bucket cap: pow2, default 32. A non-pow2 value rounds
    DOWN: the cap is a ceiling on per-dispatch device memory, which
    rounding up would exceed."""
    cap = DEFAULT_MICRO_BATCH if override is None else override
    if cap < 1:
        raise ValueError(f"micro-batch cap must be >= 1, got {cap}")
    return cap if cap & (cap - 1) == 0 else 1 << (cap.bit_length() - 1)


def plan_micro_batches(n: int, cap: int) -> list[tuple[int, int, int]]:
    """Split a batch of ``n`` rows into (start, stop, padded_size) bucket
    micro-batches: full ``cap``-sized chunks, then one remainder padded to
    its next power of two."""
    if n <= 0:
        return []
    plan: list[tuple[int, int, int]] = []
    start = 0
    while n - start > cap:
        plan.append((start, start + cap, cap))
        start += cap
    rest = n - start
    plan.append((start, n, min(next_pow2(rest), cap)))
    return plan


@dataclass
class DispatchRecord:
    """One dispatch's times in seconds. On the GPU each is a CUDA-event
    interval: the side-stream copy in, the compute on the compute stream,
    the side-stream copy out, and the device idle time between the previous
    dispatch's compute and this one's (0 for a burst's first dispatch)."""

    h2d_s: float
    compute_s: float
    d2h_s: float
    gap_s: float
    rows: int
    padded_rows: int


@dataclass
class _InFlight:
    host: Any  # pinned host tensor(s) the result lands in
    n_valid: int | None
    padded_rows: int
    events: dict = field(default_factory=dict)  # name -> torch.cuda.Event (GPU)
    host_times: dict = field(default_factory=dict)  # name -> seconds (CPU)
    inputs: list = field(default_factory=list)  # pinned inputs kept alive until settled
    settled: bool = False


def _map(fn, x):
    if isinstance(x, (tuple, list)):
        return type(x)(fn(a) for a in x)
    return fn(x)


class DevicePipeline:
    """Micro-batched asynchronous dispatcher over one callable.

    ``fn(*args)`` runs on the device: host arguments (numpy arrays, CPU
    tensors) are copied there (through pinned memory and a side stream on
    the GPU), anything else passes through. It returns a tensor or a tuple
    of tensors.

    Not thread-safe: each stage worker owns its own instance."""

    def __init__(
        self,
        name: str,
        fn: Callable[..., Any],
        *,
        device: str | torch.device,
        micro_batch: int | None = None,
    ) -> None:
        self.name = name
        self.device = torch.device(device)
        self._fn = fn
        self._cap = micro_batch_cap(micro_batch)
        self._pending: list[_InFlight] = []
        self._settled: list[_InFlight] = []
        self.records: deque[DispatchRecord] = deque(maxlen=MAX_RECORDS)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._h2d_stream = torch.cuda.Stream(self.device)
            self._d2h_stream = torch.cuda.Stream(self.device)

    # -- core ---------------------------------------------------------------

    def _event(self, inf: _InFlight, name: str, stream) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        inf.events[name] = ev

    def _dispatch_cpu(self, inf: _InFlight, args) -> None:
        t0 = time.perf_counter()
        dev = [torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a for a in args]
        t1 = time.perf_counter()
        result = self._fn(*dev)
        t2 = time.perf_counter()
        inf.host = _map(lambda t: t.detach().numpy().copy(), result)
        inf.host_times = dict(h2d_s=t1 - t0, compute_s=t2 - t1, d2h_s=time.perf_counter() - t2)

    def _dispatch_cuda(self, inf: _InFlight, args) -> None:
        compute = torch.cuda.current_stream(self.device)
        # copy in: pinned host memory -> device on the h2d side stream; the
        # compute stream waits on this copy's event alone, and each buffer
        # is marked as used by the compute stream so the allocator keeps it
        dev = []
        with torch.cuda.stream(self._h2d_stream):
            self._event(inf, "h2d_start", self._h2d_stream)
            for a in args:
                if isinstance(a, np.ndarray):
                    a = torch.from_numpy(np.ascontiguousarray(a))
                if isinstance(a, torch.Tensor) and a.device.type == "cpu":
                    pinned = a if a.is_pinned() else a.pin_memory()
                    inf.inputs.append(pinned)
                    a = pinned.to(self.device, non_blocking=True)
                    a.record_stream(compute)
                dev.append(a)
            self._event(inf, "h2d_end", self._h2d_stream)
        compute.wait_event(inf.events["h2d_end"])
        self._event(inf, "compute_start", compute)
        result = self._fn(*dev)
        self._event(inf, "compute_end", compute)
        # copy out: device -> pinned host memory on the d2h side stream,
        # behind this dispatch's compute only, not the next one's
        self._d2h_stream.wait_event(inf.events["compute_end"])
        with torch.cuda.stream(self._d2h_stream):
            self._event(inf, "d2h_start", self._d2h_stream)

            def copy(t):
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                t.record_stream(self._d2h_stream)
                return host

            inf.host = _map(copy, result)
            self._event(inf, "d2h_end", self._d2h_stream)

    def submit(self, *args: Any, n_valid: int | None = None) -> None:
        """Dispatch one pre-shaped micro-batch; returns without waiting for
        the device. ``n_valid`` trims array results to their first n rows
        at drain. Any failure aborts the whole pipeline first."""
        padded = next((int(a.shape[0]) for a in args if isinstance(a, (np.ndarray, torch.Tensor)) and a.ndim), 0)
        inf = _InFlight(host=None, n_valid=n_valid, padded_rows=padded)
        try:
            # backpressure: at most IN_FLIGHT dispatches hold device buffers
            while len(self._pending) >= IN_FLIGHT:
                self._settle_oldest()
            if self._cuda:
                self._dispatch_cuda(inf, args)
            else:
                self._dispatch_cpu(inf, args)
        except Exception:
            self.abort()
            raise
        self._pending.append(inf)

    def abort(self) -> None:
        """Drop ALL in-flight and settled work, so a caller that catches
        the error resumes with an empty pipeline."""
        self._pending.clear()
        self._settled.clear()

    def _settle_oldest(self) -> None:
        """Wait for the oldest dispatch's readback (its own event, not the
        device) and keep its host result for the drain."""
        inf = self._pending.pop(0)
        try:
            if self._cuda:
                inf.events["d2h_end"].synchronize()
        except Exception:
            self.abort()
            raise
        inf.inputs.clear()
        inf.settled = True
        self._settled.append(inf)

    def _times(self, inf: _InFlight, prev: _InFlight | None) -> DispatchRecord:
        if self._cuda:
            ev = inf.events
            ms = lambda a, b: a.elapsed_time(b) / 1e3  # noqa: E731
            gap = 0.0 if prev is None else max(0.0, ms(prev.events["compute_end"], ev["compute_start"]))
            h2d = ms(ev["h2d_start"], ev["h2d_end"])
            compute = ms(ev["compute_start"], ev["compute_end"])
            d2h = ms(ev["d2h_start"], ev["d2h_end"])
        else:
            h2d, compute, d2h = (inf.host_times[k] for k in ("h2d_s", "compute_s", "d2h_s"))
            gap = 0.0
        rows = inf.padded_rows if inf.n_valid is None else inf.n_valid
        return DispatchRecord(h2d, compute, d2h, gap, rows, inf.padded_rows)

    def drain(self) -> list[Any]:
        """Everything submitted since the last drain, in submission order,
        as host (numpy) values trimmed to ``n_valid``. On any failure the
        pipeline aborts first."""
        burst = self._settled + self._pending
        self._settled, self._pending = [], []
        out: list[Any] = []
        prev = None
        try:
            for inf in burst:
                if not inf.settled and self._cuda:
                    inf.events["d2h_end"].synchronize()
                host = _map(lambda t: t.numpy().copy() if isinstance(t, torch.Tensor) else t, inf.host)
                if inf.n_valid is not None:
                    host = _map(lambda a, n=inf.n_valid: a[:n] if getattr(a, "ndim", 0) >= 1 else a, host)
                self.records.append(self._times(inf, prev))
                prev = inf
                out.append(host)
        except Exception:
            self.abort()
            raise
        return out

    @property
    def pending(self) -> int:
        return len(self._pending) + len(self._settled)

    # -- convenience --------------------------------------------------------

    def _stage_rows(self, rows: Sequence[np.ndarray], start: int, stop: int, target: int):
        """Stack ``rows[start:stop]`` into one host buffer of ``target``
        rows (pinned on the GPU), the last row repeated as padding (padded
        rows stay in-distribution): the one host copy of these rows before
        the device copy."""
        first = np.asarray(rows[start])
        if self._cuda:
            buf = torch.empty((target, *first.shape), dtype=torch.from_numpy(first[:0]).dtype, pin_memory=True)
            out = buf.numpy()
        else:
            buf = out = np.empty((target, *first.shape), first.dtype)
        out[0] = first
        for j in range(1, stop - start):
            out[j] = rows[start + j]
        out[stop - start :] = out[stop - start - 1]
        return buf

    def run(self, *batches: Sequence[np.ndarray]) -> np.ndarray:
        """Split the batch into bucket micro-batches, pad each to its
        bucket, dispatch all, drain, and concatenate the valid rows back in
        order. Each argument is a batch of rows of one shape and dtype: an
        array with the batch on its leading dim, or a sequence of per-row
        arrays. Each micro-batch's rows are stacked just before it is
        dispatched, so the host stacks micro-batch k + 1 while the device
        computes k. Not to be interleaved with in-flight ``submit`` work on
        the same pipeline."""
        if self.pending:
            raise RuntimeError("run() with submissions in flight; drain() first")
        n = len(batches[0])
        if n == 0:
            raise ValueError("run() of an empty batch")
        for b in batches[1:]:
            if len(b) != n:
                raise ValueError(f"run() arguments disagree on batch size: {n} vs {len(b)}")
        for start, stop, target in plan_micro_batches(n, self._cap):
            self.submit(*(self._stage_rows(b, start, stop, target) for b in batches), n_valid=stop - start)
        outs = self.drain()
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)
