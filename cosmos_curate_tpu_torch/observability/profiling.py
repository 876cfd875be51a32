"""Per-stage profiling with no change to stage code (port of
``cosmos_curate_tpu/observability/profiling.py``).

``profiling_wrapper`` subclasses a stage instance at run time
(``ProfiledStage``; the stage keeps its name) so its ``process_data`` runs
under the configured backends, and its ``destroy`` writes what they
gathered, named ``<stage>-<pid>``:

- CPU: cProfile, top ``top_n`` functions by cumulative time, to
  ``<output>/cpu/<stage>-<pid>.txt``;
- memory: tracemalloc's current and peak bytes per call, to
  ``<output>/memory/<stage>-<pid>.txt``;
- device: ``torch.profiler.profile`` around each call, CPU activity plus
  CUDA activity when the stage claims a GPU, exported as a Chrome trace to
  ``<output>/device/<stage>/trace-<pid>-<call>.json`` (the reference takes a
  ``jax.profiler`` trace there, profiling.py:76-84). The kernels' ctypes
  launches run in the process's own CUDA context, so CUPTI records them
  (``cct_*``) beside PyTorch's.

Since Python 3.12 cProfile rides ``sys.monitoring``, which admits one
profiler per process, and the torch profiler is process-wide too: two
stages profiled at once (the pipelined runner's stage threads, the
streaming engine's in-process device stages) would fail each other's
batches. So the CPU and device backends hold one process-wide lock for a
profiled call, and stages in one process take turns while profiled
(spawned workers each have their own). Memory profiling takes no lock:
tracemalloc counts the whole process, so its numbers for overlapping calls
include each other's allocations, as in the reference.

Host code: torch is imported only inside a device-profiled call.
"""

from __future__ import annotations

import cProfile
import io
import os
import pstats
import threading
import tracemalloc
from dataclasses import dataclass, field
from typing import Any

from cosmos_curate_tpu_torch.storage.client import write_bytes
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# one cProfile / torch.profiler session at a time in this process
_PROFILER_LOCK = threading.Lock()


@dataclass
class ProfilingConfig:
    cpu: bool = False
    memory: bool = False
    device: bool = False  # torch.profiler trace around process_data
    output_path: str = "/tmp/curate_profile"
    top_n: int = 50


def profiling_wrapper(stage, config: ProfilingConfig):
    """Wrap a stage instance so its hot methods are profiled; the stage's
    class is subclassed at run time, so isinstance checks and every
    behavior survive. Returns the same instance."""
    cls = type(stage)

    class ProfiledStage(cls):  # type: ignore[misc, valid-type]
        def process_data(self, tasks):  # noqa: D102
            return _profiled_call(self, cls.process_data, config, tasks)

        def destroy(self):  # noqa: D102
            _flush_profiles(self, config)
            cls.destroy(self)

    # stage.name reads the _display_name an earlier wrapper set, so the
    # stage keeps its name through stacked wrappers
    display = stage.name
    stage.__class__ = ProfiledStage
    stage._profile_state = _ProfileState()  # type: ignore[attr-defined]
    stage._profile_name = display  # type: ignore[attr-defined]
    stage._display_name = display  # type: ignore[attr-defined]
    return stage


@dataclass
class _ProfileState:
    profiler: cProfile.Profile | None = None
    calls: int = 0
    mem_snapshots: list[str] = field(default_factory=list)
    device_traces: list[str] = field(default_factory=list)


def _device_profile(stage: Any):
    """A ``torch.profiler.profile`` for one call: CPU activity, and CUDA
    activity when the stage claims a GPU."""
    import torch.profiler

    activities = [torch.profiler.ProfilerActivity.CPU]
    if stage.resources.uses_gpu:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def _profiled_call(stage: Any, fn, config: ProfilingConfig, tasks):
    state: _ProfileState = stage._profile_state
    state.calls += 1
    exclusive = config.cpu or config.device
    if exclusive:
        _PROFILER_LOCK.acquire()
    prof = None
    try:
        if config.device:
            prof = _device_profile(stage)
            prof.__enter__()
        if config.memory and not tracemalloc.is_tracing():
            tracemalloc.start()
        if config.cpu:
            if state.profiler is None:
                state.profiler = cProfile.Profile()
            state.profiler.enable()
        try:
            return fn(stage, tasks)
        finally:
            if config.cpu and state.profiler is not None:
                state.profiler.disable()
            if config.memory:
                current, peak = tracemalloc.get_traced_memory()
                state.mem_snapshots.append(f"call {state.calls}: current={current} peak={peak}")
                tracemalloc.reset_peak()
            if prof is not None:
                if stage.resources.uses_gpu:
                    import torch

                    torch.cuda.synchronize()  # the call's kernels land in its trace
                prof.__exit__(None, None, None)
                trace_dir = f"{config.output_path}/device/{stage._profile_name}"
                os.makedirs(trace_dir, exist_ok=True)
                path = f"{trace_dir}/trace-{os.getpid()}-{state.calls}.json"
                prof.export_chrome_trace(path)
                state.device_traces.append(path)
    finally:
        if exclusive:
            _PROFILER_LOCK.release()


def _flush_profiles(stage: Any, config: ProfilingConfig) -> None:
    state: _ProfileState | None = getattr(stage, "_profile_state", None)
    if state is None:
        return
    name = getattr(stage, "_profile_name", type(stage).__name__)
    pid = os.getpid()
    if config.cpu and state.profiler is not None:
        buf = io.StringIO()
        pstats.Stats(state.profiler, stream=buf).sort_stats("cumulative").print_stats(config.top_n)
        write_bytes(f"{config.output_path}/cpu/{name}-{pid}.txt", buf.getvalue().encode())
    if config.memory and state.mem_snapshots:
        write_bytes(f"{config.output_path}/memory/{name}-{pid}.txt", "\n".join(state.mem_snapshots).encode())
    logger.info("profiling artifacts flushed for %s (%d calls)", name, state.calls)
