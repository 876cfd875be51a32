"""``chip_smoke.py``'s ``engine`` phase, which ``chip_smoke.py`` runs right
after its ``observe`` phase on the split phase's corpus, or alone on the
card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/engine_phase.py

Alone, it builds the kernels, checks flash at ``chip_smoke.FLASH_CASES`` and
writes the corpus's first ``ENGINE_VIDEOS`` videos (about three minutes:
183 s of command on an H100 host). Every run has every kernel's launch
counter zeroed just before it and read just after. One JSON line,
``engine``, with these parts in order:

1. **saved and profiled run**: run B's settings (``VLM_BASE`` captions) on
   the first ``ENGINE_VIDEOS`` videos through the default runner, first
   plain (the baseline), then with ``stage_save_rate=1.0``,
   ``profile_cpu=True`` and ``profile_memory=True``: the same clip uuids
   and output files as the baseline (the profile and stage-save trees
   aside), embeddings within ``EMBED_BOUND``, every window captioned; a
   ``profile/cpu`` and a ``profile/memory`` artifact and saved batches for
   every stage, no saved task holding a CUDA tensor; both walls.
2. **embed replay**: ``ClipEmbeddingStage("video", device="cuda")`` over its
   saved batches; ``compare_tasks`` against the saved inputs of the stage
   after it passes at ``EMBED_BOUND``; flash launched.
3. **caption replay**: ``CaptionStage(model_flavor="base")`` over its saved
   batches: every window captioned, paged decode, paged prefill and prefill
   launched; the share of captions equal to the run's (bf16 greedy ties
   make it a report, not an assertion).
4. **device profile**: one embed call under
   ``ProfilingConfig(device=True)``: the Chrome trace's flash kernels
   (``tc_attention_kernel<FlashCta ...>``: CUPTI names the device function,
   the ctypes entry point is ``cct_flash``) equal in number to the call's
   counted launches; the call's wall beside an unprofiled call's.
5. **streaming runs**: the same videos through ``StreamingRunner`` in
   ``STREAMING`` mode (traced) and ``BATCH`` mode (on ``BATCH_CPUS`` of
   budget), and through
   ``MapRunner``: each with the baseline's uuids and files, embeddings
   within ``EMBED_BOUND``, every window captioned, the kernels of
   ``PIPELINE_KERNELS`` launched; the engine runs' object store on the
   native framing for every driver put; no CPU worker with a CUDA context
   (every child process of this one, sampled through the run: no
   ``/dev/nvidia<N>`` among its open files, which this process's own
   context shows, and its pid absent from ``nvidia-smi
   --query-compute-apps``; the CUDA libraries the workers map are
   reported). Walls beside the baseline's,
   worker spawn-to-ready seconds, objects and bytes through the store, its
   peak, and ``/dev/shm``'s free bytes.
6. **cli**: ``report``, ``top --once --json`` and ``dlq list --json`` as
   subprocesses of the port's command line on the traced streaming run's
   output and a planted dead-letter entry: exit code 0 and at least the
   keys the JAX package's command line prints (``REPORT_KEYS``,
   ``TOP_KEYS``, ``DLQ_KEYS``; tests/test_torch_cli.py holds these sets
   against the JAX command line).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import tracemalloc
from pathlib import Path

import numpy as np

# a spawned child (the corpus writers, the streaming engine's and the map
# runner's CPU workers) imports this script again as ``__mp_main__`` and runs
# none of its device code: it skips torch, as a worker of the command line
# (whose main module imports no torch) does
if __name__ != "__mp_main__":
    import torch

# the corpus's first video since the remote phase joined the call (2 before;
# the full call's time, PERF.md §5)
ENGINE_VIDEOS = 1
# BATCH mode hands each stage the whole CPU budget: at the host's 8 it
# spawned 74 workers for 2 videos (32 of them downloads; 36.79 s on the
# H100 host, PERF.md); the phase runs it on a budget of one CPU
BATCH_CPUS = 1.0
WATCH_INTERVAL_S = 0.25
NVIDIA_SMI_EVERY = 4  # of the watch's samples
CLI_TIMEOUT_S = 120
REPO = Path(__file__).resolve().parents[1]
FLASH_KERNEL = "FlashCta"
# what the JAX package's command line prints, at least (tests/test_torch_cli.py)
REPORT_KEYS = frozenset({
    "schema_version", "version", "generated_at", "output_path", "span_count", "trace_ids", "connected", "processes",
    "critical_path", "spans_by_name", "dispatch", "stage_flow", "caption_phases", "index_ops", "search",
    "object_plane", "anomalies", "stage_times", "wall_s", "dead_lettered", "report_path",
})
TOP_KEYS = frozenset({"schema_version", "version", "ts", "seq", "pid", "runner", "state", "wall_s", "stages",
                      "anomalies", "anomaly_count"})
DLQ_KEYS = frozenset({"entry", "stage", "batch_id", "num_tasks", "attempts", "worker_deaths", "reason", "error_tail",
                      "dropped_at", "run_id", "trace_id", "schema_version"})
SKIP_PREFIXES = ("profile/", "stage_save/", "report/")


def children(pid: int) -> list[int]:
    """Every live descendant of ``pid`` (from /proc), but the watch's own
    ``nvidia-smi`` calls."""
    parent: dict[int, int] = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        if stat.split("(", 1)[1].rsplit(")", 1)[0] == "nvidia-smi":
            continue
        parent[int(entry)] = int(stat.rsplit(")", 1)[1].split()[1])
    out, frontier = [], [pid]
    while frontier:
        p = frontier.pop()
        kids = [c for c, pp in parent.items() if pp == p]
        out.extend(kids)
        frontier.extend(kids)
    return out


def cuda_libraries(pid: int) -> list[str]:
    """The CUDA and NVIDIA libraries mapped in ``pid``."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            paths = {line.split()[-1] for line in f if "/" in line}
    except OSError:
        return []
    return sorted(p for p in paths if re.search(r"libcuda\.so|libnvidia|libcudart|libtorch_cuda", p))


def device_fds(pid: int) -> list[str]:
    """The GPU device nodes (``/dev/nvidia<N>``) ``pid`` holds open: a CUDA
    context opens its device's node; loading libcuda alone does not."""
    out = []
    try:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if re.fullmatch(r"/dev/nvidia\d+", target):
                out.append(target)
    except OSError:
        pass
    return sorted(set(out))


def compute_app_pids() -> set[int]:
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return {int(line.split(",")[0]) for line in out.stdout.splitlines() if line.strip() and line.split(",")[0].strip()
            .isdigit()}


@contextlib.contextmanager
def cuda_context_watch(out: dict):
    """Sample this process's children through the block: which of them
    hold a GPU device node open (a CUDA context), which map CUDA libraries
    (reported: a loaded library is no context), and which pids
    ``nvidia-smi`` lists as compute apps. This process, which owns the
    card, is the check's positive control."""
    stop = threading.Event()
    me = os.getpid()
    seen: set[int] = set()
    with_device: dict[int, list] = {}
    libraries: dict[int, list] = {}
    apps: set[int] = set()
    samples = [0]

    def sample() -> None:
        while not stop.is_set():
            kids = children(me)
            seen.update(kids)
            for k in kids:
                fds = device_fds(k)
                if fds:
                    with_device[k] = fds
                if k not in libraries:
                    libs = cuda_libraries(k)
                    if libs:
                        libraries[k] = libs
            if samples[0] % NVIDIA_SMI_EVERY == 0:
                apps.update(compute_app_pids())
            samples[0] += 1
            stop.wait(WATCH_INTERVAL_S)

    thread = threading.Thread(target=sample, daemon=True, name="cuda-context-watch")
    thread.start()
    try:
        yield
    finally:
        stop.set()
        thread.join(timeout=30)
        libs = collections.Counter(lib.rsplit("/", 1)[-1] for ls in libraries.values() for lib in ls)
        out.update(children_seen=len(seen), children_with_device_nodes={str(k): v for k, v in with_device.items()},
                   driver_device_nodes=device_fds(me), children_with_cuda_libraries=len(libraries),
                   cuda_libraries_in_children=dict(libs), compute_app_pids=sorted(apps),
                   children_in_compute_apps=sorted(seen & apps), driver_in_compute_apps=me in apps,
                   samples=samples[0])


def shm_free() -> dict:
    st = os.statvfs("/dev/shm")
    return {"free_bytes": st.f_bavail * st.f_frsize, "size_bytes": st.f_blocks * st.f_frsize}


def engine_run(cs, dev, a, runner, stage_classes, config=None) -> dict:
    """``chip_smoke.split_run`` with a pipeline config: one run_split with
    every launch counter zeroed just before it."""
    from cosmos_curate_tpu_torch.ops import kernels
    from cosmos_curate_tpu_torch.pipelines.video import split

    ks = kernels()
    for k in ks.values():
        k.launches = 0
    spans: list = []
    shapes: set = set()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with cs.timed_stages(stage_classes, spans), cs.recorded_flash_shapes(shapes):
        t0 = time.monotonic()
        summary = split.run_split(a, runner=runner, config=config)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    return dict(summary=summary, wall=wall, launches={name: k.launches for name, k in ks.items()}, spans=spans,
                flash_shapes=shapes, peak_device=torch.cuda.max_memory_allocated(dev))


def check_outputs(cs, label: str, out: Path, base: tuple, model: str) -> dict:
    """The baseline's clip uuids and output files (the profile, stage-save
    and report trees aside), embeddings within ``EMBED_BOUND``, every
    window captioned; the share of captions equal to the baseline's."""
    b_metas, b_embs, b_files = base
    metas, embs, files = cs.split_outputs(out, model)
    assert set(metas) == set(b_metas) and set(embs) == set(b_embs) == set(metas), f"{label}: clip uuids"

    def kept(fs):
        return {f for f in fs if not f.startswith(SKIP_PREFIXES)}

    assert kept(files) == kept(b_files), f"{label}: files {sorted(kept(files) ^ kept(b_files))}"
    diff = max(float(np.abs(embs[u] - b_embs[u]).max()) for u in embs)
    assert diff <= cs.EMBED_BOUND, f"{label}: embeddings {diff} > {cs.EMBED_BOUND}"
    windows = {(u, i): w["captions"].get("default") for u, m in metas.items() for i, w in enumerate(m["windows"])}
    assert windows and all(windows.values()), f"{label}: a window has no caption"
    b_windows = {(u, i): w["captions"].get("default") for u, m in b_metas.items() for i, w in enumerate(m["windows"])}
    same = sum(windows[k] == b_windows.get(k) for k in windows)
    return dict(clips=len(metas), windows=len(windows), max_abs_embedding_diff=diff,
                captions_equal_share=same / len(windows))


def flat_tasks(batches: list) -> list:
    return sorted((t for batch in batches for t in (batch or [])), key=lambda t: t.video.path)


def replay(cs, stage, saved_root: str) -> tuple[list, dict, set, float]:
    """``run_stage_replay`` with the launches counted and flash shapes
    recorded: (output batches, launches, flash shapes, seconds)."""
    from cosmos_curate_tpu_torch.observability.stage_replay import run_stage_replay

    launches: dict = {}
    shapes: set = set()
    with cs.counted_launches(launches), cs.recorded_flash_shapes(shapes):
        t0 = time.monotonic()
        out = run_stage_replay(stage, saved_root)
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
    return out, launches, shapes, seconds


def embed_stage(cs):
    """The split's embed stage as ``run_split`` builds it for the phase's
    runs (its frames at the runs' first extraction rate), on the card."""
    from cosmos_curate_tpu_torch.data.model import FrameExtractionSignature
    from cosmos_curate_tpu_torch.pipelines.video.stages.embedding import ClipEmbeddingStage

    fps = cs.split_args(Path("."), Path(".")).extract_fps[0]
    return ClipEmbeddingStage(variant="video", extraction=FrameExtractionSignature("fps", fps), device="cuda")


def device_profile(cs, saved_root: str, tmp: Path) -> dict:
    """One embed call under ``ProfilingConfig(device=True)``: the trace's
    flash kernels against the call's counted launches."""
    from cosmos_curate_tpu_torch.core.stage import NodeInfo, WorkerMetadata
    from cosmos_curate_tpu_torch.observability.profiling import ProfilingConfig, profiling_wrapper
    from cosmos_curate_tpu_torch.observability.stage_replay import load_saved_batches

    batch = load_saved_batches(saved_root, "ClipEmbeddingStage")[0]
    stage = embed_stage(cs)
    meta = WorkerMetadata(worker_id="profile-0", stage_name=stage.name, node=NodeInfo(node_id="profile"))
    stage.setup(meta)
    stage.process_data(batch)  # warm-up
    torch.cuda.synchronize()
    t0 = time.monotonic()
    stage.process_data(batch)
    torch.cuda.synchronize()
    plain_s = time.monotonic() - t0
    profiling_wrapper(stage, ProfilingConfig(device=True, output_path=str(tmp)))
    launches: dict = {}
    with cs.counted_launches(launches):
        t0 = time.monotonic()
        stage.process_data(batch)
        profiled_s = time.monotonic() - t0
    stage.destroy()
    traces = sorted((tmp / "device" / "ClipEmbeddingStage").glob("trace-*.json"))
    assert len(traces) == 1, f"device profile: traces {traces}"
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    flash = [e for e in kernels if FLASH_KERNEL in e.get("name", "")]
    assert launches["flash"] > 0 and len(flash) == launches["flash"], \
        f"device profile: {len(flash)} flash kernels in the trace, {launches['flash']} launches counted"
    names = collections.Counter(re.sub(r"\(.*", "", e["name"])[:120] for e in kernels)
    return dict(trace_bytes=traces[0].stat().st_size, kernel_events=len(kernels), flash_events=len(flash),
                flash_launches=launches["flash"], flash_kernel_name=flash[0]["name"][:200],
                flash_device_ms=sum(e.get("dur", 0.0) for e in flash) / 1e3,
                top_kernels=dict(names.most_common(8)), unprofiled_call_s=plain_s, profiled_call_s=profiled_s)


def cli(argv: list[str], env: dict | None = None) -> dict:
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-m", "cosmos_curate_tpu_torch.cli.main", *argv], capture_output=True,
                         text=True, timeout=CLI_TIMEOUT_S, cwd=REPO, env={**os.environ, **(env or {})})
    return {"rc": out.returncode, "stdout": out.stdout, "stderr": out.stderr[-2000:], "wall_s": time.monotonic() - t0}


def check_cli(out_stream: Path, dlq_root: Path) -> dict:
    """``report``, ``top --once --json`` and ``dlq list --json`` as
    subprocesses, on the traced streaming run and a planted DLQ entry."""
    from cosmos_curate_tpu_torch.engine.dead_letter import DeadLetterQueue

    DeadLetterQueue(str(dlq_root)).record(stage_name="PlantedStage", batch_id=0, tasks=[{"planted": True}],
                                          attempts=1, worker_deaths=0, reason="planted by the engine phase")
    report = cli(["report", str(out_stream), "--json"])
    top = cli(["top", str(out_stream), "--once", "--json"])
    dlq = cli(["dlq", "list", "--json", "--dlq-dir", str(dlq_root)])
    text = cli(["report", str(out_stream)])
    for name, run in (("report", report), ("top", top), ("dlq", dlq), ("report_text", text)):
        assert run["rc"] == 0, f"cli {name}: rc {run['rc']}: {run['stderr']}"
    rep, snap, entries = json.loads(report["stdout"]), json.loads(top["stdout"]), json.loads(dlq["stdout"])
    assert REPORT_KEYS <= set(rep), f"report keys lack {sorted(REPORT_KEYS - set(rep))}"
    assert TOP_KEYS <= set(snap) and snap["state"] == "finished", f"top keys lack {sorted(TOP_KEYS - set(snap))}"
    assert len(entries) == 1 and DLQ_KEYS <= set(entries[0]), f"dlq entries {entries}"
    assert rep["connected"] and rep["processes"] >= 2, f"report: connected {rep['connected']}, {rep['processes']}"
    assert "CONNECTED" in text["stdout"], text["stdout"][:400]
    return {name: {"rc": run["rc"], "wall_s": run["wall_s"]} for name, run in
            (("report", report), ("top", top), ("dlq", dlq), ("report_text", text))} | {
        "report": {"rc": report["rc"], "wall_s": report["wall_s"], "connected": rep["connected"],
                   "processes": rep["processes"], "span_count": rep["span_count"], "keys": sorted(rep)},
        "top_keys": sorted(snap), "dlq_keys": sorted(entries[0])}


def drive_engine(cs, dev, timer, root: Path, corpus: list[Path]) -> dict:
    """The phase on the corpus's first ``ENGINE_VIDEOS`` videos."""
    from cosmos_curate_tpu_torch.core.map_runner import MapRunner
    from cosmos_curate_tpu_torch.core.pipeline import ExecutionMode, PipelineConfig
    from cosmos_curate_tpu_torch.core.runner import default_runner
    from cosmos_curate_tpu_torch.engine.runner import StreamingRunner
    from cosmos_curate_tpu_torch.models.embedder import VIDEO_EMBED_VARIANTS
    from cosmos_curate_tpu_torch.models.vlm import SharedCaptionEngine
    from cosmos_curate_tpu_torch.native import load_native, native_error
    from cosmos_curate_tpu_torch.observability.stage_compare import compare_tasks
    from cosmos_curate_tpu_torch.observability.stage_replay import cuda_tensor_paths, load_saved_batches
    from cosmos_curate_tpu_torch.pipelines.video import split as tsplit
    from cosmos_curate_tpu_torch.pipelines.video.stages.captioning import CaptionStage
    from cosmos_curate_tpu_torch.pipelines.video.stages.writer import ClipWriterStage

    stage_classes = (
        tsplit.VideoDownloadStage, tsplit.FixedStrideExtractorStage, tsplit.ClipTranscodingStage,
        tsplit.ClipFrameExtractionStage, tsplit.ClipEmbeddingStage, tsplit.CaptionPrepStage, tsplit.CaptionStage,
        ClipWriterStage,
    )
    stage_names = [cls.__name__ for cls in stage_classes]
    _, model = VIDEO_EMBED_VARIANTS["video"]
    videos = cs.subset(root, corpus, "videos_engine", ENGINE_VIDEOS)
    tmp = Path(tempfile.mkdtemp(prefix="engine_phase-"))
    out: dict = {"videos": ENGINE_VIDEOS, "shm_before": shm_free()}
    shapes: set = set()

    def args(name: str, **kw):
        return cs.split_args(videos, tmp / name, captioning=True, caption_model="base", **kw)

    def run(name: str, runner, config=None, **kw) -> dict:
        SharedCaptionEngine.reset()
        try:
            r = engine_run(cs, dev, args(name, **kw), runner, stage_classes, config)
        finally:
            SharedCaptionEngine.reset()
        shapes.update(r["flash_shapes"])
        return r

    # 1. the baseline, then the saved and profiled run, through the default runner
    base = run("base", default_runner())
    base_out = cs.split_outputs(tmp / "base", model)
    prof = run("profiled", default_runner(), stage_save_rate=1.0, profile_cpu=True, profile_memory=True)
    tracemalloc.stop()  # the memory profiler traces the whole process until stopped
    prof_check = check_outputs(cs, "profiled run", tmp / "profiled", base_out, model)
    for kind in ("cpu", "memory"):
        have = {re.sub(r"-\d+\.txt$", "", p.name) for p in (tmp / "profiled" / "profile" / kind).glob("*.txt")}
        assert have == set(stage_names), f"profiled run: {kind} artifacts for {sorted(have)}"
    saved_root = str(tmp / "profiled" / "stage_save")
    saved = {name: load_saved_batches(saved_root, name) for name in stage_names}
    assert all(saved.values()), f"profiled run: no saved batches for {[n for n, b in saved.items() if not b]}"
    on_card = [p for name, batches in saved.items() for p in cuda_tensor_paths(batches, name)]
    assert not on_card, f"saved batches hold CUDA tensors at {on_card}"
    for name in cs.PIPELINE_KERNELS:
        assert prof["launches"][name] > 0, f"profiled run: kernel {name} was not launched"
    out["profiled"] = dict(
        **prof_check, wall_s=prof["wall"], unprofiled_wall_s=base["wall"], overhead_frac=prof["wall"] / base["wall"] - 1,
        saved_batches={name: len(b) for name, b in saved.items()},
        saved_bytes=sum(p.stat().st_size for p in Path(saved_root).rglob("*.pkl")),
        cpu_profile_top=next((tmp / "profiled" / "profile" / "cpu").glob("ClipEmbeddingStage-*.txt"))
        .read_text().splitlines()[:12],
        launches=prof["launches"], base_launches=base["launches"],
        stages=cs.stage_busy(prof["spans"], prof["wall"]), base_stages=cs.stage_busy(base["spans"], base["wall"]))

    # 2. the embed stage replayed over its saved batches, against the next stage's saved inputs
    embed_out, launches, embed_shapes, embed_s = replay(cs, embed_stage(cs), saved_root)
    shapes.update(embed_shapes)
    report = compare_tasks(flat_tasks(embed_out), flat_tasks(saved["CaptionPrepStage"]), atol=cs.EMBED_BOUND)
    assert report.ok(), report.summary()
    assert launches["flash"] > 0, "embed replay: flash was not launched"
    out["embed_replay"] = dict(batches=len(embed_out), tasks=report.total, passed=report.passed, seconds=embed_s,
                               launches=launches, atol=cs.EMBED_BOUND)

    # 3. the caption stage replayed over its saved batches
    SharedCaptionEngine.reset()
    try:
        cap_out, launches, cap_shapes, cap_s = replay(cs, CaptionStage(model_flavor="base", device="cuda"), saved_root)
    finally:
        SharedCaptionEngine.reset()
    shapes.update(cap_shapes)
    replayed = _window_captions(flat_tasks(cap_out))
    assert replayed and all(replayed.values()), "caption replay: a window has no caption"
    for name in ("paged_decode", "paged_prefill", "prefill"):
        assert launches[name] > 0, f"caption replay: kernel {name} was not launched"
    run_caps = {(u, i): w["captions"].get("default") for u, m in cs.split_outputs(tmp / "profiled", model)[0].items()
                for i, w in enumerate(m["windows"])}
    out["caption_replay"] = dict(batches=len(cap_out), windows=len(replayed), seconds=cap_s, launches=launches,
                                 captions_equal_share=sum(replayed[k] == run_caps.get(k) for k in replayed)
                                 / len(replayed))

    # 4. one embed call under the device profiler
    out["device_profile"] = device_profile(cs, saved_root, tmp / "device_profile")

    # 5. the streaming engine (STREAMING traced, BATCH) and the map runner
    assert load_native() is not None, f"the object store's native framing did not load: {native_error()}"
    out["native_framing"] = True
    dlq_root = tmp / "dlq"
    runs = {}
    for name, runner, config, kw in (
        ("streaming", StreamingRunner(), PipelineConfig(execution_mode=ExecutionMode.STREAMING), {"tracing": True}),
        ("batch", StreamingRunner(), PipelineConfig(execution_mode=ExecutionMode.BATCH, num_cpus=BATCH_CPUS), {}),
        ("map", MapRunner(), None, {}),
    ):
        watch: dict = {}
        with cuda_context_watch(watch):
            r = run(name, runner, config, **kw)
        rec = dict(check_outputs(cs, name, tmp / name, base_out, model), wall_s=r["wall"],
                   pipelined_wall_s=base["wall"], launches=r["launches"], cuda_watch=watch,
                   peak_device_memory_bytes=r["peak_device"], stage_times=dict(runner.stage_times))
        for kname in cs.PIPELINE_KERNELS:
            assert r["launches"][kname] > 0, f"{name}: kernel {kname} was not launched"
        assert watch["driver_device_nodes"], f"{name}: the watch sees no device node of the driver: {watch}"
        assert not watch["children_with_device_nodes"], f"{name}: CPU workers opened the card: {watch}"
        assert not watch["children_in_compute_apps"], f"{name}: CPU workers hold CUDA contexts: {watch}"
        assert watch["children_seen"] > 0, f"{name}: no worker process seen"
        if isinstance(runner, StreamingRunner):
            st = runner.store_stats
            assert st["driver_puts"] > 0 and st["driver_native_puts"] == st["driver_puts"], f"{name}: store {st}"
            ready = sorted(runner.worker_ready_s)
            rec.update(store=st, stage_counts=runner.stage_counts, workers=len(runner.worker_pids),
                       worker_ready_s={"n": len(ready), "min": ready[0], "median": ready[len(ready) // 2],
                                       "max": ready[-1]} if ready else None)
        runs[name] = rec
    out["runs"] = runs
    out["shm_after"] = shm_free()

    # 6. the command line on the traced streaming run and a planted DLQ entry
    out["cli"] = check_cli(tmp / "streaming", dlq_root)

    checked = {(tuple(shape), causal) for _, shape, causal in cs.FLASH_CASES}
    out["flash_checked_here"] = cs.check_new_flash_shapes(timer, shapes - checked, 17)
    out["launches"] = {name: sum(r["launches"][name] for r in (base, prof)) + out["embed_replay"]["launches"][name]
                       + out["caption_replay"]["launches"][name]
                       + sum(r["launches"][name] for r in runs.values())
                       for name in base["launches"]}
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def _window_captions(tasks: list) -> dict:
    """(clip uuid, window index) -> the window's default caption."""
    return {(str(c.uuid), i): w.caption.get("default") for t in tasks for c in t.video.clips
            for i, w in enumerate(c.windows)}


def run(cs, dev, timer, root: Path, corpus: list[Path]) -> dict:
    """The phase, its line emitted as it ends; returns the record."""
    t0 = time.monotonic()
    record = {**drive_engine(cs, dev, timer, root, corpus), "phase_s": time.monotonic() - t0}
    cs.emit({"phase": "engine", **record})
    runs = record["runs"]
    print(f"engine: profiled {record['profiled']['wall_s']:.3f} s vs {record['profiled']['unprofiled_wall_s']:.3f} s; "
          + "; ".join(f"{name} {r['wall_s']:.3f} s" for name, r in runs.items())
          + f"; phase {record['phase_s']:.1f} s", flush=True)
    return record


def main() -> int:
    if not torch.cuda.is_available():
        print("engine_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    # pyarrow imported first in a worker thread has crashed a later read in
    # the main thread (pyarrow 25): import it here
    import pyarrow.parquet  # noqa: F401

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    started = time.monotonic()
    timer, build_s = cs.phase_prologue(dev)
    with cs.split_corpus(ENGINE_VIDEOS) as (root, corpus, corpus_s):
        cs.emit({"phase": "corpus", "videos": len(corpus), "build_s": corpus_s, "kernel_build_s": build_s})
        run(cs, dev, timer, root, corpus)
    cs.emit({"phase": "timing", "script_s": time.monotonic() - started})
    return 0


if __name__ == "__main__":
    sys.exit(main())
