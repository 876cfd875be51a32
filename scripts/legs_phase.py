"""``chip_smoke.py``'s split-leg phases (the motion filter, the NCC and
siamese trackers, super resolution, and run F through ``run_split``), which
``chip_smoke.py`` runs after its index phases, or alone on the card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/legs_phase.py

Alone, it builds the kernels, checks flash at ``chip_smoke.FLASH_CASES`` and
writes the first ``LEGS_VIDEOS`` videos of the split corpus. Every check
holds the card to the port's CPU path or to a stated bound, and raises on a
failure. One JSON line per phase:

- ``motion``: ``MOTION_CLIPS_PER_KIND`` clips of each calibration kind
  (this script's copy of ``benchmarks/motion_calibration.py``'s
  ``make_fixture``: static, textured static, pan, slow pan, jitter, a
  corner box) at 1280x720, 24 fps, 1 s, mp4v, through
  ``MotionFilterStage(backend="frame-diff")`` on the card: every score
  within ``MOTION_REL`` of the CPU path's and the same clips filtered,
  every static clip filtered and every full-frame moving clip (pans,
  jitter) kept at the default threshold 0.004 (the small corner box scores
  under it at 1 s, as in the reference: ``SMALL_OBJECT_KINDS``); clips/s,
  device launches a clip and the device's idle share.
- ``tracking``: the NCC tracker, then the siamese tracker (a seeded
  ``tracker-siamese-tpu`` checkpoint staged in a temporary weights dir, so
  ``TrackingStage(mode="auto")`` takes the learned path), each on the
  moving-box clip of ``tests/pipelines/test_tracking.py`` scaled to
  1280x720 (boxes equal to the CPU path's and within the reference test's
  error bounds, scaled) and on ``TRACK_CLIPS`` one-second corpus clips
  (agreement with the CPU path); ms a frame, launches a frame, idle share.
- ``sr``: one ``SR_FRAMES``-frame window of a corpus clip at 1280x720
  through the diffusion model at ``DIFF_SR_BASE`` (its final conv drawn
  non-zero) and through ``SRNet`` at ``SR_BASE``: bf16 on the card against
  the same module in fp32 on the card (``SR_DIFF_BOUND``,
  ``SR_NET_BOUND``), frames/s, the chunk group and the peak memory.
- ``legs_split`` (run F): the first ``LEGS_VIDEOS`` corpus videos through
  ``run_split`` with the motion filter, tracking (annotated) and per-event
  captions beside captions at ``caption_model="base"``: every clip scored,
  every tracked clip with one event caption a track and its
  ``tracking/<uuid>.mp4``, no clip errors, and flash, paged prefill,
  prefill and paged decode launched; then the first half second of one
  corpus video with ``sr=True`` (the diffusion variant at its defaults:
  one window), every written clip at 2560x1440.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

MOTION_KINDS = ("static", "static_tex", "pan", "slow_pan", "jitter", "corner_box")
STATIC_KINDS = ("static", "static_tex")
# a 2%-of-frame box: at 1 s (four 4-fps samples) it scores 1e-4 to 3.6e-3 in
# either package, at 240x320 as at 1280x720, under the default 0.004, so
# the card is held to the CPU path's decision there, not to "kept"
SMALL_OBJECT_KINDS = ("corner_box",)
# 4 since the train phase joined the full call (8 before)
MOTION_CLIPS_PER_KIND = 4
MOTION_H, MOTION_W, MOTION_FRAMES = 720, 1280, 24
MOTION_REL = 1e-5  # card vs CPU, relative, on each score
MOTION_THRESHOLD = 0.004  # the stage's default
# one-second clips of the first corpus videos: 16 since the train phase
# joined the full call (32 before)
TRACK_CLIPS = 16
NCC_TOL = 1e-5  # rtol and atol of the NCC scores, card vs CPU
SIAMESE_ATOL, SIAMESE_RTOL = 1e-4, 1e-3
# 8 frames (2 chunks of the window): 16 before the av phase joined the call,
# 24 before the engine phase did (the full call's time, PERF.md §5)
SR_FRAMES = 8
# bf16 vs fp32 on the card, max abs error over the largest magnitude of
# each model's residual: the diffusion model's after 8 DDIM steps (errors
# compound through the steps; the CPU tests read 5.9e-3 after 2), SRNet's
# before the base is added and the sum clipped (a seeded SRNet's residual
# reaches ~7, so the clipped image's error reads ~6x larger: 0.058 of 1.0
# on the card, 0.0092 of the residual on the CPU)
SR_DIFF_BOUND = 5e-2
SR_NET_BOUND = 2e-2
# run F's videos: 2 since the remote phase joined the call (4 before, 8
# before the engine phase; the full call's time, PERF.md §5)
LEGS_VIDEOS = 2
# run F's super-resolution split: the first half second of corpus video 0
# (one 12-frame clip, one window of 3 chunks: 24 UNet evaluations at
# 2560x1440; a whole 4-s video took 145 s)
SR_SPLIT_FRAMES = 12
SR_SPLIT_CLIPS = 1
LEGS_CAPTION_MODEL = "base"
LEGS_KERNELS = ("paged_decode", "paged_prefill", "prefill", "flash")


def make_fixture(kind: str, seed: int, *, h: int, w: int, t: int) -> np.ndarray:
    """``benchmarks/motion_calibration.py``'s calibration clip, the corner
    box scaled with the frame (the reference draws it for 240x320: at
    1280x720 an unscaled 40-pixel box covers 0.17% of the frame), and the
    texture drawn as uint8 (the reference draws int64 and casts: 88 MB a
    clip at this size)."""
    r = np.random.default_rng(seed)
    base = r.integers(30, 220, 3)
    tex = r.integers(0, 255, (h * 2, w * 2, 3), dtype=np.uint8)
    s = h / 240
    frames = np.zeros((t, h, w, 3), np.uint8)
    for i in range(t):
        if kind == "static":
            frames[i] = base
        elif kind == "static_tex":
            frames[i] = tex[:h, :w]
        elif kind == "pan":
            off = int(i * 1.5)
            frames[i] = tex[10 : 10 + h, off : off + w]
        elif kind == "slow_pan":
            off = int(i * 0.5)
            frames[i] = tex[10 : 10 + h, off : off + w]
        elif kind == "jitter":
            dy, dx = r.integers(-2, 3, 2)
            frames[i] = tex[20 + dy : 20 + dy + h, 20 + dx : 20 + dx + w]
        elif kind == "corner_box":
            frames[i] = base
            x = round((10 + i * 1.2) * s)
            frames[i, round(10 * s) : round(50 * s), x : x + round(40 * s)] = 255 - base
        else:
            raise ValueError(kind)
    return frames


def encoded_fixture(job: tuple[str, int, int, int, int]) -> bytes:
    from cosmos_curate_tpu_torch.video.encode import encode_frames

    kind, seed, h, w, t = job
    return encode_frames(make_fixture(kind, seed, h=h, w=w, t=t), 24.0)


def moving_box(t: int = 24, h: int = 720, w: int = 1280):
    """``tests/pipelines/test_tracking.py``'s moving box (128 px, a 24-px box
    at 3 px a frame) scaled to ``w`` x ``h``: frames, true x per frame, y,
    box width and height."""
    sx, sy = w / 128, h / 128
    bw, bh = round(24 * sx), round(24 * sy)
    rng = np.random.default_rng(0)
    frames = np.full((t, h, w, 3), 40, np.uint8)
    y = round(52 * sy)
    xs = np.asarray([round((10 + 3 * i) * sx) for i in range(t)])
    for i, x in enumerate(xs):
        frames[i, y : y + bh, x : x + bw] = (220, 180, 60)
    frames = np.clip(frames.astype(np.int16) + rng.integers(-5, 6, frames.shape), 0, 255).astype(np.uint8)
    return frames, xs, y, bw, bh, (sx, sy)


def profiled(fn) -> dict:
    """``fn()`` once under torch.profiler tracing the device: device
    launches and busy time, the traced wall and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    assert busy > 0, "the profiler traced no device time"
    return {"launches": sum(e.count for e in events), "device_busy_s": busy, "traced_wall_s": wall,
            "device_idle_share": 1.0 - busy / wall}


def _tasks(groups: dict[str, list[bytes]]):
    from cosmos_curate_tpu_torch.data.model import Clip, SplitPipeTask, Video

    return [SplitPipeTask(video=Video(path=name, clips=[Clip(source_video=f"{name}_{i}", encoded_data=p)
                                                        for i, p in enumerate(payloads)]))
            for name, payloads in groups.items()]


def drive_motion(cs, dev) -> tuple[dict, object]:
    """The card's part of the motion phase; returns its record and the
    comparison with the CPU path, to run later (``run``)."""
    from cosmos_curate_tpu_torch.pipelines.video.stages.motion_filter import MotionFilterStage

    t0 = time.monotonic()
    jobs = [(kind, seed, MOTION_H, MOTION_W, MOTION_FRAMES) for kind in MOTION_KINDS
            for seed in range(MOTION_CLIPS_PER_KIND)]
    # threads: cv2's encoder releases the interpreter lock, and spawned
    # processes would each import torch first
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        payloads = list(pool.map(encoded_fixture, jobs))
    fixture_s = time.monotonic() - t0
    groups = {kind: payloads[k * MOTION_CLIPS_PER_KIND : (k + 1) * MOTION_CLIPS_PER_KIND]
              for k, kind in enumerate(MOTION_KINDS)}
    card = MotionFilterStage(backend="frame-diff", device=dev)
    card.process_data(_tasks({"warm": payloads[:2]}))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = card.process_data(_tasks(groups))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof = profiled(lambda: card.process_data(_tasks(groups)))
    n = len(payloads)
    record = {"clips": n, "fixture": f"{MOTION_W}x{MOTION_H}, {MOTION_FRAMES} frames at 24 fps, mp4v",
              "fixture_build_s": fixture_s, "wall_s": wall, "clips_per_s": n / wall, "threshold": MOTION_THRESHOLD,
              "device_launches_per_clip": prof["launches"] / n, "device_idle_share": prof["device_idle_share"],
              "hand_written_kernel_launches": 0}

    def against_cpu() -> dict:
        cpu = MotionFilterStage(backend="frame-diff", device="cpu").process_data(_tasks(groups))
        worst = 0.0
        by_kind = {}
        for t_card, t_cpu in zip(out, cpu, strict=True):
            clips = {c.source_video: c for c in (*t_card.video.clips, *t_card.video.filtered_clips)}
            ref = {c.source_video: c for c in (*t_cpu.video.clips, *t_cpu.video.filtered_clips)}
            assert set(clips) == set(ref) and len(clips) == MOTION_CLIPS_PER_KIND
            for name, clip in clips.items():
                assert not clip.errors, f"motion: {name}: {clip.errors}"
                for got, want in ((clip.motion_score_global, ref[name].motion_score_global),
                                  (clip.motion_score_per_patch_min, ref[name].motion_score_per_patch_min)):
                    assert got is not None and want is not None, f"motion: {name} not scored"
                    err = abs(got - want) / max(abs(want), 1e-30) if want else abs(got)
                    assert err <= MOTION_REL, f"motion: {name}: card {got} vs CPU {want}"
                    worst = max(worst, err)
            kind = t_card.video.path
            filtered = len(t_card.video.filtered_clips)
            assert filtered == len(t_cpu.video.filtered_clips), f"motion: {kind}: the card filters other clips"
            if kind not in SMALL_OBJECT_KINDS:
                want_filtered = MOTION_CLIPS_PER_KIND if kind in STATIC_KINDS else 0
                assert filtered == want_filtered, f"motion: {filtered} {kind} clips filtered, want {want_filtered}"
            scores = [c.motion_score_global for c in clips.values()]
            by_kind[kind] = {"filtered": filtered, "global_min": min(scores), "global_max": max(scores)}
        return {"max_rel_err_vs_cpu": worst, "bound": MOTION_REL, "kinds": by_kind}

    return record, against_cpu


def corpus_clips(corpus: list[Path], n: int) -> list[np.ndarray]:
    """One-second (24-frame) clips of the first corpus videos, decoded."""
    from cosmos_curate_tpu_torch.video.decode import decode_frames

    clips = []
    for path in corpus:
        frames = decode_frames(str(path))
        clips += [frames[i : i + 24] for i in range(0, len(frames) - 23, 24)]
        if len(clips) >= n:
            break
    assert len(clips) >= n, f"tracking: {len(clips)} corpus clips"
    return clips[:n]


def save_flax_msgpack(path: Path, tree: dict) -> None:
    """A parameter tree in flax's msgpack layout (``flax.serialization.
    to_bytes``: arrays as extension type 1), as ``registry.load_params``
    reads it."""
    import msgpack

    def pack(node):
        if isinstance(node, dict):
            return {k: pack(v) for k, v in node.items()}
        arr = np.ascontiguousarray(node)
        return msgpack.ExtType(1, msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes()), use_bin_type=True))

    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(msgpack.packb(pack(tree), use_bin_type=True))


def stage_seeded_siamese(root: Path, seed: int) -> None:
    """A seeded ``tracker-siamese-tpu`` checkpoint under ``root`` (conv
    kernels back to flax's HWIO)."""
    from cosmos_curate_tpu_torch.models.tracker_learned import MODEL_ID, EmbedNet

    net = EmbedNet(32)
    net.init_weights(torch.Generator().manual_seed(seed))
    tree: dict = {}
    for name, value in net.state_dict().items():
        module, leaf = name.split(".")
        arr = value.numpy()
        tree.setdefault(module, {})["kernel" if leaf == "weight" else leaf] = (
            arr.transpose(2, 3, 1, 0) if leaf == "weight" else arr)
    save_flax_msgpack(root / MODEL_ID / "params.msgpack", {"params": tree})


def check_tracker(name: str, card, cpu, clips: list[np.ndarray], tol: tuple[float, float]) -> tuple[dict, object]:
    """One tracker on the card, on the scaled moving box and on ``clips``;
    returns its record and the comparison with ``cpu`` (the CPU path), to
    run later."""
    from cosmos_curate_tpu_torch.pipelines.video.stages.tracking import propose_motion_box

    atol, rtol = tol
    frames, xs, y, bw, bh, (sx, sy) = moving_box(h=MOTION_H, w=MOTION_W)
    box = (float(xs[0]), float(y), float(bw), float(bh))
    boxes, scores = card.track(frames, box)
    err = np.abs(boxes[:, 0] - xs)
    y_err = float(np.abs(boxes[:, 1] - y).mean())
    # the reference test's bounds at 128 px (final x < 8, mean x < 6, mean
    # y < 6), scaled with the frame
    assert err[-1] < 8 * sx and err.mean() < 6 * sx and y_err < 6 * sy, f"tracking: {name} lost the box: {err}"
    prompts = [propose_motion_box(c) for c in clips]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tracked = [card.track(c, p) for c, p in zip(clips, prompts)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof = profiled(lambda: [card.track(c, p) for c, p in zip(clips[:4], prompts[:4])])
    record = {"fixture": {"final_x_err_px": float(err[-1]), "mean_x_err_px": float(err.mean()),
                          "mean_y_err_px": y_err},
              "corpus_clips": len(clips), "ms_per_frame": 1e3 * wall / sum(len(c) for c in clips),
              "launches_per_frame": prof["launches"] / sum(len(c) for c in clips[:4]),
              "device_idle_share": prof["device_idle_share"]}

    def against_cpu() -> dict:
        want_boxes, want_scores = cpu.track(frames, box)
        assert np.array_equal(boxes, want_boxes), f"tracking: {name}: card boxes differ from the CPU path's"
        np.testing.assert_allclose(scores, want_scores, atol=atol, rtol=rtol, err_msg=f"tracking: {name} scores")
        equal = 0
        score_err = 0.0
        for (b, sc), c, p in zip(tracked, clips, prompts):
            wb, ws = cpu.track(c, p)
            equal += int(np.array_equal(b, wb))
            score_err = max(score_err, float(np.abs(sc - ws).max()))
        return {"fixture_boxes_equal_cpu": True, "corpus_boxes_equal_cpu": equal, "corpus_max_score_diff": score_err}

    return record, against_cpu


def drive_tracking(cs, dev, corpus: list[Path]) -> tuple[dict, object]:
    """Both trackers' card part; returns the record and the comparisons
    with the CPU path, to run later."""
    from cosmos_curate_tpu_torch.models.tracker import TemplateTracker
    from cosmos_curate_tpu_torch.models.tracker_learned import SiameseTracker
    from cosmos_curate_tpu_torch.pipelines.video.stages.tracking import TrackingStage

    clips = corpus_clips(corpus, TRACK_CLIPS)
    ncc, ncc_cpu = check_tracker("ncc", TemplateTracker(device=dev), TemplateTracker(device="cpu"), clips,
                                 (NCC_TOL, NCC_TOL))
    with tempfile.TemporaryDirectory(prefix="legs_weights-") as tmp, cs.staged_weights(Path(tmp)):
        stage_seeded_siamese(Path(tmp), cs.SEED)
        stage = TrackingStage(mode="auto", device=dev)
        stage.setup()
        assert isinstance(stage._tracker, SiameseTracker), "tracking: auto mode did not take the staged checkpoint"
        cpu = SiameseTracker(device="cpu")
        cpu.setup(require_weights=True)
        siamese, siamese_cpu = check_tracker("siamese", stage._tracker, cpu, clips, (SIAMESE_ATOL, SIAMESE_RTOL))
    record = {"ncc": ncc, "siamese": {"weights": "seeded, staged", **siamese}}

    def against_cpu() -> dict:
        return {"ncc": ncc_cpu(), "siamese": siamese_cpu()}

    return record, against_cpu


def _nonzero_final_conv(net, seed: int) -> None:
    with torch.no_grad():
        conv = getattr(net, net.conv_out)
        gen = torch.Generator().manual_seed(seed)
        conv.weight.copy_((torch.randn(conv.weight.shape, generator=gen) * 0.05).to(conv.weight.device))


def drive_sr(cs, dev, corpus: list[Path]) -> dict:
    from cosmos_curate_tpu_torch.models import diffusion_sr as dsr
    from cosmos_curate_tpu_torch.models import super_resolution as sr
    from cosmos_curate_tpu_torch.video.decode import decode_frames

    frames = decode_frames(str(corpus[0]))[:SR_FRAMES]
    h, w = cs.SPLIT_FRAME_H, cs.SPLIT_FRAME_W
    assert frames.shape == (SR_FRAMES, h, w, 3), frames.shape
    out = {"window": list(frames.shape)}
    with tempfile.TemporaryDirectory(prefix="legs_sr_weights-") as tmp, cs.staged_weights(Path(tmp)):
        model = dsr.DiffusionSRModel(dsr.DIFF_SR_BASE, device=dev)
        model.setup()
        _nonzero_final_conv(model.net, cs.SEED)
        # bf16 against the same module in fp32, on the window's first chunk
        # (the bf16 chunk first: it warms cuDNN up for the timed window)
        cfg = model.cfg
        x = torch.from_numpy(frames[: cfg.window]).to(dev)
        with torch.inference_mode(), dsr._fp32(dev):
            cond = sr.bilinear_up(x, cfg.scale)
            noise = dsr.chunk_noise(0, (cfg.window, *cond.shape[2:], 3)).to(dev).permute(0, 3, 1, 2)
            r16 = dsr.ddim_sample(model.net, cond, noise, cfg)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        up = model.upscale_window(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert up.shape == (SR_FRAMES, 2 * h, 2 * w, 3) and up.dtype == np.uint8
        peak = torch.cuda.max_memory_allocated(dev)
        with torch.inference_mode(), dsr._fp32(dev):
            model.net.compute_dtype = torch.float32
            try:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                r32 = dsr.ddim_sample(model.net, cond, noise, cfg)
                torch.cuda.synchronize()
                fp32_chunk_s = time.perf_counter() - t1
            finally:
                model.net.compute_dtype = torch.bfloat16
            scale = float(r32.abs().max())
            err = float((r16 - r32).abs().max()) / scale
            q16 = sr.to_uint8(torch.clamp(cond + r16, 0, 1)).int()
            q32 = sr.to_uint8(torch.clamp(cond + r32, 0, 1)).int()
            levels = (q16 - q32).abs()
        assert np.isfinite(err) and err <= SR_DIFF_BOUND, f"sr: diffusion bf16 vs fp32 {err} > {SR_DIFF_BOUND}"
        out["diffusion"] = {
            "cfg": "DIFF_SR_BASE", "final_conv": "drawn N(0, 0.05^2)", "wall_s": wall, "frames_per_s": SR_FRAMES / wall,
            "chunk_group": model.last_group, "chunks": SR_FRAMES // cfg.window, "peak_device_bytes": peak,
            "bf16_vs_fp32_first_chunk": {"max_abs_err_over_max": err, "bound": SR_DIFF_BOUND, "residual_max": scale,
                                         "uint8_max_levels": int(levels.max()),
                                         "uint8_mean_levels": float(levels.float().mean()),
                                         "fp32_chunk_s": fp32_chunk_s}}
        del model, x, cond, noise, r16, r32, q16, q32, levels
        gc.collect()
        torch.cuda.empty_cache()

        net_model = sr.SuperResolutionModel(sr.SR_BASE, device=dev)
        net_model.setup()
        net_model.upscale_window(frames[:2])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        up = net_model.upscale_window(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert up.shape == (SR_FRAMES, 2 * h, 2 * w, 3)
        peak = torch.cuda.max_memory_allocated(dev)
        net = net_model.net
        with torch.inference_mode(), dsr._fp32(dev):
            x = torch.from_numpy(frames).to(dev)
            r16, o16 = net.residual(x).float(), net(x, float_out=True)
            net.compute_dtype = torch.float32
            try:
                r32, o32 = net.residual(x), net(x, float_out=True)
            finally:
                net.compute_dtype = torch.bfloat16
            scale = float(r32.abs().max())
            err = float((r16 - r32).abs().max()) / scale
            clipped = float(((o32 <= 0) | (o32 >= 1)).float().mean())
            out_err = float((o16 - o32).abs().max())
        assert err <= SR_NET_BOUND, f"sr: SRNet bf16 vs fp32 {err} > {SR_NET_BOUND}"
        out["srnet"] = {"cfg": "SR_BASE", "wall_s": wall, "frames_per_s": SR_FRAMES / wall,
                        "peak_device_bytes": peak,
                        "bf16_vs_fp32": {"residual_max_abs_err_over_max": err, "bound": SR_NET_BOUND,
                                         "residual_max": scale, "output_max_abs_err": out_err,
                                         "output_clipped_share": clipped}}
        del net_model, net, x, r16, r32, o16, o32
    gc.collect()
    torch.cuda.empty_cache()
    return out


def first_frames_video(src: Path, dst: Path, n: int) -> None:
    """The first ``n`` frames of ``src`` re-encoded to ``dst`` (mp4v, 24 fps)."""
    import cv2

    from cosmos_curate_tpu_torch.video.decode import decode_frames

    frames = decode_frames(str(src), num_frames=n)
    writer = cv2.VideoWriter(str(dst), cv2.VideoWriter_fourcc(*"mp4v"), 24.0, (frames.shape[2], frames.shape[1]))
    assert writer.isOpened(), "cv2 cannot write mp4v here"
    for frame in frames:
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()


def drive_legs_split(cs, dev, timer, root: Path, corpus: list[Path]) -> dict:
    """Run F: the legs on corpus videos through ``run_split``, then one
    video through super resolution."""
    from cosmos_curate_tpu_torch.core.runner import default_runner
    from cosmos_curate_tpu_torch.models.vlm import SharedCaptionEngine
    from cosmos_curate_tpu_torch.pipelines.video import split
    from cosmos_curate_tpu_torch.pipelines.video.stages.motion_filter import MotionFilterStage
    from cosmos_curate_tpu_torch.pipelines.video.stages.per_event_caption import PerEventCaptionStage
    from cosmos_curate_tpu_torch.pipelines.video.stages.super_resolution import SuperResolutionStage
    from cosmos_curate_tpu_torch.pipelines.video.stages.tracking import TrackingStage
    from cosmos_curate_tpu_torch.pipelines.video.stages.writer import ClipWriterStage
    from cosmos_curate_tpu_torch.video.decode import decode_frames

    n_clips = LEGS_VIDEOS * cs.SPLIT_CLIPS // cs.SPLIT_VIDEOS
    videos = cs.subset(root, corpus, "videos_f", LEGS_VIDEOS)
    stage_classes = (MotionFilterStage, split.ClipEmbeddingStage, split.CaptionStage, TrackingStage,
                     PerEventCaptionStage, SuperResolutionStage, ClipWriterStage)
    args = replace(cs.split_args(videos, root / "out_f"), motion_filter="enable", tracking=True,
                   tracking_annotated=True, per_event_captions=True, captioning=True, caption_model=LEGS_CAPTION_MODEL,
                   device=dev.type)
    try:
        run = cs.split_run(dev, args, default_runner(), stage_classes)
    finally:
        SharedCaptionEngine.reset()
    summary = run["summary"]
    assert summary["num_clips"] == n_clips, f"run F: {summary['num_clips']} clips, want {n_clips}"
    for name in LEGS_KERNELS:
        assert run["launches"][name] > 0, f"run F: kernel {name} was not launched"
    out_f = root / "out_f"
    metas = [json.loads(p.read_text()) for p in (out_f / "metas").rglob("*.json")]
    assert len(metas) == n_clips
    tracked = events = 0
    for meta in metas:
        assert not meta["errors"], f"run F: clip errors {meta['errors']}"
        assert meta["motion_score_global"] is not None and meta["motion_score_per_patch_min"] is not None
        if meta["filtered_by"]:
            continue
        if meta["tracks"]:
            tracked += 1
            events += len(meta["event_captions"])
            assert len(meta["event_captions"]) == len(meta["tracks"]), "run F: one event caption a track"
            assert (out_f / "tracking" / f"{meta['uuid']}.mp4").is_file(), "run F: no annotated clip"
    assert tracked > 0, "run F: no clip tracked"
    new_shapes = cs.check_new_flash_shapes(timer, run["flash_shapes"], cs.SEED + 21)
    kept = [m for m in metas if not m["filtered_by"]]
    out = {"videos": LEGS_VIDEOS, "clips": n_clips, "kept": len(kept),
           "filtered_by_motion": summary["num_filtered_by_motion"], "tracked_clips": tracked, "event_captions": events,
           "nonempty_event_captions": sum(bool(c) for m in kept for c in m["event_captions"]),
           "motion_global_range": [min(m["motion_score_global"] for m in metas),
                                   max(m["motion_score_global"] for m in metas)],
           "wall_s": run["wall"], "launches": run["launches"], "stages": cs.stage_busy(run["spans"], run["wall"]),
           "peak_device_bytes": run["peak_device"], "flash_checked_here": new_shapes}

    sr_videos = root / "videos_f_sr"
    sr_videos.mkdir()
    first_frames_video(corpus[0], sr_videos / corpus[0].name, SR_SPLIT_FRAMES)
    sr_run = cs.split_run(dev, replace(cs.split_args(sr_videos, root / "out_f_sr", sr=True), device=dev.type),
                          default_runner(), stage_classes)
    sizes = set()
    for clip in (root / "out_f_sr" / "clips").glob("*.mp4"):
        first = decode_frames(str(clip), num_frames=1)
        sizes.add(first.shape[1:3])
    want = SR_SPLIT_CLIPS
    size = (2 * cs.SPLIT_FRAME_H, 2 * cs.SPLIT_FRAME_W)
    assert sr_run["summary"]["num_clips"] == want and sizes == {size}, f"run F (sr): {sizes}"
    metas = [json.loads(p.read_text()) for p in (root / "out_f_sr" / "metas").rglob("*.json")]
    assert len(metas) == want and not any(m["errors"] for m in metas)
    out["sr"] = {"videos": 1, "clips": want, "clip_size": list(size), "wall_s": sr_run["wall"],
                 "stages": cs.stage_busy(sr_run["spans"], sr_run["wall"]), "peak_device_bytes": sr_run["peak_device"],
                 "launches": sr_run["launches"]}
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run(cs, dev, timer, root: Path, corpus: list[Path], only: tuple[str, ...] = ()) -> dict:
    """The four leg phases in order (or those in ``only``), each line
    emitted once its record is whole; returns {phase: record}. The motion
    and tracking phases' comparisons with the CPU path run on a host thread
    while the card runs the sr phase (its device work leaves the host
    idle), and are joined before run F."""
    def wanted(name: str) -> bool:
        return not only or name in only

    def merge(into: dict, extra: dict) -> None:
        for key, value in extra.items():
            into[key] = {**into[key], **value} if isinstance(value, dict) and key in into else value

    out: dict = {}
    deferred = {}
    with ThreadPoolExecutor(max_workers=1) as host:
        for name, fn in (("motion", lambda: drive_motion(cs, dev)), ("tracking", lambda: drive_tracking(cs, dev, corpus))):
            if wanted(name):
                t0 = time.monotonic()
                out[name], check = fn()
                out[name]["phase_s"] = time.monotonic() - t0
                deferred[name] = host.submit(check)
        if wanted("sr"):
            t0 = time.monotonic()
            out["sr"] = {**drive_sr(cs, dev, corpus), "phase_s": time.monotonic() - t0}
            cs.emit({"phase": "sr", **out["sr"]})
        for name, future in deferred.items():
            t0 = time.monotonic()
            merge(out[name], future.result())
            out[name]["cpu_check_wait_s"] = time.monotonic() - t0
            cs.emit({"phase": name, **out[name]})
    if wanted("legs_split"):
        t0 = time.monotonic()
        out["legs_split"] = {**drive_legs_split(cs, dev, timer, root, corpus), "phase_s": time.monotonic() - t0}
        cs.emit({"phase": "legs_split", **out["legs_split"]})
    return out


def main() -> int:
    """``python3 scripts/legs_phase.py [phase ...]``: every phase, or the
    ones named (motion, tracking, sr, legs_split)."""
    if not torch.cuda.is_available():
        print("legs_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import pyarrow.parquet  # noqa: F401  (before any worker thread imports it)

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    started = time.monotonic()
    timer, build_s = cs.phase_prologue(dev)
    with cs.split_corpus(LEGS_VIDEOS) as (root, corpus, corpus_s):
        cs.emit({"phase": "legs_prologue", "build_s": build_s, "corpus_build_s": corpus_s})
        run(cs, dev, timer, root, corpus, only=tuple(sys.argv[1:]))
    cs.emit({"phase": "timing", "script_s": time.monotonic() - started})
    return 0


if __name__ == "__main__":
    sys.exit(main())
