"""Egomotion trajectories for AV clips (port of
``cosmos_curate_tpu/pipelines/av/trajectory.py``).

Global inter-frame translation by phase correlation, on the card: a Hann
window over consecutive grayscale frames, ``torch.fft.rfft2``, the
normalised cross-power spectrum, ``irfft2`` and the argmax of the
correlation surface give each pair's displacement. One program a clip,
batched over its frame pairs (no Python a frame); the frame stack is padded
to its power-of-two bucket by repeating the last frame, as the reference
pads it. The cumulative sum of the displacements is the clip's 2D
trajectory in pixels, with summary stats (path length, net displacement,
max step) that classify the drive segment (straight / turning /
stationary); ``run_av_trajectory`` writes them per clip with the ego-motion
tags of pipelines/av/ego_tags.py.
"""

from __future__ import annotations

import json
import time
import uuid
from pathlib import Path

import numpy as np
import torch

from cosmos_curate_tpu_torch import __version__
from cosmos_curate_tpu_torch.core.model import model_device
from cosmos_curate_tpu_torch.models.batching import pad_batch
from cosmos_curate_tpu_torch.pipelines.av.ego_tags import derive_ego_tags
from cosmos_curate_tpu_torch.pipelines.av.state_db import CAPTION_VERSION, ClipTagRow, RunRow, open_state_db
from cosmos_curate_tpu_torch.storage.client import read_bytes
from cosmos_curate_tpu_torch.video.decode import extract_frames_at_fps

# trajectory frames: sampled at this rate and resized to this size
TRAJECTORY_FPS = 4.0
TRAJECTORY_HW = (128, 128)


def correlation_surface(gray: torch.Tensor) -> torch.Tensor:
    """gray [T, H, W] float32 -> the phase-correlation surface of each
    consecutive pair, [T-1, H, W]: IFFT(F1 * conj(F2) / |.|) of the
    Hann-windowed frames."""
    _, h, w = gray.shape
    window = torch.outer(torch.hann_window(h, periodic=False, dtype=torch.float32, device=gray.device),
                         torch.hann_window(w, periodic=False, dtype=torch.float32, device=gray.device))
    f = torch.fft.rfft2(gray * window)
    cross = f[:-1] * torch.conj(f[1:])
    cross = cross / torch.clamp(torch.abs(cross), min=1e-9)
    return torch.fft.irfft2(cross, s=(h, w))


@torch.inference_mode()
def phase_correlate_pairs(gray: torch.Tensor) -> torch.Tensor:
    """gray [T, H, W] float32 -> per-pair displacement [T-1, 2] (dx, dy),
    the correlation peak wrapped from FFT coordinates into [-H/2, H/2)."""
    _, h, w = gray.shape
    corr = correlation_surface(gray)
    flat_idx = corr.reshape(corr.shape[0], -1).argmax(dim=-1)
    py = flat_idx // w
    px = flat_idx % w
    # wrap: a peak at H-2 means displacement -2
    dy = torch.where(py > h // 2, py - h, py).to(torch.float32)
    dx = torch.where(px > w // 2, px - w, px).to(torch.float32)
    return torch.stack([dx, dy], dim=-1)


def estimate_trajectory(frames_u8: np.ndarray, *, device: str | torch.device = "cuda") -> dict:
    """uint8 [T, H, W, 3] -> trajectory dict, the correlation on
    ``device`` ("cuda" unless the caller asks for the CPU).

    Returns: ``positions`` [T, 2] cumulative (x, y) displacement in pixels
    (position 0 is the origin), ``steps`` [T-1, 2], and summary stats."""
    if frames_u8.shape[0] < 2:
        zeros = np.zeros((frames_u8.shape[0], 2), np.float32)
        return {
            "positions": zeros,
            "steps": np.zeros((0, 2), np.float32),
            "path_length": 0.0,
            "net_displacement": 0.0,
            "max_step": 0.0,
            "motion_class": "stationary",
        }
    dev = model_device(device, "the trajectory estimator")
    # grayscale on the host, as the reference computes it; the stack is
    # padded to its pow2 bucket by repeating the last frame
    gray = frames_u8.astype(np.float32).mean(axis=-1) / 255.0
    padded, n = pad_batch(gray)
    steps = phase_correlate_pairs(torch.from_numpy(np.ascontiguousarray(padded)).to(dev)).cpu().numpy()[: n - 1]
    positions = np.concatenate([np.zeros((1, 2), np.float32), np.cumsum(steps, axis=0)], axis=0)
    lengths = np.hypot(steps[:, 0], steps[:, 1])
    path_length = float(lengths.sum())
    net = float(np.hypot(*positions[-1]))
    max_step = float(lengths.max()) if len(lengths) else 0.0
    # simple drive-segment classification on the displacement geometry
    if path_length < 1.0 * len(steps) * 0.05 + 1.0:
        motion = "stationary"
    elif net > 0.7 * path_length:
        motion = "straight"
    else:
        motion = "turning"
    return {
        "positions": positions,
        "steps": steps,
        "path_length": path_length,
        "net_displacement": net,
        "max_step": max_step,
        "motion_class": motion,
    }


def run_av_trajectory(args) -> dict:
    """Per-clip trajectory artifacts for every split, captioned or
    packaged clip: ``trajectories/<uuid>.npy`` (positions), a stats row in
    ``trajectories/stats.json``, and one ``clip_tag`` row a clip with the
    ego-motion taxonomy derived from the trajectory. The correlation runs
    on ``args.device``."""
    t0 = time.monotonic()
    root = args.output_path.rstrip("/")
    if "://" in root:
        # clips are read through the URL-aware storage client, but
        # trajectories are written with local paths: a remote output root
        # would land in a local "s3:/..." directory
        raise ValueError(
            f"av trajectory writes locally; output_path {root!r} must be a "
            "local directory (sync to object storage afterwards)"
        )
    device = model_device(args.device, "the trajectory estimator")
    db = open_state_db(args.resolved_db)
    stats = []
    tag_rows = []
    run_uuid = str(uuid.uuid4())
    try:
        todo = [r for r in db.clips() if r.state in ("split", "captioned", "packaged")]
        if args.limit:
            todo = todo[: args.limit]
        out_dir = Path(root) / "trajectories"
        out_dir.mkdir(parents=True, exist_ok=True)
        for row in todo:
            try:
                clip_bytes = read_bytes(f"{root}/clips/{row.clip_uuid}.mp4")
            except FileNotFoundError:
                continue
            frames = extract_frames_at_fps(clip_bytes, target_fps=TRAJECTORY_FPS, resize_hw=TRAJECTORY_HW)
            if frames.shape[0] < 2:
                continue
            traj = estimate_trajectory(frames, device=device)
            np.save(out_dir / f"{row.clip_uuid}.npy", traj["positions"])
            ego = derive_ego_tags(traj["positions"], fps=TRAJECTORY_FPS)
            tag_rows.append(ClipTagRow(clip_uuid=row.clip_uuid, version=CAPTION_VERSION, run_uuid=run_uuid, **ego))
            stats.append(
                {
                    "clip_uuid": row.clip_uuid,
                    "camera": row.camera,
                    "path_length": traj["path_length"],
                    "net_displacement": traj["net_displacement"],
                    "motion_class": traj["motion_class"],
                    **ego,
                }
            )
        (out_dir / "stats.json").write_text(json.dumps(stats, indent=1))
        db.add_clip_tags(tag_rows)
        if tag_rows:
            db.add_run(RunRow(run_uuid=run_uuid, run_type="trajectory", pipeline_version=__version__))
        return {
            "num_trajectories": len(stats),
            "num_clip_tags": len(tag_rows),
            "elapsed_s": time.monotonic() - t0,
        }
    finally:
        db.close()
