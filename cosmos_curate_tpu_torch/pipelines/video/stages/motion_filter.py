"""Motion filter stage: drop (or score) near-static clips (port of
``cosmos_curate_tpu/pipelines/video/stages/motion_filter.py``).

Two estimators behind one stage:

- ``mv``: codec motion vectors through the native libavcodec binding
  (video/motion_vectors.py): per-frame mean |mv| / height globally, and the
  per-patch time-mean minimum;
- ``frame-diff``: the same two statistics from frame differences at
  ``sample_fps``, computed on ``device`` (``_motion_scores``).

``backend="auto"`` (the default) scores with motion vectors where the
binding builds and the clip's codec carries them, else by frame
difference: the reference's own rule. The H100 host has no libavcodec, so
there every clip scores by frame difference. The two estimators have
different scales, so each has its own thresholds.

A filtered clip gets ``filtered_by="motion"`` and moves to
``video.filtered_clips``; ``score_only`` keeps every clip with its scores.
A clip whose scoring fails on its data keeps its place with the error on
``clip.errors["motion"]``; a device fault propagates.

Every frame-difference score is dispatched through a ``DevicePipeline``
before any is read back, so the next clip's decode overlaps this clip's
device work. The reference pads each clip's frames to a power of two for
XLA's compile cache and masks the padding out; the port sends the frames
as they are (the masked statistics are the same).

The stage runs on ``device="cuda"`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch

from cosmos_curate_tpu_torch.core.model import model_device
from cosmos_curate_tpu_torch.core.stage import Resources, Stage
from cosmos_curate_tpu_torch.data.model import SplitPipeTask
from cosmos_curate_tpu_torch.models.device_pipeline import DevicePipeline
from cosmos_curate_tpu_torch.ops._build import DEVICE_FAULTS
from cosmos_curate_tpu_torch.utils.logging import get_logger
from cosmos_curate_tpu_torch.video.decode import extract_frames_at_fps

logger = get_logger(__name__)

_PATCH_GRID = 8


def _motion_scores(frames_u8: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 [T, H, W, 3] -> (global, patch_min): the mean absolute
    difference of consecutive gray frames, over the whole frame and per
    cell of an 8x8 grid (the minimum cell), each averaged over the T - 1
    differences."""
    gray = (frames_u8.to(torch.float32) / 255.0).mean(dim=-1)
    diff = (gray[1:] - gray[:-1]).abs()  # [T-1, H, W]
    t, h, w = diff.shape
    n = float(max(t, 1))
    global_score = diff.mean(dim=(1, 2)).sum() / n
    ph, pw = h // _PATCH_GRID, w // _PATCH_GRID
    patches = diff[:, : ph * _PATCH_GRID, : pw * _PATCH_GRID].reshape(t, _PATCH_GRID, ph, _PATCH_GRID, pw)
    per_patch = patches.mean(dim=(2, 4)).sum(dim=0) / n
    return global_score, per_patch.min()


class MotionFilterStage(Stage[SplitPipeTask, SplitPipeTask]):
    def __init__(
        self,
        *,
        score_only: bool = False,
        # the reference's thresholds for the frame-difference scale
        # (benchmarks/motion_calibration.py there): static clips score 0,
        # the weakest real motion about 0.06, a 40x40 box on 240x320 about
        # 0.01; the per-patch criterion is off by default
        global_threshold: float = 0.004,
        per_patch_threshold: float = 0.0,
        sample_fps: float = 4.0,
        decode_resize_hw: tuple[int, int] = (128, 128),
        backend: str = "auto",  # mv | frame-diff | auto
        # motion-vector scale: a 1 px/frame pan scores 1/height
        mv_global_threshold: float = 0.001,
        mv_patch_threshold: float = 0.0,
        device: str | torch.device = "cuda",
    ) -> None:
        if backend not in ("auto", "mv", "frame-diff"):
            raise ValueError(f"unknown motion backend {backend!r}")
        self.score_only = score_only
        self.global_threshold = global_threshold
        self.per_patch_threshold = per_patch_threshold
        self.sample_fps = sample_fps
        self.decode_resize_hw = decode_resize_hw
        self.backend = backend
        self.mv_global_threshold = mv_global_threshold
        self.mv_patch_threshold = mv_patch_threshold
        self.device = model_device(device, "the motion filter")
        self._pipe: DevicePipeline | None = None

    @property
    def resources(self) -> Resources:
        gpus = 0.25 if self.score_only else 0.5
        return Resources(cpus=1.0, gpus=gpus if self.device.type == "cuda" else 0.0)

    def _pipeline(self) -> DevicePipeline:
        if self._pipe is None:
            self._pipe = DevicePipeline("motion-filter", _motion_scores, device=self.device)
        return self._pipe

    def _score_mv(self, clip) -> tuple[float, float] | None:
        """Codec-MV scores, or None when the binding or the codec gives none."""
        from cosmos_curate_tpu_torch.video.motion_vectors import extract_mv_field, mv_motion_scores

        mv = extract_mv_field(clip.encoded_data)
        return None if mv is None else mv_motion_scores(mv)

    def process_data(self, tasks: list[SplitPipeTask]) -> list[SplitPipeTask]:
        # phase 1, score: MV scores resolve on the host at once; frame-diff
        # scores are dispatched as clips decode and read back in one drain
        pipe = self._pipeline()
        submitted = []
        decisions: dict[int, tuple[tuple[float, float] | None, tuple[float, float]]] = {}
        for task in tasks:
            for clip in task.video.clips:
                if clip.encoded_data is None:
                    continue
                thresholds = (self.mv_global_threshold, self.mv_patch_threshold)
                try:
                    scores = None
                    if self.backend in ("auto", "mv"):
                        try:
                            scores = self._score_mv(clip)
                        except Exception as e:
                            # in auto mode any MV failure falls through to
                            # frame difference
                            if self.backend == "mv":
                                raise
                            logger.warning("MV scoring failed for %s (%s); frame-diff", clip.uuid, e)
                    if scores is None and self.backend != "mv":
                        # the thresholds of the estimator that scores
                        thresholds = (self.global_threshold, self.per_patch_threshold)
                        frames = extract_frames_at_fps(clip.encoded_data, target_fps=self.sample_fps,
                                                       resize_hw=self.decode_resize_hw)
                        if frames.shape[0] >= 2:
                            pipe.submit(frames)
                            submitted.append(clip)
                    decisions[id(clip)] = (scores, thresholds)
                except DEVICE_FAULTS:
                    raise
                except Exception as e:
                    logger.warning("motion scoring failed for %s: %s", clip.uuid, e)
                    clip.errors["motion"] = str(e)
                    if pipe.pending == 0:
                        # the pipeline aborted: the scores in flight are
                        # gone; error those clips rather than misalign the
                        # drain
                        for lost in submitted:
                            lost.errors["motion"] = f"in-flight score lost to abort: {e}"
                            decisions.pop(id(lost), None)
                        submitted = []
        if submitted:
            for clip, (g, p) in zip(submitted, pipe.drain(), strict=True):
                decisions[id(clip)] = ((float(g), float(p)), decisions[id(clip)][1])
        # phase 2, filter: the thresholds in the original clip order
        for task in tasks:
            video = task.video
            kept = []
            for clip in video.clips:
                entry = decisions.get(id(clip))
                if entry is None or entry[0] is None:
                    kept.append(clip)  # nothing to score, or errored: keep
                    continue
                (g, p), thresholds = entry
                clip.motion_score_global, clip.motion_score_per_patch_min = g, p
                if self.score_only or (g >= thresholds[0] and p >= thresholds[1]):
                    kept.append(clip)
                else:
                    clip.filtered_by = "motion"
                    video.filtered_clips.append(clip)
            video.clips = kept
        return tasks
