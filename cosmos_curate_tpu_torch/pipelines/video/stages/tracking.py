"""Object-tracking stage: a motion prompt per clip -> a per-frame track
(and an annotated mp4) (port of
``cosmos_curate_tpu/pipelines/video/stages/tracking.py``).

The prompt is the clip's region of most inter-frame motion
(``propose_motion_box``, on the host over a downsampled copy). ``mode``
picks the tracker:

- ``learned``: the siamese tracker (models/tracker_learned.py), which needs
  a staged ``tracker-siamese-tpu`` checkpoint;
- ``ncc``: the NCC template tracker (models/tracker.py);
- ``auto``: learned when a checkpoint is staged, else NCC. A staged
  checkpoint that does not load falls back to NCC with a warning, as the
  reference does (NCC is a working tracker, not random logits).

Siamese scores are on their own scale, so the learned tracker uses
``learned_min_score``. A track whose mean score is below the minimum is
dropped. The tracks land in ``clip.tracks``; with ``write_annotated`` the
clip's frames with the boxes drawn land in ``clip.annotated_mp4``, which
the writer saves as ``tracking/<uuid>.mp4``.

A clip whose track fails on its data (a decode or codec error) keeps its
place with the error on ``clip.errors["tracking"]``; a device fault
propagates. The trackers run on ``device="cuda"`` unless the caller asks
for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from cosmos_curate_tpu_torch.core.model import model_device
from cosmos_curate_tpu_torch.core.stage import Resources, Stage, WorkerMetadata
from cosmos_curate_tpu_torch.data.model import SplitPipeTask
from cosmos_curate_tpu_torch.models.tracker import TemplateTracker, TrackerConfig
from cosmos_curate_tpu_torch.ops._build import DEVICE_FAULTS
from cosmos_curate_tpu_torch.utils.logging import get_logger
from cosmos_curate_tpu_torch.video.decode import decode_frames, extract_video_metadata
from cosmos_curate_tpu_torch.video.encode import encode_frames

logger = get_logger(__name__)


def propose_motion_box(frames: np.ndarray, box_size_frac: float = 0.25, *, work: int = 128) -> tuple:
    """Auto-prompt: the ``box_size_frac`` square with the most inter-frame
    motion, from at most ~32 sampled frames at ``work`` x ``work``; (x, y,
    w, h) in the clip's pixels."""
    import cv2

    t, h, w = frames.shape[:3]
    stride = max(1, t // 32)
    small = np.stack([cv2.resize(f, (work, work), interpolation=cv2.INTER_AREA) for f in frames[::stride]])
    gray = small.astype(np.float32).mean(axis=-1)
    diff = np.abs(np.diff(gray, axis=0)).mean(axis=0)  # [work, work]
    bh = bw = max(8, int(work * box_size_frac))
    ii = np.pad(diff, ((1, 0), (1, 0))).cumsum(0).cumsum(1)
    sums = ii[bh:, bw:] - ii[:-bh, bw:] - ii[bh:, :-bw] + ii[:-bh, :-bw]
    iy, ix = np.unravel_index(np.argmax(sums), sums.shape)
    return (float(ix) * w / work, float(iy) * h / work, float(bw) * w / work, float(bh) * h / work)


class TrackingStage(Stage[SplitPipeTask, SplitPipeTask]):
    def __init__(
        self,
        *,
        cfg: TrackerConfig = TrackerConfig(),
        write_annotated: bool = False,
        min_score: float = 0.0,
        mode: str = "auto",  # auto | learned | ncc
        siamese_cfg=None,
        learned_min_score: float = 0.0,
        device: str | torch.device = "cuda",
    ) -> None:
        if mode not in ("auto", "learned", "ncc"):
            raise ValueError(f"unknown tracking mode {mode!r}")
        self.mode = mode
        self.device = model_device(device, "the tracking stage")
        self._tracker = TemplateTracker(cfg, device=self.device)
        self.write_annotated = write_annotated
        self.min_score = min_score
        self.learned_min_score = learned_min_score
        self._siamese_cfg = siamese_cfg

    def setup(self, worker: WorkerMetadata | None = None) -> None:
        if self.mode == "ncc":
            return
        from cosmos_curate_tpu_torch.models import registry
        from cosmos_curate_tpu_torch.models.tracker_learned import MODEL_ID, SiameseConfig, SiameseTracker

        if self.mode == "learned" or registry.find_checkpoint(MODEL_ID):
            tracker = SiameseTracker(self._siamese_cfg or SiameseConfig(), device=self.device)
            try:
                tracker.setup(require_weights=True)
            except DEVICE_FAULTS:
                raise
            except RuntimeError as e:
                if self.mode == "learned":
                    raise
                logger.warning("tracking: learned tracker unavailable (%s); using the NCC tracker", e)
                return
            self._tracker = tracker
            self.min_score = self.learned_min_score

    @property
    def resources(self) -> Resources:
        return Resources(cpus=1.0, gpus=0.5 if self.device.type == "cuda" else 0.0)

    def process_data(self, tasks: list[SplitPipeTask]) -> list[SplitPipeTask]:
        for task in tasks:
            for clip in task.video.clips:
                if clip.encoded_data is None:
                    continue
                try:
                    self._track_clip(clip)
                except DEVICE_FAULTS:
                    raise
                except Exception as e:
                    logger.warning("tracking failed for %s: %s", clip.uuid, e)
                    clip.errors["tracking"] = str(e)
        return tasks

    def _track_clip(self, clip) -> None:
        import cv2

        frames = decode_frames(clip.encoded_data)
        if frames.shape[0] < 2:
            return
        boxes, scores = self._tracker.track(frames, propose_motion_box(frames))
        if float(scores.mean()) < self.min_score:
            # a low-confidence track (a static clip whose proposal locked
            # onto noise) is not emitted
            return
        clip.tracks.append([
            {"frame": i, "x": float(b[0]), "y": float(b[1]), "w": float(b[2]), "h": float(b[3]), "score": float(s)}
            for i, (b, s) in enumerate(zip(boxes, scores))
        ])
        if self.write_annotated:
            ann = frames.copy()
            for i, b in enumerate(boxes):
                x, y, w, h = (int(v) for v in b)
                cv2.rectangle(ann[i], (x, y), (x + w, y + h), (255, 64, 64), 2)
            meta = extract_video_metadata(clip.encoded_data)
            clip.annotated_mp4 = encode_frames(ann, fps=meta.fps or 24.0)
