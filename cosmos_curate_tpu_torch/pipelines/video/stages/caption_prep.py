"""The caption prep stage: clips cut into caption windows, each window's
frames sampled (port of ``CaptionPrepStage`` in
``cosmos_curate_tpu/pipelines/video/stages/captioning.py``).

It lives in a module of its own, re-exported by captioning.py, because it
is host work: the streaming engine and the map runner run it in a spawned
worker, which imports this module to unpickle the stage, and the caption
engine's modules (torch and the VLM) would cost that worker seconds of
start-up for nothing.
"""

from __future__ import annotations

import numpy as np

from cosmos_curate_tpu_torch.core.stage import Resources, Stage
from cosmos_curate_tpu_torch.data.model import FrameExtractionSignature, SplitPipeTask, Window
from cosmos_curate_tpu_torch.video.windowing import compute_windows


class CaptionPrepStage(Stage[SplitPipeTask, SplitPipeTask]):
    """CPU prep: cut clips into caption windows and attach window frames."""

    def __init__(
        self,
        *,
        window_len: int = 256,
        remainder_threshold: int = 128,
        frames_per_window: int = 8,
        extraction: FrameExtractionSignature = FrameExtractionSignature("fps", 2.0),
    ) -> None:
        self.window_len = window_len
        self.remainder_threshold = remainder_threshold
        self.frames_per_window = frames_per_window
        self.extraction = extraction

    @property
    def resources(self) -> Resources:
        return Resources(cpus=3.0)

    def process_data(self, tasks: list[SplitPipeTask]) -> list[SplitPipeTask]:
        key = self.extraction.key()
        for task in tasks:
            for clip in task.video.clips:
                frames = clip.extracted_frames.get(key)
                if frames is None or frames.shape[0] == 0:
                    continue
                # windows are defined over source frames; map them to
                # extracted frame indices proportionally
                src_frames = max(1, int(clip.duration_s * task.video.metadata.fps))
                spans = compute_windows(
                    src_frames, window_len=self.window_len, remainder_threshold=self.remainder_threshold
                )
                n_ext = frames.shape[0]
                clip.windows = []
                for a, b in spans:
                    ea = int(a / src_frames * n_ext)
                    eb = max(ea + 1, int(b / src_frames * n_ext))
                    idx = np.linspace(ea, min(eb, n_ext) - 1, self.frames_per_window)
                    win = Window(start_frame=a, end_frame=b)
                    win.frames = frames[idx.round().astype(int)]
                    # effective sampling rate of the window's frames in
                    # source time (temporal m-rope scaling)
                    span_s = (b - a) / max(task.video.metadata.fps, 1e-6)
                    win.frame_fps = self.frames_per_window / max(span_s, 1e-6)
                    clip.windows.append(win)
        return tasks
