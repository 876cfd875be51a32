"""Per-event captioning: describe each tracked object, not the whole clip
(port of ``cosmos_curate_tpu/pipelines/video/stages/per_event_caption.py``).

Reads ``Clip.tracks`` from the tracking stage: each track's region is
cropped (with a margin) at uniformly sampled track points, resized to the
caption model's image size, and captioned through the shared caption
engine with ``EVENT_PROMPT``. The captions land in ``Clip.event_captions``,
parallel to ``tracks`` (an empty string where a request failed).

The prompt's ids are the request's prefix, so the engine's shared-prefix
cache prefills them once. The stage is one owner of the
``SharedCaptionEngine`` on ``model_flavor``, on ``device="cuda"`` unless
the caller asks for the CPU. A clip that does not decode keeps its place
with the error on ``clip.errors["per_event_caption"]``.
"""

from __future__ import annotations

import numpy as np
import torch

from cosmos_curate_tpu_torch.core.model import ModelInterface
from cosmos_curate_tpu_torch.core.stage import Resources, Stage
from cosmos_curate_tpu_torch.data.model import SplitPipeTask
from cosmos_curate_tpu_torch.models.vlm import CaptionRequest, SamplingConfig, VLMConfig
from cosmos_curate_tpu_torch.pipelines.video.stages.captioning import _owner_tag, resolve_caption_model
from cosmos_curate_tpu_torch.utils.logging import get_logger
from cosmos_curate_tpu_torch.video.decode import decode_frames

logger = get_logger(__name__)

EVENT_PROMPT = "Describe the object in this video and what it is doing."


def crop_track(frames: np.ndarray, track: list[dict], *, num_frames: int = 4, margin: float = 0.5,
               out_size: int = 224) -> np.ndarray:
    """The tracked box (with ``margin`` on each side, one crop size for the
    whole track) at ``num_frames`` uniformly sampled track points, each
    resized (``INTER_AREA``) to ``out_size`` squared: uint8
    [num_frames, out_size, out_size, 3]."""
    import cv2

    t, h, w = frames.shape[:3]
    idx = np.linspace(0, len(track) - 1, num_frames).round().astype(int)
    bw = max(p["w"] for p in track)
    bh = max(p["h"] for p in track)
    cw = max(8, min(w, int(bw * (1 + 2 * margin))))
    ch = max(8, min(h, int(bh * (1 + 2 * margin))))
    out = np.zeros((num_frames, out_size, out_size, 3), np.uint8)
    for n, i in enumerate(idx):
        p = track[i]
        fi = min(int(p["frame"]), t - 1)
        cx, cy = p["x"] + p["w"] / 2, p["y"] + p["h"] / 2
        x0 = int(np.clip(cx - cw / 2, 0, w - cw))
        y0 = int(np.clip(cy - ch / 2, 0, h - ch))
        out[n] = cv2.resize(frames[fi, y0 : y0 + ch, x0 : x0 + cw], (out_size, out_size),
                            interpolation=cv2.INTER_AREA)
    return out


class PerEventCaptionStage(Stage[SplitPipeTask, SplitPipeTask]):
    def __init__(
        self,
        *,
        cfg: VLMConfig | None = None,
        max_batch: int = 8,
        max_new_tokens: int = 64,
        frames_per_event: int = 4,
        model_flavor: str | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.owner = _owner_tag("per-event-caption")
        self._model = resolve_caption_model(cfg, model_flavor, max_batch, device)
        self.max_new_tokens = max_new_tokens
        self.frames_per_event = frames_per_event

    @property
    def model(self) -> ModelInterface:
        return self._model

    @property
    def resources(self) -> Resources:
        return Resources(cpus=1.0, entire_gpu_host=self._model.device.type == "cuda")

    @property
    def batch_size(self) -> int:
        # deep batches keep the engine's continuous batch full across clips
        return 16

    def process_data(self, tasks: list[SplitPipeTask]) -> list[SplitPipeTask]:
        engine = self._model.engine
        if engine is None:
            raise RuntimeError("PerEventCaptionStage.process_data before setup()")
        targets: dict[str, tuple] = {}
        for task in tasks:
            for clip in task.video.clips:
                if not clip.tracks or clip.encoded_data is None:
                    continue
                try:
                    frames = decode_frames(clip.encoded_data)
                except Exception as e:
                    clip.errors["per_event_caption"] = str(e)
                    continue
                if frames.shape[0] == 0:
                    continue
                # parallel to tracks even when a request fails
                clip.event_captions = [""] * len(clip.tracks)
                for k, track in enumerate(clip.tracks):
                    rid = f"{clip.uuid}-ev{k}"
                    crops = crop_track(frames, track, num_frames=self.frames_per_event,
                                       out_size=self._model.cfg.vision.image_size)
                    targets[rid] = (clip, k)
                    pre, ids = self._model.encode_prompt(EVENT_PROMPT, has_vision=True)
                    engine.add_request(CaptionRequest(
                        request_id=rid, prefix_ids=pre, prompt_ids=ids, frames=crops,
                        sampling=SamplingConfig(max_new_tokens=self.max_new_tokens), owner=self.owner))
        if not targets:
            return tasks
        for res in engine.run_until_complete(owner=self.owner):
            hit = targets.get(res.request_id)
            if hit is not None:
                clip, k = hit
                clip.event_captions[k] = res.text
        return tasks
