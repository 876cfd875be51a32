"""``chip_smoke.py``'s ``train`` phase, which ``chip_smoke.py`` runs after its
``sensors`` phase, or alone on the card's host.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/train_phase.py          # the phase: STEPS steps a run
    python3 scripts/train_phase.py --full   # every trainer at its defaults, then the golden bars

The port's five trainers, six runs (the OCR trainer trains a detector and a
recognizer), each through its ``train_and_stage`` at its default
configuration and batch on the card, writing its checkpoint into a
temporary staging directory. No kernel of the port is on this path (the
models are convs, Linears, GroupNorm and plain fp32 attention): every
kernel's launch counter is zeroed as the phase starts and must read 0 as it
ends. One JSON line, ``train`` (``train_full`` with ``--full``), with, for
each run:

- host milliseconds a step synthesizing the batch (numpy and cv2) and
  device milliseconds a step (a CUDA event pair around the step: the copy
  in, the forward, the backward and the optimizer step), medians over the
  steady steps (after ``WARMUP``, before the traced ones);
- samples/s over the steady steps (host clock, synchronized at both ends);
- kernel launches a step and the device's idle share (1 - device busy
  time / wall) over the last ``TRACED`` steps, traced with
  ``torch.profiler`` (device activity only; the host's synthesis is inside
  the window, as it is in the run);
- peak device memory of the run;
- the mean loss of the first and of the last ``LOSS_WINDOW`` steps: finite,
  and the last below the first (asserted);
- the checkpoint: written by ``train_and_stage``, loaded by the port's
  inference class (``OcrModel``, ``TransNetV2``, ``SiameseTracker``,
  ``SuperResolutionModel``, ``DiffusionSRModel``) with
  ``require_weights=True``, which runs once on it (finite outputs), and read
  back bit-equal: the loaded module, written again through
  ``registry.save_params``, gives the checkpoint's bytes (asserted).

With ``--full`` each trainer runs its JAX package defaults (600 / 800 /
500 + 1200 / 500 / 800 steps), and the JAX package's golden bars are
applied to the port's inference classes on the trained checkpoints, each
reported and then asserted:

- TransNet (``tests/models/test_transnet_golden.py:48-81``): on a two-scene
  clip the peak within 2 frames of the cut, above 0.5 and above 5x the
  scene interiors' maximum; on a continuous clip no frame above 0.5;
- the tracker (``tests/models/test_tracker_learned.py:52-60``): the mean
  centre error on the moving square below the object's size;
- SR (``tests/models/test_sr_golden.py:25-47``): PSNR above bilinear's by
  0.5 dB on held-out textures;
- OCR (``tests/models/test_ocr.py:71-100``): coverage of the texty golden
  frames above twice the clean ones' and above 0.01; at least 5 of the 8
  characters of "HELLO 42" read.

The times are the card's and the card host's CPU's, reported beside the
card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# a spawned child imports this script again as ``__mp_main__`` and runs
# none of its device code
if __name__ != "__mp_main__":
    import torch

STEPS = 40  # a run's steps in the phase
WARMUP = 5  # steps before the steady window: cuDNN's algorithm search, the allocator, lazy inits
TRACED = 5  # the last steps, under the profiler
LOSS_WINDOW = 10
SR_PSNR_MARGIN_DB = 0.5
TRANSNET_PEAK_SLACK = 2
HELLO = "HELLO 42"
HELLO_MIN_MATCHES = 5


@dataclasses.dataclass
class PhaseLog:
    """A ``train_common.StepLog`` with the phase's measurements: per-step
    CUDA events, host marks at the steady window's ends, and the profiler
    over the last ``traced`` steps."""

    steps: int
    warmup: int = WARMUP
    traced: int = TRACED

    def __post_init__(self) -> None:
        from cosmos_curate_tpu_torch.models.train_common import StepLog

        self.inner = StepLog(device_timing=True)
        self.i = 0  # the step the next synthesis is for
        self.marks: dict[str, float] = {}
        self.prof = None
        self.peak_bytes = 0

    @contextlib.contextmanager
    def synth(self):
        if self.i == 0:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        if self.i == self.warmup:
            torch.cuda.synchronize()
            self.marks["steady_start"] = time.perf_counter()
        if self.i == self.steps - self.traced:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self.marks["steady_end"] = time.perf_counter()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.marks["traced_start"] = time.perf_counter()
        with self.inner.synth():
            yield

    @contextlib.contextmanager
    def step(self):
        with self.inner.step():
            yield
        self.i += 1
        if self.i == self.steps:
            torch.cuda.synchronize()
            self.marks["traced_end"] = time.perf_counter()
            self.prof.__exit__(None, None, None)
            self.peak_bytes = torch.cuda.max_memory_allocated()

    def loss(self, value) -> None:
        self.inner.loss(value)

    def record(self, batch: int) -> dict:
        assert self.i == self.steps, f"{self.i} of {self.steps} steps ran"
        steady = slice(self.warmup, self.steps - self.traced)
        n_steady = self.steps - self.traced - self.warmup
        kernels = [e for e in self.prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        assert busy_ms > 0, "the profiler traced no device time"
        traced_ms = 1e3 * (self.marks["traced_end"] - self.marks["traced_start"])
        steady_s = self.marks["steady_end"] - self.marks["steady_start"]
        losses = self.inner.loss_values()
        first, last = float(np.mean(losses[:LOSS_WINDOW])), float(np.mean(losses[-LOSS_WINDOW:]))
        return {
            "steps": self.steps, "batch": batch, "steady_steps": n_steady,
            "synth_ms_per_step": 1e3 * statistics.median(self.inner.synth_s[steady]),
            "device_ms_per_step": statistics.median(self.inner.device_ms()[steady]),
            "samples_per_s": batch * n_steady / steady_s,
            "launches_per_step": sum(e.count for e in kernels) / self.traced,
            "device_busy_ms_per_step": busy_ms / self.traced,
            "idle_share": 1.0 - busy_ms / traced_ms,
            "peak_memory_bytes": self.peak_bytes,
            "loss_first": first, "loss_last": last, "loss_final": losses[-1],
            "losses_finite": bool(np.isfinite(losses).all()),
        }


def trainers() -> dict:
    """group -> (train_and_stage call (out_dir, dev, {run: (steps, log)}) ->
    {model id: checkpoint path}, {run: (model id, default batch, default
    steps)}). The OCR trainer is one group of two runs."""
    from cosmos_curate_tpu_torch.models import diffusion_sr_train, ocr_train, sr_train, tracker_train, transnet_train
    from cosmos_curate_tpu_torch.models.diffusion_sr import MODEL_ID as DIFF_ID
    from cosmos_curate_tpu_torch.models.ocr import DETECTOR_ID, RECOGNIZER_ID
    from cosmos_curate_tpu_torch.models.super_resolution import MODEL_ID as SR_ID
    from cosmos_curate_tpu_torch.models.tracker_learned import MODEL_ID as TRACKER_ID
    from cosmos_curate_tpu_torch.models.transnetv2 import TransNetV2

    def kw(steps: int, log: PhaseLog) -> dict:
        return {"steps": steps, "log": log, "log_every": 0}

    def single(name, module, model_id):
        def call(out_dir, dev, plan):
            return {model_id: module.train_and_stage(out_dir=str(out_dir), device=dev, **kw(*plan[name]))[0]}
        d = module.train.__kwdefaults__
        return call, {name: (model_id, d["batch"], d["steps"])}

    def ocr(out_dir, dev, plan):
        results = ocr_train.train_and_stage(out_dir=str(out_dir), device=dev, det_kw=kw(*plan["ocr_detector"]),
                                            rec_kw=kw(*plan["ocr_recognizer"]))
        return {mid: ckpt for mid, (ckpt, _) in results.items()}

    det, rec = ocr_train.train_detector.__kwdefaults__, ocr_train.train_recognizer.__kwdefaults__
    return {
        "tracker": single("tracker", tracker_train, TRACKER_ID),
        "transnet": single("transnet", transnet_train, TransNetV2.MODEL_ID),
        "ocr": (ocr, {"ocr_detector": (DETECTOR_ID, det["batch"], det["steps"]),
                      "ocr_recognizer": (RECOGNIZER_ID, rec["batch"], rec["steps"])}),
        "sr": single("sr", sr_train, SR_ID),
        "diffusion_sr": single("diffusion_sr", diffusion_sr_train, DIFF_ID),
    }


def inference_model(run: str, dev):
    """The port's inference class of ``run``, set up on the staged
    checkpoint with ``require_weights=True``; (the object, the module
    holding the checkpoint's parameters)."""
    from cosmos_curate_tpu_torch.models.diffusion_sr import DiffusionSRModel
    from cosmos_curate_tpu_torch.models.ocr import OcrModel
    from cosmos_curate_tpu_torch.models.super_resolution import SuperResolutionModel
    from cosmos_curate_tpu_torch.models.tracker_learned import SiameseTracker
    from cosmos_curate_tpu_torch.models.transnetv2 import TransNetV2

    if run.startswith("ocr"):
        m = OcrModel(device=dev)
        m.setup(require_weights=True)
        return m, m.detector if run == "ocr_detector" else m.recognizer
    cls = {"tracker": SiameseTracker, "transnet": TransNetV2, "sr": SuperResolutionModel,
           "diffusion_sr": DiffusionSRModel}[run]
    m = cls(device=dev)
    m.setup(require_weights=True)
    return m, m.model if run == "transnet" else m.net


def run_inference(run: str, m) -> dict:
    """One call of the inference class on a synthesized input: finite."""
    rng = np.random.default_rng(29)
    if run == "tracker":
        frames = rng.integers(0, 256, (8, 96, 128, 3), dtype=np.uint8)
        boxes, scores = m.track(frames, (40, 30, 20, 20))
        out = np.concatenate([boxes.ravel(), scores.ravel()])
    elif run == "transnet":
        from cosmos_curate_tpu_torch.models.transnet_train import synthesize_batch

        out = m.predict_transitions(synthesize_batch(rng, 1, 48)[0][0])
        assert ((out >= 0) & (out <= 1)).all()
    elif run.startswith("ocr"):
        from cosmos_curate_tpu_torch.models.ocr_train import golden_eval_frames, golden_rec_sample

        out = np.asarray([m.text_coverage(golden_eval_frames()[1])])
        m.recognize(golden_rec_sample(HELLO)[None])
    elif run == "sr":
        out = m.upscale_window(rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)).astype(np.float32)
    else:
        out = m.upscale_window(rng.integers(0, 256, (4, 16, 16, 3), dtype=np.uint8)).astype(np.float32)
    assert np.isfinite(out).all(), f"{run}: inference on the trained checkpoint is not finite"
    return {"output_shape": list(out.shape)}


def train_group(cs, group: str, dev, root: Path, steps: int | None) -> tuple[dict, dict]:
    """One trainer's runs trained, staged, loaded and read back; (each run's
    record, each run's inference object on its checkpoint)."""
    from cosmos_curate_tpu_torch.models import registry

    call, runs = trainers()[group]
    logs = {run: PhaseLog(steps if steps is not None else default_steps)
            for run, (_, _, default_steps) in runs.items()}
    t0 = time.monotonic()
    ckpts = call(root, dev, {run: (log.steps, log) for run, log in logs.items()})
    wall = time.monotonic() - t0
    records, models = {}, {}
    for run, (model_id, batch, _) in runs.items():
        rec = {"model_id": model_id, **logs[run].record(batch), "group_wall_s": wall}
        assert rec["losses_finite"], f"{run}: a loss is not finite"
        assert rec["loss_last"] < rec["loss_first"], \
            f"{run}: the loss did not fall ({rec['loss_first']} -> {rec['loss_last']})"
        ckpt = Path(ckpts[model_id])
        assert ckpt == root / model_id / "params.msgpack" and ckpt.is_file(), f"{run}: no checkpoint at {ckpt}"
        with cs.patched_environ({registry.WEIGHTS_DIR_ENV: str(root), registry.WEIGHTS_URI_ENV: None}):
            m, module = inference_model(run, dev)
        again = registry.save_params(model_id, module, root=root / "readback")
        assert again.read_bytes() == ckpt.read_bytes(), f"{run}: the loaded checkpoint does not read back bit-equal"
        rec["checkpoint"] = {"bytes": ckpt.stat().st_size, "loaded_with_require": True, "read_back_bit_equal": True,
                             **run_inference(run, m)}
        records[run], models[run] = rec, m
    return records, models


# ------------------------------------------------------------------ the golden bars


def two_scene_frames(t_per_scene: int = 60) -> tuple[np.ndarray, int]:
    """tests/models/test_transnet_golden.py's two-scene clip with a hard cut."""
    rng = np.random.default_rng(7)
    h, w = 27, 48
    scenes = []
    for base, fg in (((200, 60, 60), (30, 30, 220)), ((40, 180, 90), (240, 240, 240))):
        frames = np.empty((t_per_scene, h, w, 3), np.uint8)
        for i in range(t_per_scene):
            frame = np.full((h, w, 3), base, np.float32)
            x = (i * 2) % (w - 12)
            frame[8:20, x : x + 12] = fg
            frames[i] = np.clip(frame + rng.normal(0, 2, frame.shape), 0, 255)
        scenes.append(frames)
    return np.concatenate(scenes), t_per_scene


def continuous_frames() -> np.ndarray:
    """tests/models/test_transnet_golden.py's continuous clip."""
    rng = np.random.default_rng(3)
    frames = np.empty((80, 27, 48, 3), np.uint8)
    for i in range(80):
        frame = np.full((27, 48, 3), (90, 120, 200), np.float32)
        x = i % (48 - 10)
        frame[10:18, x : x + 10] = (250, 250, 80)
        frames[i] = np.clip(frame + rng.normal(0, 2, frame.shape), 0, 255)
    return frames


def moving_square_clip(t=12, h=96, w=128, size=20):
    """tests/models/test_tracker_learned.py's textured square on clutter."""
    rng = np.random.default_rng(3)
    bg = rng.integers(0, 120, (h, w, 3), np.uint8)
    obj = rng.integers(150, 255, (size, size, 3), np.uint8)
    frames = np.empty((t, h, w, 3), np.uint8)
    xs, ys = [], []
    for i in range(t):
        f = bg.copy()
        x, y = 8 + i * 6, 20 + i * 3
        f[y : y + size, x : x + size] = obj
        frames[i] = f
        xs.append(x)
        ys.append(y)
    return frames, xs, ys, size


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float32) - b.astype(np.float32)) ** 2)
    return float(10 * np.log10(255.0**2 / max(mse, 1e-9)))


def golden_bars(models: dict) -> dict:
    """Each bar's numbers and whether it holds (asserted by the caller)."""
    import cv2

    from cosmos_curate_tpu_torch.models.ocr_train import golden_eval_frames, golden_rec_sample
    from cosmos_curate_tpu_torch.models.sr_train import synthesize_batch

    out = {}
    frames, cut = two_scene_frames()
    probs = models["transnet"].predict_transitions(frames)
    peak = int(np.argmax(probs))
    interior = np.concatenate([probs[5 : cut - 5], probs[cut + 5 : -5]])
    calm = models["transnet"].predict_transitions(continuous_frames())[4:-4]
    out["transnet"] = {"cut": cut, "peak_frame": peak, "peak_prob": float(probs[peak]),
                       "interior_max": float(interior.max()), "continuous_max": float(calm.max()),
                       "holds": bool(abs(peak - cut) <= TRANSNET_PEAK_SLACK and probs[peak] > 0.5
                                     and probs[peak] > 5 * interior.max() and calm.max() < 0.5)}
    frames, xs, ys, size = moving_square_clip()
    boxes, _ = models["tracker"].track(frames, (xs[0], ys[0], size, size))
    err = np.hypot(boxes[:, 0] - np.array(xs), boxes[:, 1] - np.array(ys))
    out["tracker"] = {"mean_error_px": float(err[1:].mean()), "object_px": size,
                      "holds": bool(err[1:].mean() < size)}
    lrs, hrs = synthesize_batch(np.random.default_rng(12345), 8, 64, 2)
    up = models["sr"].upscale_window(lrs)
    bilinear = np.stack([cv2.resize(f, (hrs.shape[2], hrs.shape[1]), interpolation=cv2.INTER_LINEAR) for f in lrs])
    p_model, p_base = psnr(up, hrs), psnr(bilinear, hrs)
    out["sr"] = {"psnr_db": p_model, "bilinear_psnr_db": p_base, "margin_db": SR_PSNR_MARGIN_DB,
                 "holds": bool(p_model > p_base + SR_PSNR_MARGIN_DB)}
    ocr = models["ocr_recognizer"]
    clean, texty = golden_eval_frames()
    cov_text, cov_clean = ocr.text_coverage(texty), ocr.text_coverage(clean)
    (read,) = ocr.recognize(golden_rec_sample(HELLO)[None])
    matches = sum(a == b for a, b in zip(read, HELLO))
    out["ocr"] = {"coverage_texty": cov_text, "coverage_clean": cov_clean, "read": read, "matches": matches,
                  "holds": bool(cov_text > 2 * max(cov_clean, 1e-4) and cov_text > 0.01
                                and matches >= HELLO_MIN_MATCHES)}
    return out


def drive_train(cs, dev, full: bool = False) -> dict:
    from cosmos_curate_tpu_torch.ops import kernels

    ks = kernels()
    for k in ks.values():
        k.launches = 0
    runs, models = {}, {}
    with tempfile.TemporaryDirectory(prefix="train_phase-") as tmp:
        for group in trainers():
            records, group_models = train_group(cs, group, dev, Path(tmp) / group, None if full else STEPS)
            runs.update(records)
            models.update(group_models)
        golden = golden_bars(models) if full else None
        del models
    launches = {name: k.launches for name, k in ks.items()}
    assert not any(launches.values()), f"the train phase launched kernels: {launches}"
    out = {"runs": runs, "launches": launches, "no_kernel_launched": True}
    if golden is not None:
        out["golden"] = golden
    return out


def run(cs, dev, full: bool = False) -> dict:
    """The phase, its line emitted as it ends (the golden bars asserted
    after it); returns the record."""
    t0 = time.monotonic()
    record = {**drive_train(cs, dev, full), "phase_s": time.monotonic() - t0, "card": cs.card_line()}
    cs.emit({"phase": "train_full" if full else "train", **record})
    for name, r in record["runs"].items():
        print(f"train {name}: {r['steps']} steps of {r['batch']}, synth {r['synth_ms_per_step']:.2f} ms, device "
              f"{r['device_ms_per_step']:.2f} ms a step, {r['samples_per_s']:.1f} samples/s, "
              f"{r['launches_per_step']:.0f} launches a step, idle {r['idle_share']:.2f}, loss "
              f"{r['loss_first']:.4f} -> {r['loss_last']:.4f}", flush=True)
    print(f"train: phase {record['phase_s']:.1f} s", flush=True)
    if full:
        missed = [name for name, bar in record["golden"].items() if not bar["holds"]]
        assert not missed, f"golden bars missed: {missed}: {record['golden']}"
    return record


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true", help="train at the defaults, then apply the golden bars")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    started = time.monotonic()
    print(cs.card_line(), flush=True)
    run(cs, dev, a.full)
    cs.emit({"phase": "timing", "script_s": time.monotonic() - started})
    return 0


if __name__ == "__main__":
    sys.exit(main())
