"""``chip_smoke.py``'s image and command-line phases, which ``chip_smoke.py``
runs after its leg phases, or alone on the card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/image_phase.py

Alone, it builds the kernels, checks flash at ``chip_smoke.FLASH_CASES`` and
writes the first ``CLI_VIDEOS`` videos of the split corpus. Every run goes
through the port's own command line (``cosmos_curate_tpu_torch.cli.main``),
in process unless named otherwise, with every kernel's launch counter
zeroed just before it and read just after. One JSON line per phase:

- ``image``: a corpus of ``sum(n for *_, n in IMAGE_KINDS)`` stills written
  from a seed with numpy and cv2 (scenes rendered like
  ``chip_smoke.scene_frames``: a moving gradient over a noise texture and a
  high-contrast block, plus fine grain, so JPEG decode costs what it does
  on photos): 1920x1080 JPEGs, 4032x3024 phone JPEGs (half portrait),
  1280x720 PNGs, 1024x768 WebPs (where cv2 writes WebP; else left out and
  recorded) and 640x480 BMPs, named so that the kinds interleave, and a
  truncated JPEG and a zero-byte PNG.
  Run I1: ``local image-annotate --aesthetic-threshold AESTHETIC_THRESHOLD``
  over all of them through the pipelined runner: images/s, each stage's
  busy share, the device peak, flash launches; ``SAMPLE`` images'
  embeddings and scores held against the same stages with
  ``device="cpu"`` on the same weights (``EMBED_BOUND``, ``SCORE_BOUND``;
  the filter's decision equal away from the threshold); then one embed
  stage call of ``ImageEmbeddingStage.batch_size`` stills under the
  profiler (the embed stage's device idle share). Run I2: the first
  ``CAPTION_IMAGES`` images with ``--semantic-filter score-only
  --classifier-labels ... --captioning`` (three owners of one shared
  caption engine at ``VLM_BASE``, 64 new tokens a caption): tok/s, every
  image's caption, verdict and label recorded, kernels 1, 2 and 5 launched
  and 3 recorded. Run I3: the same images with ``--api-caption-url`` at a
  local fake OpenAI-compatible server in a thread, which answers its first
  request 503: every image captioned, every body the expected JSON byte
  for byte. Run I4: I1 again: only the two broken files are discovered,
  and they fail again. Then ``ImageVideoEmbeddingStage(variant="video")``
  on the ``CAPTION_IMAGES`` images: flash launched, unit-norm outputs.
  Every flash shape the runs gave that ``FLASH_CASES`` does not hold is
  checked against the plain version and timed.
- ``cli``: ``python -m cosmos_curate_tpu_torch.cli.main info`` and ``local
  hello`` as one subprocess each (hello prints ``device=cuda``); ``local
  split --config`` (JSON) on ``CLI_VIDEOS`` corpus videos with ``video``
  embeddings, ``local dedup`` and ``local shard`` on its output, then
  ``index build``, ``query`` and ``stats`` on it, each exiting 0 with the
  same counts as ``run_split``, ``run_dedup``, ``run_shard`` and
  ``incremental_dedup`` called directly; ``local split --runner
  streaming`` with ``CURATE_ENGINE_DRIVER_PORT`` set and no
  ``CURATE_ENGINE_TOKEN`` (the engine's cross-node plane refuses to run
  without its cluster secret) raises before any stage runs, and ``local
  split --sr --sr-sp-size 2`` raises ``NotImplementedError`` naming its
  ROADMAP item (``index serve``, refused until the job service came, is
  served since; the ``service`` phase drives the search).
"""

from __future__ import annotations

import base64
import contextlib
import functools
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
SEED = 15
# (kind, suffix, height, width, count): the 256-image corpus
IMAGE_KINDS = (
    ("jpeg1080", ".jpg", 1080, 1920, 160),
    ("phone", ".jpg", 3024, 4032, 16),
    ("phone_portrait", ".jpg", 4032, 3024, 16),
    ("png720", ".png", 720, 1280, 32),
    ("webp", ".webp", 768, 1024, 24),
    ("bmp", ".bmp", 480, 640, 8),
)
JPEG_QUALITY = 90
BROKEN = ("zz_truncated.jpg", "zz_empty.png")  # sorted last: outside I2's and I3's first images
AESTHETIC_THRESHOLD = 0.0  # the seeded head's scores sit around 0 (run C's did)
SAMPLE = 8  # I1 images held against the CPU path (16 until the train phase joined the full call)
# CPU vs card, max abs error: the embeddings at the canonical phase's bound
# for `clip` embeddings; the scores at the aesthetic stage's bf16 bound
# (tests/test_torch_clip.py STAGE_TOL)
EMBED_BOUND = 3e-3
SCORE_BOUND = 2e-2
# I2 and I3's stills: 4 since the train phase joined the call (8 since the
# remote phase did, 16 before, 32 before the engine phase; the full call's
# time, PERF.md §5)
CAPTION_IMAGES = 4
EMBED_DIM = 512  # CLIP ViT-B/16's projection
CLASSIFIER_LABELS = ("photo", "illustration", "screenshot", "document")
API_PROMPT = "Describe this image in one detailed sentence."  # ImageApiCaptionStage's default
CLI_VIDEOS = 2


# -- the corpus ------------------------------------------------------------------


def render(seed: int, h: int, w: int) -> np.ndarray:
    """One still (BGR uint8): a diagonal gradient between two colours over a
    quarter-size noise texture, a high-contrast block and fine grain."""
    import cv2

    rng = np.random.default_rng(seed)
    c0, c1 = rng.integers(0, 255, 3).astype(np.float32), rng.integers(0, 255, 3).astype(np.float32)
    sh, sw = h // 4, w // 4
    yy, xx = np.mgrid[0:sh, 0:sw].astype(np.float32)
    angle = rng.uniform(0, 2 * np.pi)
    proj = np.cos(angle) * xx + np.sin(angle) * yy
    phase = ((proj - proj.min()) / max(float(np.ptp(proj)), 1.0))[..., None]
    small = c0 * (1 - phase) + c1 * phase + rng.integers(0, 60, (sh, sw, 3)).astype(np.float32) - 30.0
    img = cv2.resize(np.clip(small, 0, 255).astype(np.uint8), (w, h), interpolation=cv2.INTER_LINEAR)
    y, x = int(rng.integers(0, h - h // 4)), int(rng.integers(0, w - w // 4))
    img[y : y + h // 4, x : x + w // 4] = (255 - c0).astype(np.uint8)
    return cv2.add(img, rng.integers(0, 24, (h, w, 3), dtype=np.uint8))


def write_image(path: Path, seed: int, h: int, w: int) -> int:
    import cv2

    params = [cv2.IMWRITE_JPEG_QUALITY, JPEG_QUALITY] if path.suffix == ".jpg" else []
    ok, buf = cv2.imencode(path.suffix, render(seed, h, w), params)
    assert ok, f"cv2 does not encode {path.suffix}"
    path.write_bytes(buf.tobytes())
    return len(buf)


def webp_round_trips() -> bool:
    import cv2

    try:
        ok, buf = cv2.imencode(".webp", np.zeros((8, 8, 3), np.uint8))
        return bool(ok) and cv2.imdecode(buf, cv2.IMREAD_COLOR) is not None
    except cv2.error:
        return False


def image_corpus(root: Path) -> dict:
    """The corpus under ``root / "images"``, written on every core (cv2's
    codecs and numpy's loops release the interpreter lock)."""
    t0 = time.monotonic()
    webp = webp_round_trips()
    kinds = [k for k in IMAGE_KINDS if webp or k[1] != ".webp"]
    jobs = [(kind, suffix, h, w) for kind, suffix, h, w, n in kinds for _ in range(n)]
    order = np.random.default_rng(SEED).permutation(len(jobs))  # kinds interleave in discovery order
    images = root / "images"
    images.mkdir(parents=True)
    paths = [images / f"{i:03d}_{jobs[j][0]}{jobs[j][1]}" for i, j in enumerate(order)]
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        sizes = list(pool.map(lambda i: write_image(paths[i], SEED * 1000 + i, *jobs[order[i]][2:]), range(len(paths))))
    good = next(p for p in paths if p.suffix == ".jpg").read_bytes()
    (images / BROKEN[0]).write_bytes(good[: len(good) // 2])
    (images / BROKEN[1]).write_bytes(b"")
    counts = {kind: n for kind, _, _, _, n in kinds}
    return {"root": images, "paths": paths, "webp": webp, "build_s": time.monotonic() - t0,
            "counts": counts, "bytes": int(sum(sizes))}


# -- runs through the command line ------------------------------------------------


@contextlib.contextmanager
def counted_answers(answers: dict):
    """Wrap ``CaptionFamilyStage.ask`` for the duration: every (task,
    answer) pair a caption-family stage gets back from the engine is
    counted under the stage's name, and every answer kept by path."""
    from cosmos_curate_tpu_torch.pipelines.image.annotate import CaptionFamilyStage

    lock = threading.Lock()
    saved = CaptionFamilyStage.ask

    def ask(self, tasks, prompt):
        pairs = saved(self, tasks, prompt)
        with lock:
            answers.setdefault(self.name, {}).update({t.path: text for t, text in pairs})
        return pairs

    CaptionFamilyStage.ask = ask
    try:
        yield
    finally:
        CaptionFamilyStage.ask = saved


@contextlib.contextmanager
def timed_image_stages(classes, spans: list, instances: dict):
    """Wrap each stage class's ``process_data`` for the duration: every call
    appends (stage, host thread, tasks, tasks, start, end) to ``spans``
    (``chip_smoke.stage_busy``'s form) and keeps the instance by name."""
    lock = threading.Lock()
    saved = {cls: cls.__dict__["process_data"] for cls in classes}

    def wrap(fn):
        @functools.wraps(fn)
        def process_data(self, tasks):
            t0 = time.monotonic()
            try:
                return fn(self, tasks)
            finally:
                with lock:
                    instances[self.name] = self
                    spans.append((self.name, threading.current_thread().name, len(tasks), len(tasks), t0,
                                  time.monotonic()))
        return process_data

    for cls, fn in saved.items():
        cls.process_data = wrap(fn)
    try:
        yield
    finally:
        for cls, fn in saved.items():
            cls.process_data = fn


def cli(argv: list[str]) -> tuple[int, object]:
    """``main(argv)`` in process: (exit code, its printed JSON, else text)."""
    from cosmos_curate_tpu_torch.cli.main import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    text = out.getvalue()
    try:
        return rc, json.loads(text)
    except ValueError:
        return rc, text


def cli_run(cs, dev, argv: list[str], classes=()) -> dict:
    """One command with every launch counter zeroed just before it: exit
    code, printed summary, wall, launches, stage spans and instances, flash
    shapes, device peak."""
    from cosmos_curate_tpu_torch.ops import kernels

    ks = kernels()
    for k in ks.values():
        k.launches = 0
    spans: list = []
    instances: dict = {}
    shapes: set = set()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with timed_image_stages(classes, spans, instances), cs.recorded_flash_shapes(shapes):
        t0 = time.monotonic()
        rc, printed = cli(argv)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    return dict(rc=rc, printed=printed, wall=wall, launches={n: k.launches for n, k in ks.items()}, spans=spans,
                instances=instances, flash_shapes=shapes, peak_device=torch.cuda.max_memory_allocated(dev))


def image_id(path) -> str:
    return hashlib.sha256(str(path).encode()).hexdigest()[:24]


def outputs(out: Path) -> tuple[dict, dict]:
    """(image id -> meta, image id -> embedding) of an image run's output."""
    import pyarrow.parquet as pq

    metas = {p.stem: json.loads(p.read_text()) for p in (out / "metas").glob("*.json")}
    embs = {}
    for path in (out / "embeddings" / "clip").glob("*.parquet"):
        table = pq.read_table(path).to_pydict()
        for iid, emb in zip(table["image_id"], table["embedding"], strict=True):
            assert iid not in embs, f"{iid} embedded twice"
            embs[iid] = np.asarray(emb, np.float32)
    return metas, embs


class FakeOpenAI:
    """A local OpenAI-compatible chat endpoint on a free port: keeps every
    request's raw body, answers the first with 503, the rest with a caption
    naming the body's length."""

    def __init__(self) -> None:
        self.bodies: list[bytes] = []
        self.statuses: list[int] = []
        lock = threading.Lock()
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):  # noqa: N802
                raw = self.rfile.read(int(self.headers.get("content-length", "0")))
                with lock:
                    status = 503 if not srv.statuses else 200
                    srv.bodies.append(raw)
                    srv.statuses.append(status)
                self.send_response(status)
                if status != 200:
                    self.end_headers()
                    return
                data = json.dumps({"choices": [{"message": {"content": f"a still ({len(raw)} bytes asked)"}}]}).encode()
                self.send_header("content-length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        host, port = self.server.server_address[:2]
        self.url = f"http://{host}:{port}/v1"
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def expected_body(path: Path) -> bytes:
    """The request body the reference's stage sends for ``path`` at its
    defaults, built independently of the stage."""
    media = {".png": "image/png", ".webp": "image/webp", ".bmp": "image/bmp"}.get(path.suffix, "image/jpeg")
    b64 = base64.b64encode(path.read_bytes()).decode()
    return json.dumps({"model": "default", "max_tokens": 128, "messages": [{"role": "user", "content": [
        {"type": "text", "text": API_PROMPT},
        {"type": "image_url", "image_url": {"url": f"data:{media};base64,{b64}"}}]}]}).encode()


def check_cpu_path(dev, corpus: dict, metas: dict, embs: dict) -> dict:
    """``SAMPLE`` of I1's images through the embed and aesthetic stages on
    the CPU, on the weights the run's stages drew on the card (the seeded
    init is drawn on the device it runs on)."""
    from cosmos_curate_tpu_torch.pipelines.image import annotate

    gpu_embed = annotate.ImageEmbeddingStage(device=dev)
    gpu_head = annotate.ImageAestheticFilterStage(threshold=AESTHETIC_THRESHOLD, device=dev)
    cpu_embed = annotate.ImageEmbeddingStage(device="cpu")
    cpu_head = annotate.ImageAestheticFilterStage(threshold=AESTHETIC_THRESHOLD, device="cpu")
    for gpu, cpu in ((gpu_embed, cpu_embed), (gpu_head, cpu_head)):
        gpu.setup(None)
        cpu.model.params = {k: v.cpu() for k, v in gpu.model.model.state_dict().items()}
        cpu.setup(None)
    del gpu_embed, gpu_head
    step = len(corpus["paths"]) // SAMPLE
    sample = corpus["paths"][::step][:SAMPLE]
    t0 = time.monotonic()
    tasks = cpu_head.process_data(cpu_embed.process_data(annotate.ImageLoadStage().process_data(
        [annotate.ImageTask(path=str(p)) for p in sample])))
    cpu_s = time.monotonic() - t0
    emb_err, score_err, decisions = 0.0, 0.0, {"equal": 0, "near_threshold": 0}
    for t in tasks:
        iid = image_id(t.path)
        emb_err = max(emb_err, float(np.abs(t.embedding - embs[iid]).max()))
        card = metas[iid]
        score_err = max(score_err, abs(t.aesthetic_score - card["aesthetic_score"]))
        if abs(t.aesthetic_score - AESTHETIC_THRESHOLD) > SCORE_BOUND:
            assert t.filtered_by == card["filtered_by"], f"I1: {t.path}: the CPU path decides otherwise"
            decisions["equal"] += 1
        else:
            decisions["near_threshold"] += 1
    assert emb_err <= EMBED_BOUND, f"I1: embeddings, card vs CPU {emb_err} > {EMBED_BOUND}"
    assert score_err <= SCORE_BOUND, f"I1: aesthetic scores, card vs CPU {score_err} > {SCORE_BOUND}"
    return {"images": len(tasks), "kinds": sorted({Path(t.path).stem.split("_", 1)[1] for t in tasks}),
            "max_abs_err_embedding": emb_err, "embed_bound": EMBED_BOUND, "max_abs_err_score": score_err,
            "score_bound": SCORE_BOUND, "decisions": decisions, "cpu_s": cpu_s}


def embed_idle_share(cs, dev, corpus: dict) -> dict:
    """One embed stage call of ``batch_size`` stills (every kind) under the
    profiler, after a warm-up call: the host's resize, the copies and the
    tower, and the device's idle share of the call."""
    import legs_phase

    from cosmos_curate_tpu_torch.pipelines.image import annotate

    stage = annotate.ImageEmbeddingStage(device=dev)
    stage.setup(None)
    paths = corpus["paths"][: stage.batch_size]
    t0 = time.monotonic()
    tasks = annotate.ImageLoadStage().process_data([annotate.ImageTask(path=str(p)) for p in paths])
    load_s = time.monotonic() - t0
    stage.process_data(tasks)
    for t in tasks:
        t.embedding = None
    prof = legs_phase.profiled(lambda: stage.process_data(tasks))
    return {"images": len(tasks), "load_ms_per_image": 1e3 * load_s / len(tasks), **prof}


def drive_image(cs, dev, timer, root: Path) -> dict:
    from cosmos_curate_tpu_torch.models.vlm import SharedCaptionEngine
    from cosmos_curate_tpu_torch.pipelines.image import annotate, api_caption, filters

    corpus = image_corpus(root)
    n_images = len(corpus["paths"])
    base = ["local", "image-annotate", "--input-path", str(corpus["root"])]
    stages = (annotate.ImageLoadStage, annotate.ImageEmbeddingStage, annotate.ImageAestheticFilterStage,
              annotate.ImageWriterStage)
    shapes: set = set()

    # I1: the default image path over the whole corpus
    out1 = root / "image_i1"
    i1 = cli_run(cs, dev, [*base, "--output-path", str(out1), f"--aesthetic-threshold={AESTHETIC_THRESHOLD}"],
                 stages)
    shapes |= i1["flash_shapes"]
    s = i1["printed"]
    assert i1["rc"] == 0, i1["printed"]
    assert (s["num_images"], s["num_embedded"], s["num_errors"]) == (n_images + 2, n_images, 2), s
    metas, embs = outputs(out1)
    assert len(metas) == n_images + 2 and set(embs) == {image_id(p) for p in corpus["paths"]}
    cs.check_unit_embeddings(embs, EMBED_DIM, "I1")
    broken = {Path(m["path"]).name: m["errors"] for m in metas.values() if m["errors"]}
    assert sorted(broken) == sorted(BROKEN) and all(set(e) == {"load"} for e in broken.values()), broken
    filtered = sum(m["filtered_by"] == "aesthetic" for m in metas.values())
    assert filtered == s["num_filtered"]
    copied = len(list((out1 / "images").iterdir()))
    assert copied == n_images - filtered
    assert i1["launches"]["flash"] > 0, "I1: flash was not launched"
    scores = sorted(m["aesthetic_score"] for m in metas.values() if m["aesthetic_score"] is not None)
    cpu_path = check_cpu_path(dev, corpus, metas, embs)
    idle = embed_idle_share(cs, dev, corpus)
    cs.release_memory()

    # I2: three owners of one caption engine on the first images
    out2 = root / "image_i2"
    answers: dict = {}
    with counted_answers(answers):
        i2 = cli_run(cs, dev, [*base, "--output-path", str(out2), "--limit", str(CAPTION_IMAGES),
                               "--semantic-filter", "score-only", "--classifier-labels",
                               ",".join(CLASSIFIER_LABELS), "--captioning"],
                     (*stages, filters.ImageSemanticFilterStage, filters.ImageClassifierStage,
                      annotate.ImageCaptionStage))
    shapes |= i2["flash_shapes"]
    assert i2["rc"] == 0 and i2["printed"]["num_images"] == CAPTION_IMAGES, i2["printed"]
    metas2, _ = outputs(out2)
    asked = {str(p) for p in corpus["paths"][:CAPTION_IMAGES]}
    # every image answered by each of the three owners, and every answer
    # recorded in its meta (a seeded model's caption may be empty)
    assert {name: set(a) for name, a in answers.items()} == {
        name: asked for name in ("ImageSemanticFilterStage", "ImageClassifierStage", "ImageCaptionStage")}, answers
    assert len(metas2) == CAPTION_IMAGES
    for m in metas2.values():
        assert m["caption"] == answers["ImageCaptionStage"][m["path"]], m
        assert m["label"] in (*CLASSIFIER_LABELS, "unknown") and m["semantic_pass"] in (True, False, None), m
        assert not m["filtered_by"] and not m["errors"], m
    for name in ("paged_decode", "paged_prefill", "flash"):
        assert i2["launches"][name] > 0, f"I2: {name} was not launched"
    engine = i2["instances"]["ImageCaptionStage"].model.engine
    owners = {name: i2["instances"][name].owner
              for name in ("ImageSemanticFilterStage", "ImageClassifierStage", "ImageCaptionStage")}
    owner_tokens = engine.owner_decode_tokens
    decode_tokens = {name: owner_tokens.get(owner, 0) for name, owner in owners.items()}
    i2_record = dict(
        images=CAPTION_IMAGES, wall_s=i2["wall"], images_per_s=CAPTION_IMAGES / i2["wall"],
        decode_tok_s=engine.tokens_per_second, decode_tokens=decode_tokens,
        empty_captions=sum(not m["caption"] for m in metas2.values()),
        end_to_end_tok_s=sum(decode_tokens.values()) / i2["wall"], launches=i2["launches"],
        prefill_launched=i2["launches"]["prefill"] > 0, stages=cs.stage_busy(i2["spans"], i2["wall"]),
        peak_device_memory_bytes=i2["peak_device"],
        verdicts={str(v): sum(m["semantic_pass"] is v for m in metas2.values()) for v in (True, False, None)},
        labels={label: sum(m["label"] == label for m in metas2.values()) for label in (*CLASSIFIER_LABELS, "unknown")},
        captions={Path(m["path"]).name: m["caption"] for m in sorted(metas2.values(), key=lambda m: m["path"])[:4]},
    )
    del engine, i2
    SharedCaptionEngine.reset()
    cs.release_memory()

    # I3: captions from a local OpenAI-compatible server (one 503 first)
    out3 = root / "image_i3"
    with FakeOpenAI() as api:
        i3 = cli_run(cs, dev, [*base, "--output-path", str(out3), "--limit", str(CAPTION_IMAGES),
                               "--api-caption-url", api.url], (*stages, api_caption.ImageApiCaptionStage))
    shapes |= i3["flash_shapes"]
    assert i3["rc"] == 0 and i3["printed"]["num_captioned"] == CAPTION_IMAGES, i3["printed"]
    assert api.statuses.count(503) == 1 and api.statuses.count(200) == CAPTION_IMAGES, api.statuses
    want = {expected_body(p) for p in corpus["paths"][:CAPTION_IMAGES]}
    assert set(api.bodies) == want, "I3: a request body is not the expected JSON"
    metas3, _ = outputs(out3)
    assert all(m["caption"].startswith("a still (") for m in metas3.values())

    # I4: I1 again: only the two broken files are discovered, and fail again
    i4 = cli_run(cs, dev, [*base, "--output-path", str(out1), f"--aesthetic-threshold={AESTHETIC_THRESHOLD}"],
                 stages)
    assert i4["rc"] == 0 and (i4["printed"]["num_images"], i4["printed"]["num_errors"]) == (2, 2), i4["printed"]

    # the temporal video embedder on stills
    video = annotate.ImageVideoEmbeddingStage(variant="video", device=dev)
    video.setup(None)
    tasks = annotate.ImageLoadStage().process_data(
        [annotate.ImageTask(path=str(p)) for p in corpus["paths"][:CAPTION_IMAGES]])
    video_launches: dict = {}
    t0 = time.monotonic()
    with cs.counted_launches(video_launches), cs.recorded_flash_shapes(shapes):
        video.process_data(tasks)
        torch.cuda.synchronize()
    video_s = time.monotonic() - t0
    assert video_launches["flash"] > 0, "the video embedder on stills did not launch flash"
    cs.check_unit_embeddings({t.path: t.embedding for t in tasks}, video.model.cfg.output_dim, "video on stills")
    del video, tasks
    cs.release_memory()
    flash_here = cs.check_new_flash_shapes(timer, shapes, SEED)
    shutil.rmtree(root / "image_i2", ignore_errors=True)
    return dict(
        corpus={"images": n_images, "broken": list(BROKEN), "counts": corpus["counts"], "webp_written": corpus["webp"],
                "bytes": corpus["bytes"], "build_s": corpus["build_s"]},
        i1=dict(images=s["num_images"], wall_s=i1["wall"], images_per_s=s["num_images"] / i1["wall"],
                embedded=s["num_embedded"], filtered=s["num_filtered"], errors=s["num_errors"],
                aesthetic_threshold=AESTHETIC_THRESHOLD, score_min=scores[0], score_max=scores[-1],
                stages=cs.stage_busy(i1["spans"], i1["wall"]), launches=i1["launches"],
                peak_device_memory_bytes=i1["peak_device"], cpu_path=cpu_path, embed_stage_call=idle),
        i2=i2_record,
        i3=dict(images=CAPTION_IMAGES, wall_s=i3["wall"], requests=len(api.statuses), statuses={
            "503": api.statuses.count(503), "200": api.statuses.count(200)}, launches=i3["launches"],
            stages=cs.stage_busy(i3["spans"], i3["wall"])),
        i4=dict(wall_s=i4["wall"], discovered=i4["printed"]["num_images"], errors=i4["printed"]["num_errors"],
                launches=i4["launches"]),
        video_on_stills=dict(images=CAPTION_IMAGES, seconds=video_s, launches=video_launches),
        flash_shapes=[list(shape) for shape, _ in sorted(shapes)], flash_checked_here=flash_here,
    )


# -- the command line ------------------------------------------------------------------


def subprocess_cli(*argv: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "cosmos_curate_tpu_torch.cli.main", *argv], cwd=REPO,
                          capture_output=True, text=True, timeout=600)


def refusal(argv: list[str]) -> str:
    try:
        cli(argv)
    except NotImplementedError as e:
        return str(e)
    raise AssertionError(f"{argv} did not raise NotImplementedError")


def drive_cli(cs, dev, root: Path, corpus: list[Path]) -> dict:
    from cosmos_curate_tpu_torch.core.runner import SequentialRunner
    from cosmos_curate_tpu_torch.dedup.corpus_index import CorpusIndex, incremental_dedup
    from cosmos_curate_tpu_torch.pipelines.video import dedup, shard, split

    t0 = time.monotonic()
    info = subprocess_cli("info")
    hello = subprocess_cli("local", "hello")
    subprocess_s = time.monotonic() - t0
    assert info.returncode == 0 and torch.cuda.get_device_name(0) in info.stdout, info.stdout + info.stderr
    assert hello.returncode == 0 and hello.stdout.count("device=cuda") == 10, hello.stdout + hello.stderr

    videos = cs.subset(root, corpus, "cli_videos", CLI_VIDEOS)
    cfg = {"input_path": str(videos), "output_path": str(root / "cli_split"), "fixed_stride_len_s": 1.0,
           "min_clip_len_s": 0.5, "extract_fps": [8.0], "extract_resize_hw": [224, 224], "embedding_model": "video"}
    (root / "cli_split.json").write_text(json.dumps(cfg))
    runs = {}
    runs["split"] = cli_run(cs, dev, ["local", "split", "--config", str(root / "cli_split.json"),
                                      "--runner", "sequential"])
    direct = split.run_split(split.SplitPipelineArgs(
        **{**cfg, "output_path": str(root / "direct_split"), "extract_fps": (8.0,), "extract_resize_hw": (224, 224)}),
        runner=SequentialRunner())
    got = runs["split"]["printed"]
    keys = ("num_videos", "num_clips", "num_with_embeddings", "num_errors")
    assert [got[k] for k in keys] == [direct[k] for k in keys] and got["num_with_embeddings"] > 0, (got, direct)
    assert runs["split"]["launches"]["flash"] > 0, "cli split: flash was not launched"

    split_out = str(root / "cli_split")
    runs["dedup"] = cli_run(cs, dev, ["local", "dedup", "--input-path", split_out])
    direct_dedup = dedup.run_dedup(dedup.DedupPipelineArgs(input_path=str(root / "direct_split")))
    keys = ("method", "num_embeddings", "num_kept", "num_removed")
    assert [runs["dedup"]["printed"][k] for k in keys] == [direct_dedup[k] for k in keys], (runs["dedup"], direct_dedup)
    csv = f"{split_out}/dedup/dedup_summary_0.07.csv"
    runs["shard"] = cli_run(cs, dev, ["local", "shard", "--input-path", split_out, "--output-path",
                                      str(root / "cli_shard"), "--dedup-csv", csv])
    direct_shard = shard.run_shard(shard.ShardPipelineArgs(
        input_path=str(root / "direct_split"), output_path=str(root / "direct_shard"),
        dedup_csv=f"{root}/direct_split/dedup/dedup_summary_0.07.csv"))
    keys = ("num_samples", "num_buckets")
    assert [runs["shard"]["printed"][k] for k in keys] == [direct_shard[k] for k in keys], (runs["shard"], direct_shard)

    runs["index_build"] = cli_run(cs, dev, ["index", "build", "--input-path", split_out])
    runs["index_query"] = cli_run(cs, dev, ["index", "query", "--input-path", split_out])
    runs["index_stats"] = cli_run(cs, dev, ["index", "stats", "--index-path", f"{split_out}/index"])
    ids, vecs, _ = dedup.load_embeddings(split_out)
    result = incremental_dedup(CorpusIndex.open(f"{split_out}/index", device=dev), ids, vecs)
    q = runs["index_query"]["printed"]
    assert (q["num_queries"], q["num_kept"], q["num_removed"]) == (
        len(ids), len(result["kept"]), len(result["removed"])), q
    assert runs["index_build"]["printed"]["num_vectors"] == runs["index_stats"]["printed"]["num_vectors"] == len(ids)
    for name, run in runs.items():
        assert run["rc"] == 0, (name, run["printed"])

    os.environ["CURATE_ENGINE_DRIVER_PORT"] = "7070"
    token = os.environ.pop("CURATE_ENGINE_TOKEN", None)
    try:
        cli(["local", "split", "--input-path", str(videos), "--output-path", str(root / "refused"),
             "--runner", "streaming"])
    except RuntimeError as e:
        streaming = str(e)
    else:
        raise AssertionError("the cross-node plane ran without CURATE_ENGINE_TOKEN")
    finally:
        os.environ.pop("CURATE_ENGINE_DRIVER_PORT")
        if token is not None:
            os.environ["CURATE_ENGINE_TOKEN"] = token
    refused = {"local split --runner streaming (remote plane, no token)": streaming,
               "local split --sr --sr-sp-size 2": refusal(["local", "split", "--input-path", str(videos),
                                                           "--output-path", str(root / "refused"), "--sr",
                                                           "--sr-sp-size", "2"])}
    assert "CURATE_ENGINE_TOKEN" in streaming and "item 7" in refused["local split --sr --sr-sp-size 2"], refused
    assert not (root / "refused" / "clips").exists(), "the refused run wrote clips"
    return dict(
        subprocess={"info_rc": info.returncode, "info": info.stdout.strip().splitlines(),
                    "hello_rc": hello.returncode, "hello_device_cuda_lines": hello.stdout.count("device=cuda"),
                    "seconds": subprocess_s},
        commands={name: {"rc": run["rc"], "wall_s": run["wall"], "launches": run["launches"],
                         **({k: run["printed"][k] for k in ("num_clips", "num_with_embeddings", "num_kept",
                                                             "num_removed", "num_samples", "num_vectors",
                                                             "num_queries") if k in run["printed"]})}
                  for name, run in runs.items()},
        direct={"split_clips": direct["num_clips"], "dedup_removed": direct_dedup["num_removed"],
                "shard_samples": direct_shard["num_samples"]},
        refused=refused,
    )


def run(cs, dev, timer, root: Path, corpus: list[Path]) -> dict:
    """Both phases in order, each line emitted as it ends; returns
    {phase: record}."""
    out = {}
    t0 = time.monotonic()
    out["image"] = {**drive_image(cs, dev, timer, root), "phase_s": time.monotonic() - t0}
    cs.emit({"phase": "image", **out["image"]})
    t0 = time.monotonic()
    out["cli"] = {**drive_cli(cs, dev, root, corpus), "phase_s": time.monotonic() - t0}
    cs.emit({"phase": "cli", **out["cli"]})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("image_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    # pyarrow imported first in a worker thread has crashed a later read in
    # the main thread (pyarrow 25): import it here
    import pyarrow.parquet  # noqa: F401

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    started = time.monotonic()
    timer, build_s = cs.phase_prologue(dev)
    with cs.split_corpus(CLI_VIDEOS) as (root, corpus, corpus_s):
        cs.emit({"phase": "image_prologue", "build_s": build_s, "corpus_build_s": corpus_s})
        run(cs, dev, timer, root, corpus)
    cs.emit({"phase": "timing", "script_s": time.monotonic() - started})
    return 0


if __name__ == "__main__":
    sys.exit(main())
