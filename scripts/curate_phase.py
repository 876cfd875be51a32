"""``chip_smoke.py``'s curate phases, which ``chip_smoke.py`` calls after its
``filters`` phase, or alone on the card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/curate_phase.py

Alone, it builds the kernels, checks flash at ``chip_smoke.FLASH_CASES``,
writes the split corpus and runs run A (``chip_smoke.split_args``), whose
output the dedup phase reads. Then, as inside ``chip_smoke.py``, one JSON
line per phase:

- ``flash_causal``: flash's causal branch against its plain version at the
  CLIP text towers' shapes (256 queries of 77 tokens x 12 heads, of 64 x 8),
  both shorter than one key tile, timed beside the bound and SDPA;
- ``t5``: ``T5EncoderTPU(T5_SMALL)`` (t5-small's widths, T5's own seeded
  init, byte ids) on 256 caption-length texts of 200-500 bytes (T pads to
  512): captions/s, ms a call, the device's idle share of the call, the
  attention's share of its device time (CUDA events), peak memory, and the
  bf16 output against the same weights in fp32 on the card, within
  ``T5_BOUND`` of the fp32 output's largest magnitude;
- ``clip_text``: ``CLIPTextEmbeddings("clip-text-l-tpu")`` (768 wide, 12
  layers, 12 heads of 64, 77 positions; the fallback tokenizer) on 256
  queries through ``encode_texts``: queries/s, unit-norm rows, pooled
  features within ``CLIP_TEXT_BOUND`` of the same forward with flash's
  plain version (fp32 logits, as the kernel), 12 flash launches a forward
  call, and every flash shape it ran checked and timed;
- ``split_extras`` (run D): run B's 2 videos through ``run_split`` with
  ``base`` captions, ``t5_embeddings`` (``T5_BASE``) and ``previews``: one
  ``t5_embeddings/<uuid>.npz`` per captioned clip with one [tokens, 512]
  array per window, one WebP per clip of at most 8 frames no wider than
  320, ``has_t5_embedding`` in the metas, kernels 1, 2, 3 and 5 launched;
  the wall and each stage's busy share (without PIL's WebP, no previews,
  and the line says so);
- ``dedup_shard``: ``run_dedup`` on run A's 256 ``video`` embeddings and
  ``run_shard`` with its CSV (the kept clips exactly, each member's bytes
  the clip's mp4, meta and embedding, ``index.json``'s counts), then
  ``kmeans_fit`` on ``KMEANS_N`` x 768 seeded rows around ``KMEANS_K``
  planted centres (K = sqrt(N)), 20 iterations at most (init and per-step
  seconds, peak memory, agreement with the planted clusters), then
  ``semantic_dedup`` on ``SEMDEDUP_N`` rows with planted near-copies (the
  removed set must be exactly the copies; its wall split into k-means on the
  card and the host's per-cluster pruning).
"""

from __future__ import annotations

import collections
import contextlib
import csv
import gc
import io
import json
import os
import sys
import tarfile
import time
from pathlib import Path

import numpy as np
import torch

# flash's causal branch at the CLIP text towers' attention: [N, H, T, D]
CLIP_TEXT_FLASH = (("clip_text_l_causal", (256, 12, 77, 64)), ("clip_text_b_causal", (256, 8, 64, 64)))
# t5 phase: caption-length texts (byte ids: 201-501 tokens, padded to 512);
# bf16 vs fp32 on the card, max abs difference over the fp32 output's
# largest magnitude (stated before the first chip run; a CPU reading at
# t5-small, 4 rows of 512 tokens, T5's init: 1.45e-2)
T5_TEXTS = 256
T5_TEXT_BYTES = (200, 500)
T5_CHECK_TEXTS = 32
T5_BOUND = 5e-2
# clip_text phase: queries of 20-120 bytes (the longest truncate to 77
# tokens); unit-norm pooled features with the flash kernel vs its plain
# version, max abs difference (stated before the first chip run: the
# kernel rounds P to bf16 for P V, the plain version keeps fp32; the video
# embed path reads 1.2e-3 on the same pair)
CLIP_TEXT_QUERIES = 256
CLIP_TEXT_BYTES = (20, 120)
CLIP_TEXT_BOUND = 5e-3
# dedup phase: k-means at a deployment's size (K = sqrt(N), the default),
# rows = planted centre + noise of the centre's norm (cosine to its own
# centre ~0.7, to others ~0); semantic dedup with every 4th row a
# near-copy of the row before (cosine ~1 - 1e-6, far above 1 - eps)
KMEANS_N = 1 << 20
KMEANS_DIM = 768
KMEANS_K = 1 << 10
KMEANS_ITERS = 20
SEMDEDUP_N = 1 << 16
SEMDEDUP_COPY_EVERY = 4
SEMDEDUP_EPS = 0.07
WORDS = ("the a camera pans slowly across busy city street at night while cars pass under bright lights and "
         "people walk by shop windows near old stone bridge over river in rain wind trees move softly").split()


def texts_of(rng, n: int, lo: int, hi: int) -> list[str]:
    """``n`` word strings of ``lo``-``hi`` bytes each."""
    out = []
    for _ in range(n):
        target = int(rng.integers(lo, hi + 1))
        words: list[str] = []
        while len(" ".join(words)) < target:
            words.append(WORDS[int(rng.integers(len(WORDS)))])
        out.append(" ".join(words)[:target])
    return out


def flash_causal(cs, timer) -> dict:
    """Flash's causal branch at the CLIP text shapes, against its plain
    version (within ``cs.BOUND``), timed."""
    bf16 = cs.random_bf16(np.random.default_rng(cs.SEED + 21), "cuda")
    return {label: cs.check_flash(timer, bf16, shape, True, label) for label, shape in CLIP_TEXT_FLASH}


@contextlib.contextmanager
def timed_calls(module, name: str, spans: list):
    """``module.name`` wrapped for the duration: each call's CUDA-event
    interval lands in ``spans``."""
    saved = getattr(module, name)

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = saved(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, saved)


def drive_t5(dev) -> dict:
    from cosmos_curate_tpu_torch.models import t5

    cfg = t5.T5_SMALL
    model = t5.T5EncoderTPU(cfg, device=dev)
    model.setup()
    texts = texts_of(np.random.default_rng(12), T5_TEXTS, *T5_TEXT_BYTES)
    model.encode(texts[:32])  # warm-up
    torch.cuda.synchronize()
    pipeline = model.device_pipeline
    pipeline.records.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    samples = model.encode(texts)
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    records = list(pipeline.records)
    compute_s = sum(r.compute_s for r in records)
    for text, s in zip(texts, samples, strict=True):
        assert s.mask.shape == (cfg.max_len,), f"t5: T padded to {s.mask.shape}"
        assert s.embedding.shape == (len(text.encode()) + 1, cfg.dim), f"t5: {s.embedding.shape}"
        assert np.isfinite(s.embedding).all(), "t5: non-finite embedding"

    # the attention's share of one call's device time
    spans: list = []
    with timed_calls(t5.T5Attention, "forward", spans):
        pipeline.records.clear()
        model.encode(texts)
        torch.cuda.synchronize()
    attn_ms = sum(a.elapsed_time(b) for a, b in spans)
    call_compute_ms = 1e3 * sum(r.compute_s for r in pipeline.records)

    # bf16 on the card against the same weights in fp32 on the card
    with torch.device(dev):
        ref = t5.T5Encoder(cfg, dtype=torch.float32)
    ref.load_state_dict(model.model.state_dict())
    ref.eval().requires_grad_(False)
    ids = np.full((T5_CHECK_TEXTS, cfg.max_len), model.tokenizer.pad_id, np.int64)
    mask = np.zeros((T5_CHECK_TEXTS, cfg.max_len), bool)
    for i, s in enumerate(samples[:T5_CHECK_TEXTS]):
        ids[i, : len(s.tokens)] = s.tokens
        mask[i, : len(s.tokens)] = True
    ids_d, mask_d = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
    with torch.inference_mode():
        got = model.model(ids_d, mask_d)[mask_d]
        want = ref(ids_d, mask_d)[mask_d]
    scale = want.abs().max().item()
    err = (got - want).abs().max().item() / scale
    assert err <= T5_BOUND, f"t5: bf16 vs fp32 {err} of scale > {T5_BOUND}"
    out = dict(
        config={"vocab": cfg.vocab, "dim": cfg.dim, "layers": cfg.layers, "heads": cfg.heads, "d_kv": cfg.d_kv,
                "d_ff": cfg.d_ff, "act": cfg.act, "max_len": cfg.max_len},
        texts=len(texts), tokens=int(sum(len(s.tokens) for s in samples)), padded_len=cfg.max_len,
        wall_s=wall, captions_per_s=len(texts) / wall, ms_per_call=1e3 * wall, dispatches=len(records),
        rows_per_dispatch=[r.rows for r in records], device_compute_s=compute_s,
        device_idle_share=max(0.0, 1.0 - compute_s / wall),
        h2d_ms_per_dispatch=1e3 * sum(r.h2d_s for r in records) / len(records),
        d2h_ms_per_dispatch=1e3 * sum(r.d2h_s for r in records) / len(records),
        readback_bytes=int(len(texts) * cfg.max_len * cfg.dim * 4),
        attention_ms_per_call=attn_ms, compute_ms_per_call=call_compute_ms,
        attention_share_of_compute=attn_ms / call_compute_ms, peak_memory_bytes=peak,
        max_abs_err_bf16_vs_fp32_of_scale=err, fp32_scale=scale, bound=T5_BOUND, rows_checked=T5_CHECK_TEXTS,
    )
    del model, ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def drive_clip_text(cs, dev, timer) -> dict:
    from cosmos_curate_tpu_torch.models.clip_text import CLIPTextEmbeddings, FallbackClipTokenizer
    from cosmos_curate_tpu_torch.ops.flash_attention import flash_attention_plain

    model = CLIPTextEmbeddings("clip-text-l-tpu", device=dev)
    model.setup()
    cfg = model.cfg
    queries = texts_of(np.random.default_rng(13), CLIP_TEXT_QUERIES, *CLIP_TEXT_BYTES)
    model.encode_texts(queries[:32])  # warm-up
    assert isinstance(model._tokenizer, FallbackClipTokenizer)
    torch.cuda.synchronize()
    pipeline = model.device_pipeline
    pipeline.records.clear()
    shapes: set = set()
    counts: dict = {}
    with cs.counted_launches(counts), cs.recorded_flash_shapes(shapes):
        t0 = time.monotonic()
        got = model.encode_texts(queries)
        wall = time.monotonic() - t0
    launches = counts["flash"]
    records = list(pipeline.records)
    dispatches = len(records)
    compute_s = sum(r.compute_s for r in records)
    assert got.shape == (len(queries), cfg.projection_dim) and np.isfinite(got).all(), "clip_text: output"
    norms = np.linalg.norm(got, axis=-1)
    assert np.abs(norms - 1.0).max() < 1e-3, "clip_text: rows are not unit-norm"
    assert launches == cfg.layers * dispatches, f"clip_text: {launches} flash launches over {dispatches} calls"

    def plain(q, k, v, *, causal=False):
        return flash_attention_plain(q, k, v, causal=causal)

    with cs.swapped_flash(plain):
        want = model.encode_texts(queries)
    err = float(np.abs(got - want).max())
    assert err <= CLIP_TEXT_BOUND, f"clip_text: flash vs plain {err} > {CLIP_TEXT_BOUND}"
    checked = cs.check_new_flash_shapes(timer, shapes, cs.SEED + 22)
    out = dict(
        config={"width": cfg.width, "layers": cfg.layers, "heads": cfg.heads, "max_len": cfg.max_len,
                "projection_dim": cfg.projection_dim, "vocab": cfg.vocab},
        queries=len(queries), wall_s=wall, queries_per_s=len(queries) / wall, dispatches=dispatches,
        device_compute_s=compute_s, device_idle_share=max(0.0, 1.0 - compute_s / wall),
        launches=counts, flash_launches_per_call=launches / dispatches,
        flash_shapes=[[*shape, causal] for shape, causal in sorted(shapes)], flash_checked_here=checked,
        max_abs_err_vs_plain_flash=err, bound=CLIP_TEXT_BOUND, max_norm_error=float(np.abs(norms - 1.0).max()),
        provenance=model.provenance,
    )
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def drive_split_extras(cs, dev, timer, root: Path, corpus: list[Path]) -> dict:
    """Run D: run B's videos with captions, T5 caption embeddings and
    previews."""
    from PIL import Image

    from cosmos_curate_tpu_torch.core.runner import default_runner
    from cosmos_curate_tpu_torch.models.embedder import VIDEO_EMBED_VARIANTS
    from cosmos_curate_tpu_torch.models.t5 import T5_BASE
    from cosmos_curate_tpu_torch.models.vlm import SharedCaptionEngine
    from cosmos_curate_tpu_torch.pipelines.video import split
    from cosmos_curate_tpu_torch.pipelines.video.stages.writer import ClipWriterStage

    previews = cs.webp_available()
    stage_classes = (split.VideoDownloadStage, split.FixedStrideExtractorStage, split.ClipTranscodingStage,
                     split.ClipFrameExtractionStage, split.ClipEmbeddingStage, split.CaptionPrepStage,
                     split.CaptionStage, split.CaptionEmbeddingStage, split.PreviewStage, ClipWriterStage)
    videos = cs.subset(root, corpus, "videos_d", cs.SPLIT_CAPTION_VIDEOS)
    args = cs.split_args(videos, root / "out_d", captioning=True, caption_model="base", t5_embeddings=True,
                         previews=previews)
    SharedCaptionEngine.reset()
    try:
        d = cs.split_run(dev, args, default_runner(), stage_classes)
    finally:
        SharedCaptionEngine.reset()
    out = root / "out_d"
    metas, embs, files = cs.split_outputs(out, VIDEO_EMBED_VARIANTS["video"][1])
    n_clips = cs.SPLIT_CAPTION_VIDEOS * cs.SPLIT_CLIPS // cs.SPLIT_VIDEOS
    assert len(metas) == len(embs) == n_clips, f"run D: {len(metas)} metas"
    windows = 0
    tokens = []
    for uuid, meta in metas.items():
        captions = [w["captions"].get("default", "") for w in meta["windows"]]
        assert all(captions) and all(w["has_t5_embedding"] for w in meta["windows"]), f"run D: {uuid} windows"
        with np.load(out / "t5_embeddings" / f"{uuid}.npz") as npz:
            assert sorted(npz.files) == sorted(f"window_{i}" for i in range(len(captions))), f"run D: {uuid} npz"
            for i, text in enumerate(captions):
                emb = npz[f"window_{i}"]
                n_tok = min(len(text.encode()) + 1, T5_BASE.max_len)
                assert emb.shape == (n_tok, T5_BASE.dim) and np.isfinite(emb).all(), f"run D: {uuid} window {i}"
                tokens.append(n_tok)
                windows += 1
    preview_frames = []
    if previews:
        for uuid in metas:
            data = (out / "previews" / f"{uuid}.webp").read_bytes()
            assert data, f"run D: empty preview of {uuid}"
            img = Image.open(io.BytesIO(data))
            n = getattr(img, "n_frames", 1)
            assert n <= 8 and img.width <= 320, f"run D: preview of {uuid}: {n} frames, {img.width} wide"
            preview_frames.append(n)
        assert d["summary"]["num_with_webp"] == n_clips, d["summary"]
    for name in ("paged_decode", "paged_prefill", "prefill", "flash"):
        assert d["launches"][name] > 0, f"run D: kernel {name} was not launched"
    flash_here = cs.check_new_flash_shapes(timer, d["flash_shapes"], cs.SEED + 23)
    return dict(
        videos=cs.SPLIT_CAPTION_VIDEOS, clips=len(metas), windows_embedded=windows,
        t5_tokens_per_window={"min": min(tokens), "max": max(tokens), "mean": float(np.mean(tokens))},
        previews="written" if previews else "not written: PIL cannot write WebP on this machine",
        preview_frames=preview_frames, npz_files=sum(f.startswith("t5_embeddings/") for f in files),
        wall_s=d["wall"], clips_per_s=len(metas) / d["wall"], stages=cs.stage_busy(d["spans"], d["wall"]),
        launches=d["launches"], peak_device_memory_bytes=d["peak_device"], peak_host_rss_bytes=d["peak_rss"],
        flash_shapes=[[*shape, causal] for shape, causal in sorted(d["flash_shapes"])], flash_checked_here=flash_here,
    )


def read_shards(out: Path) -> dict[str, dict[str, bytes]]:
    """uuid -> {extension: bytes} over every tar under ``out``; a uuid in
    two shards fails."""
    samples: dict[str, dict[str, bytes]] = {}
    for path in sorted(out.rglob("*.tar")):
        with tarfile.open(path) as tar:
            seen = collections.defaultdict(dict)
            for member in tar.getmembers():
                uuid, _, ext = member.name.partition(".")
                seen[uuid][ext] = tar.extractfile(member).read()
        for uuid, parts in seen.items():
            assert uuid not in samples, f"shard: {uuid} in two shards"
            samples[uuid] = parts
    return samples


@contextlib.contextmanager
def timed_module_calls(module, names: tuple, times: dict):
    """``module``'s functions ``names`` wrapped for the duration: each
    call's seconds, the device synchronised at both ends, land in
    ``times[name]``."""
    saved = {name: getattr(module, name) for name in names}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times.setdefault(name, []).append(time.monotonic() - t0)
            return result
        return timed

    for name, fn in saved.items():
        setattr(module, name, wrap(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def planted_rows(dev, n: int, k: int, dim: int, seed: int, copy_every: int = 0):
    """(rows [n, dim] float32 on the host, planted labels): unit centres
    plus noise of the same norm, drawn on the card; with ``copy_every``,
    every ``copy_every``-th row is a near-copy of the row before."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    centres = torch.nn.functional.normalize(torch.randn(k, dim, generator=gen, device=dev), dim=1)
    labels = torch.randint(k, (n,), generator=gen, device=dev)
    x = centres[labels] + torch.randn(n, dim, generator=gen, device=dev) * dim**-0.5
    if copy_every:
        copies = torch.arange(copy_every - 1, n, copy_every, device=dev)
        labels[copies] = labels[copies - 1]
        x[copies] = x[copies - 1] + torch.randn(len(copies), dim, generator=gen, device=dev) * (1e-3 * dim**-0.5)
    return x.cpu().numpy(), labels.cpu().numpy()


def drive_dedup_shard(dev, root: Path) -> dict:
    from cosmos_curate_tpu_torch.dedup import kmeans
    from cosmos_curate_tpu_torch.pipelines.video.dedup import DedupPipelineArgs, load_embeddings, run_dedup
    from cosmos_curate_tpu_torch.pipelines.video.shard import ShardPipelineArgs, run_shard

    # the split outputs: run A's embeddings -> dedup -> shards of the kept
    split_out = root / "out_a"
    ids, vecs, model = load_embeddings(str(split_out))
    t0 = time.monotonic()
    dedup = run_dedup(DedupPipelineArgs(input_path=str(split_out), output_path=str(root / "dedup_a")))
    dedup_wall = time.monotonic() - t0
    csv_path = root / "dedup_a" / f"dedup_summary_{dedup['eps']:g}.csv"
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    kept = [r["clip_uuid"] for r in rows if r["action"] == "kept"]
    removed = [r["clip_uuid"] for r in rows if r["action"] == "removed"]
    assert set(kept) | set(removed) == set(ids) and not set(kept) & set(removed), "dedup: kept and removed"
    assert len(rows) == len(ids) == dedup["num_embeddings"], "dedup: rows"
    assert all(r["duplicate_of"] in set(kept) for r in rows if r["action"] == "removed"), "dedup: duplicate_of"
    t0 = time.monotonic()
    shard = run_shard(ShardPipelineArgs(input_path=str(split_out), output_path=str(root / "shards_a"),
                                        dedup_csv=str(csv_path)))
    shard_wall = time.monotonic() - t0
    samples = read_shards(root / "shards_a")
    assert set(samples) == set(kept), f"shard: {len(samples)} samples for {len(kept)} kept clips"
    vec_of = dict(zip(ids, vecs, strict=True))
    for uuid, parts in samples.items():
        assert parts["mp4"] == (split_out / "clips" / f"{uuid}.mp4").read_bytes(), f"shard: {uuid} mp4"
        meta = json.loads((split_out / "metas" / "v0" / f"{uuid}.json").read_text())
        assert json.loads(parts["json"]) == meta, f"shard: {uuid} meta"
        np.testing.assert_array_equal(np.load(io.BytesIO(parts["embedding.npy"])), vec_of[uuid])
    index = json.loads((root / "shards_a" / "index.json").read_text())
    assert sum(b["num_samples"] for b in index["buckets"].values()) == index["num_samples"] == len(kept)
    assert index["num_skipped_by_dedup"] == len(removed) and index["num_buckets"] == len(index["buckets"])
    assert all(Path(p).exists() for b in index["buckets"].values() for p in b["shards"]), "shard: index paths"

    # k-means at a deployment's size
    t0 = time.monotonic()
    x, labels = planted_rows(dev, KMEANS_N, KMEANS_K, KMEANS_DIM, 31)
    make_s = time.monotonic() - t0
    times: dict = {}
    torch.cuda.reset_peak_memory_stats(dev)
    with timed_module_calls(kmeans, ("_init_centroids", "_lloyd_step"), times):
        t0 = time.monotonic()
        cents, assign = kmeans.kmeans_fit(x, KMEANS_K, iters=KMEANS_ITERS, device=dev)
        fit_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    assert cents.shape == (KMEANS_K, KMEANS_DIM) and assign.shape == (KMEANS_N,)
    joint = np.bincount(assign.astype(np.int64) * KMEANS_K + labels, minlength=KMEANS_K * KMEANS_K)
    joint = joint.reshape(KMEANS_K, KMEANS_K)
    purity = float(joint.max(axis=1).sum() / KMEANS_N)  # each found cluster's majority label
    recall = float(joint.max(axis=0).sum() / KMEANS_N)  # each planted cluster's majority cluster
    del x
    gc.collect()

    # semantic dedup with planted near-copies
    x, _ = planted_rows(dev, SEMDEDUP_N, int(np.sqrt(SEMDEDUP_N)), KMEANS_DIM, 32, SEMDEDUP_COPY_EVERY)
    sem_ids = [f"row-{i:06d}" for i in range(SEMDEDUP_N)]
    sem_times: dict = {}
    with timed_module_calls(kmeans, ("kmeans_fit",), sem_times):
        t0 = time.monotonic()
        result = kmeans.semantic_dedup(x, sem_ids, eps=SEMDEDUP_EPS, device=dev)
        sem_wall = time.monotonic() - t0
    copies = {sem_ids[i] for i in range(SEMDEDUP_COPY_EVERY - 1, SEMDEDUP_N, SEMDEDUP_COPY_EVERY)}
    assert set(result["removed"]) == copies, (
        f"semantic dedup removed {len(result['removed'])}, planted {len(copies)}, "
        f"{len(set(result['removed']) ^ copies)} differ")
    assert all(result["duplicate_of"][c] == sem_ids[int(c.split("-")[1]) - 1] for c in copies), "duplicate_of"
    device_s = sum(sem_times["kmeans_fit"])
    return dict(
        split_dedup={"embeddings": len(ids), "model": model, "dim": int(vecs.shape[1]), "kept": len(kept),
                     "removed": len(removed), "wall_s": dedup_wall, "summary": dedup},
        shard={"samples": len(samples), "buckets": index["num_buckets"],
               "shards": sum(len(b["shards"]) for b in index["buckets"].values()), "wall_s": shard_wall,
               "skipped_by_dedup": index["num_skipped_by_dedup"]},
        kmeans={"n": KMEANS_N, "dim": KMEANS_DIM, "k": KMEANS_K, "max_iters": KMEANS_ITERS,
                "rows_made_s": make_s, "fit_s": fit_s, "init_s": times["_init_centroids"][0],
                "lloyd_iters": len(times["_lloyd_step"]), "lloyd_s_per_iter": times["_lloyd_step"],
                "host_s": fit_s - times["_init_centroids"][0] - sum(times["_lloyd_step"]),
                "peak_memory_bytes": peak, "purity": purity, "planted_recall": recall},
        semantic_dedup={"n": SEMDEDUP_N, "k": int(np.sqrt(SEMDEDUP_N)), "eps": SEMDEDUP_EPS,
                        "planted_copies": len(copies), "removed": len(result["removed"]),
                        "wall_s": sem_wall, "kmeans_device_s": device_s, "host_prune_s": sem_wall - device_s},
    )


def run(cs, dev, timer, root: Path, corpus: list[Path]) -> dict:
    """Every curate phase in order, each line emitted as it ends; returns
    {phase: record}."""
    out = {}
    out["flash_causal"] = flash_causal(cs, timer)
    cs.emit({"phase": "flash_causal", "bound": cs.BOUND, "cases": out["flash_causal"]})
    out["t5"] = drive_t5(dev)
    cs.emit({"phase": "t5", **out["t5"]})
    out["clip_text"] = drive_clip_text(cs, dev, timer)
    cs.emit({"phase": "clip_text", **out["clip_text"]})
    out["split_extras"] = drive_split_extras(cs, dev, timer, root, corpus)
    cs.emit({"phase": "split_extras", **out["split_extras"]})
    out["dedup_shard"] = drive_dedup_shard(dev, root)
    cs.emit({"phase": "dedup_shard", **out["dedup_shard"]})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("curate_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    # pyarrow imported first in a worker thread (the split writer's) has
    # crashed a later read in the main thread (pyarrow 25): import it here
    import pyarrow.parquet  # noqa: F401

    import chip_smoke as cs
    from cosmos_curate_tpu_torch.core.runner import default_runner
    from cosmos_curate_tpu_torch.pipelines.video import split

    dev = torch.device("cuda", 0)
    started = time.monotonic()
    timer, build_s = cs.phase_prologue(dev)
    with cs.split_corpus() as (root, corpus, corpus_s):
        a = cs.split_run(dev, cs.split_args(root / "videos", root / "out_a"), default_runner(),
                         (split.ClipEmbeddingStage,))
        assert a["summary"]["num_with_embeddings"] == cs.SPLIT_CLIPS, a["summary"]
        cs.emit({"phase": "run_a", "wall_s": a["wall"], "corpus_build_s": corpus_s, "build_s": build_s})
        run(cs, dev, timer, root, corpus)
    cs.emit({"phase": "timing", "script_s": time.monotonic() - started})
    return 0


if __name__ == "__main__":
    sys.exit(main())
