"""On-card smoke test of the PyTorch/CUDA port (``cosmos_curate_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``cosmos_curate_tpu_torch/csrc``
and prints one JSON line per phase:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA,
   which optional modules import (``cv2``, ``msgpack``, ``cloudpickle``,
   ``prometheus_client``, ``pyarrow``), and which FFmpeg libraries and
   headers are installed;
2. build: seconds to compile every kernel (one ``nvcc`` per source, in
   parallel), and the HGMMA / UTMALDG / FFMA counts of the tensor-core
   kernels' SASS (flash, prefill, paged: each must hold wgmma and TMA loads);
3. kernels: each kernel against its plain PyTorch version at the shapes the
   caption engine gives it at ``VLM_BASE`` width (bf16 inputs, the plain
   version in fp32 on the same inputs, bound 1e-2 max abs error; paged
   decode and contiguous decode at both lanes' widths, 1024 and 256 keys,
   contiguous decode also within it of its split mirror in fp32 and
   bit-equal to paged decode on its rows scattered into a pool; paged
   prefill also bit-equal to the contiguous prefill kernel on
   the gathered rows), timed with
   CUDA events (median of 30 launches after warm-up, L2 flushed between
   launches, the host kept ahead of the device), beside the card's least
   time for the same work and one
   ``scaled_dot_product_attention`` call on the equivalent gathered /
   contiguous tensors (a yardstick only; it excludes the gather, and the port
   never calls it), with ``bound_share`` (bound / kernel time) and
   ``vs_library`` (kernel time / SDPA time). A ``card_state`` line before
   and after the phase reads the SM clock, its maximum, the power draw and
   the temperature, so a slow card and a slow kernel can be told apart;
4. embed: ``ClipEmbeddingStage(variant="video")`` at ``VIDEO_EMBED_BASE``
   with seeded random weights embeds the main path's shapes (8 stage calls
   of 8 tasks x 4 clips x 8 random uint8 224x224 frames, 32 clips per call
   in micro-batches of ``EMBED_MICRO_BATCH`` clips) after a warm-up call:
   clips/s, the pipeline's per-dispatch copy-in / compute / copy-out times,
   peak memory and flash launches; every clip must hold a finite unit-norm
   embedding, within ``EMBED_BOUND`` of the same stage with the flash kernel
   swapped for its plain version, while the plain version with one key
   tile dropped (the first, or the ragged last) must land beyond that bound.
   Then clips/s of ``VideoEmbedder.encode_clips`` on the same calls at
   micro-batches of 32, 16 and 8 clips, over ``SWEEP_ROUNDS`` rounds in
   rotating order;
5. slice: ``CaptionEngine(VLM_BASE)`` with seeded random weights answers the
   caption benchmark's base workload (8 requests, 4 random 224x224 frames,
   the default prompt or the 686-token long prompt as shared prefix, 64 new
   tokens) through the paged kernels;
6. gather: the same workload through ``CaptionEngine(VLM_BASE,
   paged_attention="gather")``, whose decode steps run the contiguous decode
   kernel and whose prefills run the contiguous prefill kernel; the paged
   kernels must not launch there; then 16 of its engine steps under the
   profiler, as in 7 (``gather_breakdown``);
   witness: for each request the two engines answer differently, the first
   differing step and both engines' top-2 logits there, and which engine
   six more drives side with: a paged drive with both paged kernels held
   against their fp32 plain versions on every call (within 1e-2 of the
   call's largest output), and gather drives with the prefill kernel
   again, with the kernel held the same way, with its plain version in its
   place, with the plain version in fp32, and with it at the kernel's
   stated precision. That paged drive counts its paged calls by shape and
   snapshots each prefill shape's first call (inputs, pool layer, output);
   paged prefill is then checked and timed at the (B, T) it sent most, on
   that snapshot (``paged_prefill_at_drive_shape``);
7. breakdown: with both lanes of the paged engine decoding, 16 engine steps
   without a profiler (wall time per step), then 16 under torch.profiler
   tracing the device only (device time by kernel, the decode kernel's own
   time and launches, launches per step, and the device's idle share of
   that traced window);
8. forward: the engine's model on a small input with every kernel against
   the same forward with each kernel replaced by its plain version;
9. pipeline: the annotate half of the main path through the port's own
   ``run_pipeline``: ``ClipEmbeddingStage(variant="video")`` ->
   ``CaptionPrepStage`` -> ``CaptionStage(model_flavor="base")`` at
   ``VIDEO_EMBED_BASE`` and ``VLM_BASE`` (seeded random weights) over the
   embed phase's shapes (tasks of 4 clips x 8 random uint8 224x224 frames,
   each clip one caption window). The default runner (the
   ``PipelinedRunner``) over ``PIPELINE_TASKS`` tasks, more than one embed
   stage call can take, so the embed stage embeds while the caption stage
   decodes, from two host threads on one card; then ``SequentialRunner``
   over 2 of the tasks; then the caption pipeline efficiency as
   ``benchmarks/caption_benchmark.py`` defines it: the windows of
   ``EFFICIENCY_TASKS`` tasks straight into the shared engine, then the
   same windows through ``CaptionStage``, each pass's decode tokens over its
   wall, and the ratio. Reported: clips embedded and windows captioned, wall time, clips/s, in-pipeline
   caption tok/s, the runner's overlap fraction and the seconds during
   which the embed and caption stages ran at once (both asserted above 0),
   each kernel's launches, the CUDA stream each stage's worker thread
   launched on, peak memory, and how far the two runners agree (the same
   clips and windows, embeddings within ``EMBED_BOUND``, identical
   captions reported).

Every path's run zeroes the launch counters just before it and reads them
just after; each kernel must have launched on the path that uses it
(``KERNEL_PATH``).

Then the ``{"kernels": [...]}`` line, the card line, and the last line
``{"ok": true, "device": {...}}``. Any failed check raises: the script exits
non-zero and prints no result. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import collections
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
BOUND = 1e-2  # kernel vs plain version, max abs error (bf16 output)
# embed stage with the flash kernel vs with its plain version, max abs error
# of unit-norm 768-d embeddings: above the 1.2e-3 sound runs read, below
# what a kernel that drops one key tile gives (PERF.md)
EMBED_BOUND = 3e-3
SWEEP_ROUNDS = 6  # rounds of the embed phase's micro-batch sweep
FORWARD_BOUND = 5e-2  # 12-layer logits, kernels vs plain versions, bf16
SEED = 0

# TPU kernels these replace: the pl.pallas_call of each
REPLACES = {
    "paged_decode": "cosmos_curate_tpu/ops/paged_attention.py:210",
    "paged_prefill": "cosmos_curate_tpu/ops/paged_attention.py:264",
    "prefill": "cosmos_curate_tpu/ops/prefill_attention.py:146",
    "decode": "cosmos_curate_tpu/ops/decode_attention.py:112",
    "flash": "cosmos_curate_tpu/ops/flash_attention.py:125",
}
SOURCES = {
    "paged_decode": "cosmos_curate_tpu_torch/csrc/paged_attention.cu",
    "paged_prefill": "cosmos_curate_tpu_torch/csrc/paged_attention.cu",
    "prefill": "cosmos_curate_tpu_torch/csrc/prefill_attention.cu",
    "decode": "cosmos_curate_tpu_torch/csrc/decode_attention.cu",
    "flash": "cosmos_curate_tpu_torch/csrc/flash_attention.cu",
}
# the path whose run counts each kernel's launches
KERNEL_PATH = {
    "paged_decode": "slice",
    "paged_prefill": "slice",
    "prefill": "slice",
    "decode": "gather",
    "flash": "embed",
}
# kernels the pipeline phase must launch (cct_decode serves only the gather
# engine, which no stage uses)
PIPELINE_KERNELS = ("paged_decode", "paged_prefill", "prefill", "flash")
# six embed stage calls (192 clips): the caption stage's first batch takes
# at most 32 tasks and waits 0.2 s for them, while an embed call of 8 tasks
# takes under 0.1 s, so with fewer tasks embedding ends before captioning
# starts and the two device stages never run at once
PIPELINE_TASKS = 48
PIPELINE_SEQUENTIAL_TASKS = 2
EFFICIENCY_TASKS = 8  # 32 windows: through the engine alone, then CaptionStage
# modules and FFmpeg libraries the port's later slices may need (split
# assembly decodes and encodes through cv2 and a native H.264 writer over
# libavcodec, and writes parquet with pyarrow); the device phase reports
# which are here
OPTIONAL_MODULES = ("cv2", "msgpack", "cloudpickle", "prometheus_client", "pyarrow")
FFMPEG_LIBRARIES = ("avcodec", "avformat", "avutil", "swscale", "x264")
# embed phase: stage calls timed, clips per task (4 one-second clips of
# bench.py's videos), so each call is one 32-clip dispatch
EMBED_CALLS = 8
EMBED_CLIPS_PER_TASK = 4
# flash shapes timed: ViT-B/16 at 224^2 over the embed phase's 16-clip x
# 8-frame dispatch (the row of the kernels line) and over 32 clips, the
# base pooler over 16 clips, and a causal ViT-B/16-at-768^2 length
FLASH_CASES = (
    ("vit_b16_224", (128, 12, 197, 64), False),
    ("vit_b16_224_32_clips", (256, 12, 197, 64), False),
    ("pooler", (16, 8, 9, 64), False),
    ("causal_2305", (1, 16, 2305, 64), True),
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sass_counts() -> dict:
    """Instructions of the tensor-core kernels' built libraries, from
    ``cuobjdump -sass``: HGMMA (wgmma), UTMALDG (TMA tile loads) and FFMA
    (fp32 FMAs on the CUDA cores)."""
    from cosmos_curate_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for name in ("flash_attention", "prefill_attention", "paged_attention"):
        sass = subprocess.run(
            [tool, "-sass", str(_build._library_path(name))], capture_output=True, text=True, check=True, timeout=120
        ).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG", "FFMA")}
        assert counts[name]["HGMMA"] > 0 and counts[name]["UTMALDG"] > 0, f"{name}: no wgmma / TMA in its SASS"
    return counts


def flash_key_tile() -> int:
    """Keys per tile of the flash kernel: ``kBK`` of its tensor-core body,
    read from the source, so the dropped-tile controls drop one real tile."""
    from cosmos_curate_tpu_torch.ops import _build

    header = (_build.CSRC / "tc_attention.cuh").read_text()
    return int(re.search(r"constexpr int kBK = (\d+);", header).group(1))


def gpu_state() -> dict:
    """The card's SM clock, its maximum, power draw and temperature now."""
    keys = ("clocks.sm", "clocks.max.sm", "power.draw", "temperature.gpu")
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={','.join(keys)}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return dict(zip(keys, (v.strip() for v in out.stdout.strip().splitlines()[0].split(","))))


def with_shares(result: dict) -> dict:
    """A kernel's timing record with its share of the bound (bound / kernel
    time) and its time over the library call's."""
    return {**result, "bound_share": result["bound_ms"] / result["kernel_ms"],
            "vs_library": result["kernel_ms"] / result["library_ms"]}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of one call, L2 flushed before each launch.
    The device spins for ~0.5 ms after the flush, so the host has enqueued
    the call before its start event fires: the time is the device's, not
    the host's wrapper and launch overhead."""

    def __init__(self, device) -> None:
        self._flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=device)

    def __call__(self, fn, iters: int = 30, warmup: int = 5) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self._flush.zero_()
            torch.cuda._sleep(1_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    by_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    by_ops = flops / H100_BF16_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def visible_keys(write, kv_len, t: int) -> np.ndarray:
    """[B, T] keys each query sees: causal at write + t, below kv_len."""
    pos = write[:, None] + np.arange(t)[None, :]
    return np.minimum(pos + 1, kv_len[:, None])


def attention_work(q_shape, write, kv_len, hk: int, d: int) -> tuple[float, float]:
    """(bytes, flops) the chunk attention needs for these inputs: q and out
    once, each visible K/V row once per (row, kv head), tables and lengths;
    4 * D flops per (query head, visible key)."""
    b, t, _, g, _ = q_shape
    vis = visible_keys(write, kv_len, t)
    kv_rows = vis.max(axis=1).sum()
    n_bytes = 2 * (2 * b * t * hk * g * d) + 2 * (2 * kv_rows * hk * d) + 8 * b
    flops = 4.0 * d * g * hk * vis.sum()
    return n_bytes, flops


def sdpa_inputs(q, k, v, write, kv_len):
    """[B, T, Hkv, G, D] q and [B, S, Hkv, D] K/V -> SDPA layout + mask."""
    b, t, hk, g, d = q.shape
    s = k.shape[1]
    qs = q.reshape(b, t, hk * g, d).transpose(1, 2).contiguous()
    ks = k.transpose(1, 2).contiguous()
    vs = v.transpose(1, 2).contiguous()
    k_pos = torch.arange(s, device=q.device)[None, None, None, :]
    q_pos = (write[:, None] + torch.arange(t, device=q.device)[None, :])[:, None, :, None]
    mask = (k_pos <= q_pos) & (k_pos < kv_len[:, None, None, None])
    return qs, ks, vs, mask


def check_kernels(timer, dev) -> dict:
    from cosmos_curate_tpu_torch.ops import kernels
    from cosmos_curate_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
    from cosmos_curate_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from cosmos_curate_tpu_torch.ops.paged_attention import (
        decode_split_count,
        decode_split_plain,
        paged_attention,
        paged_attention_plain,
    )
    from cosmos_curate_tpu_torch.ops.prefill_attention import chunk_attention_plain, prefill_attention

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(SEED)
    hk, g, d, bs = 8, 2, 64, 16

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=dev)

    results = {}

    def paged_case(name, b, t, write, kv_len, nbl, idle_row=False):
        n_blocks = b * nbl + 1
        pk, pv = bf16(2, n_blocks, bs, hk, d), bf16(2, n_blocks, bs, hk, d)
        tables = rng.permutation(np.arange(1, n_blocks))[: b * nbl].reshape(b, nbl)
        if idle_row:
            tables[-1] = 0  # garbage block 0, kv_len 1
        q = bf16(b, t, hk, g, d)
        tb, wi, kl = i32(tables), i32(write), i32(kv_len)

        def run():
            return paged_attention(q, pk, pv, tb, wi, kl, layer_index=1)

        def plain():
            return paged_attention_plain(q, pk, pv, tb, wi, kl, layer_index=1, sm_scale=d**-0.5)

        got = run()
        want = paged_attention_plain(
            q.float(), pk.float(), pv.float(), tb, wi, kl, layer_index=1, sm_scale=d**-0.5
        )
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all(), f"{name}: non-finite output"
        err = (got.float() - want).abs().max().item()
        assert err <= BOUND, f"{name}: max abs err {err} > {BOUND}"
        gk = pk[1][tb.long()].reshape(b, nbl * bs, hk, d)
        gv = pv[1][tb.long()].reshape(b, nbl * bs, hk, d)
        if t > 1:  # one body, one geometry: bit-equal to cct_prefill on the gathered rows
            assert torch.equal(got, prefill_attention(q, gk.contiguous(), gv.contiguous(), wi, kl)), (
                f"{name}: not bit-equal to the contiguous prefill kernel on gathered rows"
            )
        qs, ks, vs, mask = sdpa_inputs(q, gk, gv, wi, kl)
        n_bytes, flops = attention_work(q.shape, np.asarray(write), np.asarray(kv_len), hk, d)
        bms, by = bound_ms(n_bytes, flops)
        return dict(
            shape=dict(B=b, T=t, Hkv=hk, G=g, D=d, bs=bs, nbl=nbl),
            max_abs_err=err,
            kernel_ms=timer(run),
            plain_ms=timer(plain),
            bound_ms=bms,
            bound_by=by,
            library_ms=timer(lambda: sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True)),
            bit_equal_to_prefill=t > 1 or None,
        )

    # decode: each lane of 4 slots (1024 and 256 keys), random lengths, the
    # last row idle; the long lane is the kernels line's row
    decode = {}
    for label, nbl in (("lane_1024", 64), ("lane_256", 16)):
        kv = rng.integers(64, nbl * bs, 4)
        kv[-1] = 1
        decode[label] = with_shares(paged_case(f"paged_decode {label}", 4, 1, kv - 1, kv, nbl, idle_row=True))
    results["paged_decode"] = {**decode["lane_1024"], "cases": decode}
    # paged prefill: a 256-token chunk, one fresh row and one mid-context row
    results["paged_prefill"] = paged_case("paged_prefill", 2, 256, np.array([0, 300]), np.array([256, 556]), 64)

    # contiguous prefill: the long prompt's shared-prefix build, S = T = 1024
    s, t, kv_len = 1024, 1024, 686
    q, k, v = bf16(1, t, hk, g, d), bf16(1, s, hk, d), bf16(1, s, hk, d)
    wi, kl = i32([0]), i32([kv_len])

    def run():
        return prefill_attention(q, k, v, wi, kl)

    got = run()
    want = chunk_attention_plain(q.float(), k.float(), v.float(), wi, kl, d**-0.5)
    torch.cuda.synchronize()
    err = (got.float() - want).abs().max().item()
    qs, ks, vs, mask = sdpa_inputs(q, k, v, wi, kl)
    n_bytes, flops = attention_work(q.shape, np.array([0]), np.array([kv_len]), hk, d)
    bms, by = bound_ms(n_bytes, flops)
    results["prefill"] = dict(
        shape=dict(B=1, T=t, S=s, Hkv=hk, G=g, D=d, kv_len=kv_len),
        max_abs_err=err,
        kernel_ms=timer(run),
        plain_ms=timer(lambda: chunk_attention_plain(q, k, v, wi, kl, d**-0.5)),
        bound_ms=bms,
        bound_by=by,
        library_ms=timer(lambda: sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True)),
    )
    assert err <= BOUND, f"prefill: max abs err {err} > {BOUND}"

    # contiguous decode: each lane of the gather engine (4 slots, caches of
    # 1024 and 256 keys), random lengths, the last row at 1; the long lane is
    # the kernels line's row. The same rows scattered into a shuffled pool
    # must give paged decode's output bit for bit: one split body, one split
    # count, one merge order.
    decode = {}
    for label, s in (("lane_1024", 1024), ("lane_256", 256)):
        b, nbl = 4, s // bs
        kv = rng.integers(64, s + 1, b)
        kv[-1] = 1
        q, k, v = bf16(b, hk, g, d), bf16(b, s, hk, d), bf16(b, s, hk, d)
        kl = i32(kv)

        def run():
            return decode_attention(q, k, v, kl)

        got = run()
        want = decode_attention_plain(q.float(), k.float(), v.float(), kl, sm_scale=d**-0.5)
        n_split = decode_split_count(s, b * hk, torch.cuda.get_device_properties(dev).multi_processor_count)
        mirror = decode_split_plain(q.float(), k.float(), v.float(), kl, sm_scale=d**-0.5, n_split=n_split)
        n_blocks = b * nbl + 1
        tables = i32(rng.permutation(np.arange(1, n_blocks)).reshape(b, nbl))
        pk = torch.zeros(2, n_blocks, bs, hk, d, dtype=torch.bfloat16, device=dev)
        pv = torch.zeros_like(pk)
        pk[1][tables.long()] = k.reshape(b, nbl, bs, hk, d)
        pv[1][tables.long()] = v.reshape(b, nbl, bs, hk, d)
        paged = paged_attention(q[:, None], pk, pv, tables, kl - 1, kl, layer_index=1)[:, 0]
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all(), f"decode {label}: non-finite output"
        err = (got.float() - want).abs().max().item()
        mirror_err = (got.float() - mirror).abs().max().item()
        assert max(err, mirror_err) <= BOUND, f"decode {label}: max abs err {err}, {mirror_err} > {BOUND}"
        assert torch.equal(got, paged), f"decode {label}: not bit-equal to paged decode on the same rows"
        qs, ks, vs, mask = sdpa_inputs(q[:, None], k, v, kl - 1, kl)
        bms, by = bound_ms(*attention_work((b, 1, hk, g, d), kv - 1, kv, hk, d))
        decode[label] = with_shares(dict(
            shape=dict(B=b, S=s, Hkv=hk, G=g, D=d, kv_len=kv.tolist(), n_split=n_split),
            max_abs_err=err,
            max_abs_err_vs_split_mirror=mirror_err,
            kernel_ms=timer(run),
            plain_ms=timer(lambda: decode_attention_plain(q, k, v, kl, sm_scale=d**-0.5)),
            bound_ms=bms,
            bound_by=by,
            library_ms=timer(lambda: sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True)),
            bit_equal_to_paged_decode=True,
        ))
    results["decode"] = {**decode["lane_1024"], "cases": decode}

    flash = {}
    for label, shape, causal in FLASH_CASES:
        q, k, v = bf16(*shape), bf16(*shape), bf16(*shape)

        def run():
            return flash_attention(q, k, v, causal=causal)

        got = run()
        want = flash_attention_plain(q.float(), k.float(), v.float(), causal=causal)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        fb, fh, fs, fd = shape
        pairs = fs * (fs + 1) // 2 if causal else fs * fs
        bms, by = bound_ms(4 * 2 * fb * fh * fs * fd, 4.0 * fd * fb * fh * pairs)
        flash[label] = dict(
            shape=dict(B=fb, H=fh, S=fs, D=fd, causal=causal),
            max_abs_err=err,
            kernel_ms=timer(run),
            plain_ms=timer(lambda: flash_attention_plain(q, k, v, causal=causal)),
            bound_ms=bms,
            bound_by=by,
            library_ms=timer(lambda: sdpa(q, k, v, is_causal=causal)),
        )
        assert err <= BOUND, f"flash {label}: max abs err {err} > {BOUND}"
    flash = {label: with_shares(r) for label, r in flash.items()}
    results = {name: r if "cases" in r else with_shares(r) for name, r in results.items()}
    results["flash"] = {**flash[FLASH_CASES[0][0]], "cases": flash}
    assert set(results) == set(kernels())
    return results


def check_forward(model, dev) -> dict:
    """The engine's model with its kernels vs the same forward with each
    kernel swapped for its plain version (paged prefill + decode on a
    fragmented pool, a contiguous prefix build and a contiguous decode step
    on top of it)."""
    import cosmos_curate_tpu_torch.models.vlm.model as vlm_model
    from cosmos_curate_tpu_torch.models.vlm.model import init_cache
    from cosmos_curate_tpu_torch.ops.decode_attention import decode_attention_plain
    from cosmos_curate_tpu_torch.ops.paged_attention import paged_attention_plain
    from cosmos_curate_tpu_torch.ops.prefill_attention import chunk_attention_plain

    cfg = model.cfg
    rng = np.random.default_rng(SEED + 1)
    b, t, bs, nbl = 2, 64, 16, 8
    n_blocks = b * nbl + 1
    tables = torch.as_tensor(
        rng.permutation(np.arange(1, n_blocks)).reshape(b, nbl).astype(np.int32), device=dev
    )
    embeds = torch.as_tensor(rng.standard_normal((b, t, cfg.dim)).astype(np.float32), device=dev)
    write = torch.tensor([0, 40], dtype=torch.int32, device=dev)  # row 0 first: pos[0] = 0..t-1
    pos = write[:, None] + torch.arange(t, device=dev, dtype=torch.int32)[None]

    def run():
        shape = (cfg.n_layers, n_blocks, bs, cfg.n_kv_heads, cfg.head_dim)
        pk = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        pv = torch.zeros_like(pk)
        with torch.inference_mode():
            pre, _, _ = model.paged_forward(embeds, pk, pv, pos, write, write + t, tables)
            nxt = write + t
            dec, _, _ = model.paged_forward(embeds[:, :1], pk, pv, nxt[:, None], nxt, nxt + 1, tables)
            ck, cv = init_cache(cfg, 1, length=t, device=dev)
            zero = torch.zeros(1, dtype=torch.int32, device=dev)
            con, _, _ = model(embeds[:1], ck, cv, pos[:1], zero, zero + 50)
            cdec, _, _ = model(embeds[:1, :1], ck, cv, pos[:1, 50:51], zero + 50, zero + 51)
        return pre.float(), dec.float(), con.float(), cdec.float()

    got = run()
    saved = vlm_model.paged_attention, vlm_model.prefill_attention, vlm_model.decode_attention
    try:
        vlm_model.paged_attention = lambda q, pk, pv, tb, wi, kl, *, layer_index=0: paged_attention_plain(
            q, pk, pv, tb, wi, kl, layer_index=layer_index, sm_scale=q.shape[-1] ** -0.5
        )
        vlm_model.prefill_attention = lambda q, k, v, wi, kl: chunk_attention_plain(
            q, k, v, wi, kl, q.shape[-1] ** -0.5
        )
        vlm_model.decode_attention = lambda q, k, v, kl: decode_attention_plain(
            q, k, v, kl, sm_scale=q.shape[-1] ** -0.5
        )
        want = run()
    finally:
        vlm_model.paged_attention, vlm_model.prefill_attention, vlm_model.decode_attention = saved
    out = {}
    names = ("paged_prefill", "paged_decode", "contiguous_prefill", "contiguous_decode")
    for name, a, w in zip(names, got, want, strict=True):
        assert a.shape[-1] == cfg.vocab and torch.isfinite(a).all(), name
        out[name] = (a - w).abs().max().item()
        assert out[name] <= FORWARD_BOUND, f"forward {name}: {out[name]} > {FORWARD_BOUND}"
    return out


def drive_embed(dev) -> dict:
    """The main path's embed leg at bench.py's shapes: ClipEmbeddingStage
    (variant "video", VIDEO_EMBED_BASE, seeded) over EMBED_CALLS stage calls
    of EMBED_STAGE_TASK_BATCH tasks x EMBED_CLIPS_PER_TASK clips x 8 random
    uint8 224x224 frames (extraction at 8 fps over 1 s clips)."""
    import cosmos_curate_tpu_torch.models.layers as layers
    from cosmos_curate_tpu_torch.core.stage import WorkerMetadata
    from cosmos_curate_tpu_torch.data.model import Clip, FrameExtractionSignature, SplitPipeTask, Video
    from cosmos_curate_tpu_torch.models.embedder import EMBED_MICRO_BATCH, VIDEO_EMBED_BASE
    from cosmos_curate_tpu_torch.ops import kernels
    from cosmos_curate_tpu_torch.ops.flash_attention import flash_attention_plain
    from cosmos_curate_tpu_torch.pipelines.video.stages.embedding import (
        EMBED_STAGE_TASK_BATCH,
        ClipEmbeddingStage,
    )

    cfg = VIDEO_EMBED_BASE
    extraction = FrameExtractionSignature("fps", 8.0)
    key = extraction.key()
    size = cfg.vit.image_size
    rng = np.random.default_rng(SEED + 2)

    def make_tasks(call: int) -> list:
        tasks = []
        for t in range(EMBED_STAGE_TASK_BATCH):
            name = f"video-{call}-{t}"
            clips = [
                Clip(
                    source_video=name,
                    span=(float(i), float(i + 1)),
                    extracted_frames={
                        key: rng.integers(0, 256, (cfg.num_frames, size, size, 3), dtype=np.uint8)
                    },
                )
                for i in range(EMBED_CLIPS_PER_TASK)
            ]
            tasks.append(SplitPipeTask(video=Video(path=f"{name}.mp4", clips=clips)))
        return tasks

    t0 = time.monotonic()
    stage = ClipEmbeddingStage(variant="video", extraction=extraction, device=dev)
    stage.setup(WorkerMetadata(stage_name="embed"))
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    batches = [make_tasks(c) for c in range(EMBED_CALLS + 1)]
    stage.process_data(batches[0])  # warm-up (cuBLAS handles, allocator)
    torch.cuda.synchronize()

    pipeline = stage.model.device_pipeline
    pipeline.records.clear()
    ks = kernels()
    for k in ks.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    for tasks in batches[1:]:
        stage.process_data(tasks)
    torch.cuda.synchronize()
    elapsed = time.monotonic() - t0
    launches = {name: k.launches for name, k in ks.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    records = list(pipeline.records)

    clips = [c for tasks in batches[1:] for t in tasks for c in t.video.clips]
    for c in clips:
        emb = c.embeddings[stage.model_name]
        assert emb.shape == (cfg.output_dim,) and np.isfinite(emb).all(), "bad embedding"
        assert abs(float(np.linalg.norm(emb)) - 1.0) < 1e-3, "embedding not unit norm"
    n_attn = cfg.vit.layers + cfg.temporal_layers
    assert launches["flash"] == n_attn * len(records), f"flash launches {launches['flash']} != {n_attn} x {len(records)}"
    # the kernels phase timed flash at this path's ViT dispatch shape
    assert {r.padded_rows * cfg.num_frames for r in records} == {FLASH_CASES[0][1][0]}, "flash case off the path"

    # the same stage with the flash kernel swapped for its plain version,
    # and for that version with one key tile dropped: what a kernel that
    # skipped the tile would give, which the bound must tell apart
    first = batches[1]
    with_kernel = [c.embeddings[stage.model_name].copy() for t in first for c in t.video.clips]

    tile = flash_key_tile()

    def dropping(lo: int, hi: int):
        def attn(q, k, v, *, causal=False):
            s = q.shape[2]
            if s <= tile:
                return flash_attention_plain(q, k, v, causal=causal)
            keep = torch.cat([torch.arange(0, lo), torch.arange(min(hi, s), s)]).to(q.device)
            return flash_attention_plain(q, k[:, :, keep], v[:, :, keep], causal=causal)

        return attn

    s_vit = cfg.vit.num_patches + 1  # with the class token
    last = (s_vit - 1) // tile * tile
    errs = {}
    for label, attn in (("plain", flash_attention_plain), ("first_tile_dropped", dropping(0, tile)),
                        ("last_tile_dropped", dropping(last, s_vit))):
        saved = layers.flash_attention
        try:
            layers.flash_attention = attn
            stage.process_data(first)
        finally:
            layers.flash_attention = saved
        got = [c.embeddings[stage.model_name] for t in first for c in t.video.clips]
        errs[label] = max(float(np.abs(a - b).max()) for a, b in zip(with_kernel, got))
    plain_err = errs["plain"]
    assert plain_err <= EMBED_BOUND, f"embed: kernel vs plain flash {plain_err} > {EMBED_BOUND}"

    n_disp = len(records)
    return dict(
        breakdown=profile_window(lambda: stage.process_data(batches[1]), 2, "stage call"),
        config={"vit_width": cfg.vit.width, "vit_layers": cfg.vit.layers, "vit_heads": cfg.vit.heads,
                "image_size": size, "num_frames": cfg.num_frames, "temporal_layers": cfg.temporal_layers,
                "temporal_heads": cfg.temporal_heads, "output_dim": cfg.output_dim},
        stage_calls=EMBED_CALLS,
        clips=len(clips),
        dispatches=n_disp,
        elapsed_s=elapsed,
        clips_per_s=len(clips) / elapsed,
        wall_ms_per_dispatch=1e3 * elapsed / n_disp,
        h2d_ms_per_dispatch=1e3 * sum(r.h2d_s for r in records) / n_disp,
        compute_ms_per_dispatch=1e3 * sum(r.compute_s for r in records) / n_disp,
        d2h_ms_per_dispatch=1e3 * sum(r.d2h_s for r in records) / n_disp,
        gap_ms_per_dispatch=1e3 * sum(r.gap_s for r in records) / n_disp,
        rows_per_dispatch=[r.rows for r in records],
        max_abs_err_vs_plain_flash=plain_err,
        embed_bound=EMBED_BOUND,
        max_abs_err_vs_plain_flash_with_a_tile_dropped={k: v for k, v in errs.items() if k != "plain"},
        micro_batch=EMBED_MICRO_BATCH,
        micro_batch_sweep=sweep_micro_batch(batches, key, dev),
        setup_s=setup_s,
        launches=launches,
        peak_memory_bytes=peak,
    )


def sweep_micro_batch(batches, key: str, dev, rounds: int = SWEEP_ROUNDS) -> dict:
    """clips/s of VideoEmbedder.encode_clips (VIDEO_EMBED_BASE, seeded) over
    the embed phase's calls (32 clips each, handed over as a list) at
    micro-batches of 32, 16 and 8 clips. ``rounds`` rounds, each in another
    order; per setting, every reading and the median."""
    import cosmos_curate_tpu_torch.models.embedder as embedder

    calls = [[c.extracted_frames[key] for t in tasks for c in t.video.clips] for tasks in batches[1:]]
    settings = {"rows_32": 32, "rows_16": 16, "rows_8": 8}
    embedders = {}
    saved = embedder.EMBED_MICRO_BATCH
    try:
        for label, cap in settings.items():
            embedder.EMBED_MICRO_BATCH = cap  # read by setup()
            emb = embedder.VideoEmbedder(embedder.VIDEO_EMBED_BASE, device=dev)
            emb.setup(seed=SEED)
            embedders[label] = emb
    finally:
        embedder.EMBED_MICRO_BATCH = saved

    def one_pass(label: str) -> tuple[float, float]:
        emb = embedders[label]
        emb.device_pipeline.records.clear()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for clips in calls:
            emb.encode_clips(clips)
        torch.cuda.synchronize()
        elapsed = time.monotonic() - t0
        compute_s = sum(r.compute_s for r in emb.device_pipeline.records)
        return sum(map(len, calls)) / elapsed, 1e3 * compute_s / len(calls)

    labels = list(settings)
    for label in labels:  # warm-up: cuBLAS handles, pinned host blocks
        embedders[label].encode_clips(calls[0])
    readings = {label: [] for label in labels}
    for r in range(rounds):
        order = labels[r % len(labels):] + labels[: r % len(labels)]
        for label in order if r % 2 == 0 else reversed(order):
            readings[label].append(one_pass(label))
    return {
        label: {"clips_per_s": [c for c, _ in rs], "median_clips_per_s": statistics.median(c for c, _ in rs),
                "compute_ms_per_call": [m for _, m in rs], "dispatches_per_call": -(-len(calls[0]) // settings[label])}
        for label, rs in readings.items()
    }


def record_greedy(engine):
    """Record each request's greedy choices in ``engine``, step by step,
    from the first token's logits and each decode step's: request id ->
    step -> (the id the engine chose, that step's fp32 logits). Returns the
    record and a function that gives the engine its own methods back."""
    steps: dict[str, dict[int, tuple[int, np.ndarray]]] = {}
    start_slot, decode = engine._start_slot, engine._decode

    def first(lane, slot_idx, req, t_valid, next_rope, logits_row):
        row = np.asarray(logits_row, np.float32)
        steps.setdefault(req.request_id, {})[0] = (int(np.argmax(row)), row)  # sample_token's greedy choice
        return start_slot(lane, slot_idx, req, t_valid, next_rope, logits_row)

    def step(tables, tokens, positions, rope_positions):
        greedy, logits = decode(tables, tokens, positions, rope_positions)
        lane = next(lane for lane in engine.lanes if lane.table is tables)
        rows = logits.float().cpu().numpy()
        for i, slot in lane.slots.items():
            steps.setdefault(slot.request.request_id, {})[len(slot.generated)] = (int(greedy[i]), rows[i])
        return greedy, logits

    engine._start_slot, engine._decode = first, step

    def restore() -> None:
        del engine._start_slot, engine._decode

    return steps, restore


def drive_slice(dev, cfg, paged_attention="auto", kv_lanes=((256, 4), (1024, 4))) -> tuple:
    """The caption benchmark's base workload through CaptionEngine (its
    lanes: half the slots at 256 positions, half at max_seq). Returns the
    record, the engine, the request factory, request id -> text, and each
    request's greedy choices (``record_greedy``)."""
    from cosmos_curate_tpu_torch.models.prompts import get_caption_prompt
    from cosmos_curate_tpu_torch.models.vlm import CaptionEngine, CaptionRequest, SamplingConfig
    from cosmos_curate_tpu_torch.ops import kernels

    t0 = time.monotonic()
    engine = CaptionEngine(
        cfg, max_batch=8, kv_lanes=kv_lanes, async_prep=True, paged_attention=paged_attention, device=dev
    )
    engine.setup(seed=SEED)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    tok = engine.tokenizer
    prompt = get_caption_prompt("default")
    prompt_ids = tok.encode(prompt)
    long_ids = tok.encode(prompt + " transcript: " + "the camera pans across the scene. " * 40)
    rng = np.random.default_rng(SEED)
    size = cfg.vision.image_size

    def make_request(rid: str, i: int, max_new: int = 64) -> CaptionRequest:
        return CaptionRequest(
            request_id=rid,
            prefix_ids=list(long_ids if i % 3 == 2 else prompt_ids),
            prompt_ids=[],
            frames=rng.integers(0, 255, (4, size, size, 3), dtype=np.uint8),
            sampling=SamplingConfig(max_new_tokens=max_new),
        )

    # warm-up (cuBLAS handles, allocator): a short pass, then the prefix
    # cache is dropped so the measured run builds its prefixes itself
    for i in range(3):
        engine.add_request(make_request(f"warmup-{i}", i, max_new=4))
    engine.run_until_complete()
    engine.clear_prefix_cache()
    engine.reset_stats()
    torch.cuda.synchronize()

    ks = kernels()
    for k in ks.values():
        k.launches = 0
    # earlier phases' models are held by reference cycles (an embedder and
    # its pipeline's bound forward); free them so the peak is this drive's
    gc.collect()
    torch.cuda.reset_peak_memory_stats(dev)
    n_requests = 8
    greedy, restore = record_greedy(engine)
    t0 = time.monotonic()
    for i in range(n_requests):
        engine.add_request(make_request(f"r{i}", i))
    results = engine.run_until_complete()
    torch.cuda.synchronize()
    elapsed = time.monotonic() - t0
    launches = {name: k.launches for name, k in ks.items()}
    restore()

    assert len(results) == n_requests, f"{len(results)} of {n_requests} requests answered"
    assert all(r.num_output_tokens > 0 for r in results), "a request produced no tokens"
    assert torch.isfinite(engine._pool_k.float()).all() and torch.isfinite(engine._pool_v.float()).all()
    stats = engine.stats()
    out_tokens = sum(r.num_output_tokens for r in results)
    # one decode-kernel launch per layer per lane step
    decode_steps = launches["paged_decode" if paged_attention == "auto" else "decode"] // cfg.n_layers
    record = dict(
        paged_attention=paged_attention,
        config={"dim": cfg.dim, "n_layers": cfg.n_layers, "n_heads": cfg.n_heads,
                "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim, "vocab": cfg.vocab,
                "vision_width": cfg.vision.width, "vision_layers": cfg.vision.layers},
        requests=len(results),
        prompt_tokens={"short": len(prompt_ids), "long": len(long_ids)},
        output_tokens=out_tokens,
        decode_tokens=engine.decode_tokens,
        elapsed_s=elapsed,
        end_to_end_tok_s=out_tokens / elapsed,
        decode_tok_s=engine.tokens_per_second,
        decode_steps=decode_steps,
        decode_ms_per_step=1e3 * stats["decode_s"] / max(1, decode_steps),
        prefill_s=stats["prefill_s"],
        prefill_tokens=stats["prefill_tokens"],
        prefix_cache_misses=engine.prefix_cache_misses,
        decode_slot_utilization=engine.decode_slot_utilization,
        kv_bytes=engine.kv_bytes(),
        setup_s=setup_s,
        launches=launches,
        peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
    )
    return record, engine, make_request, {r.request_id: r.text for r in results}, greedy


def check_drive_prefill(timer, first: tuple) -> dict:
    """Paged prefill on a drive's call, from the snapshot the witness's
    paged drive took of it (q, the call's pool layer as it stood, tables,
    write, kv_len, and the kernel's output there): run again it gives that
    output bit for bit, stays within ``BOUND`` of its fp32 plain version,
    equals ``cct_prefill`` on the gathered rows bit for bit, and is timed
    beside its bound, plain version and SDPA."""
    from cosmos_curate_tpu_torch.ops.paged_attention import paged_attention, paged_attention_plain
    from cosmos_curate_tpu_torch.ops.prefill_attention import prefill_attention

    q, pk, pv, tb, wi, kl, seen = first
    b, t, hk, g, d = q.shape
    bs, width = pk.shape[2], tb.shape[1] * pk.shape[2]

    def run():
        return paged_attention(q, pk, pv, tb, wi, kl)

    def plain():
        return paged_attention_plain(q, pk, pv, tb, wi, kl, layer_index=0, sm_scale=d**-0.5)

    got = run()
    assert torch.equal(got, seen), "paged prefill at the drive's shape: another output than in the drive"
    want = paged_attention_plain(q.float(), pk, pv, tb, wi, kl, layer_index=0, sm_scale=d**-0.5)
    err = (got.float() - want).abs().max().item()
    assert torch.isfinite(got.float()).all() and err <= BOUND, f"paged prefill at the drive's shape: {err}"
    gk = pk[0][tb.long()].reshape(b, width, hk, d)
    gv = pv[0][tb.long()].reshape(b, width, hk, d)
    assert torch.equal(got, prefill_attention(q, gk.contiguous(), gv.contiguous(), wi, kl)), (
        "paged prefill at the drive's shape: not bit-equal to the contiguous prefill kernel"
    )
    write, kv_len = wi.cpu().numpy(), kl.cpu().numpy()
    qs, ks, vs, mask = sdpa_inputs(q, gk, gv, wi, kl)
    bms, by = bound_ms(*attention_work(q.shape, write, kv_len, hk, d))
    return with_shares(dict(
        shape=dict(B=b, T=t, Hkv=hk, G=g, D=d, bs=bs, nbl=tb.shape[1], write=write.tolist(),
                   kv_len=kv_len.tolist()),
        max_abs_err=err,
        kernel_ms=timer(run),
        plain_ms=timer(plain),
        bound_ms=bms,
        bound_by=by,
        library_ms=timer(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True)),
        bit_equal_to_prefill=True,
    ))


def agreement(a: dict, b: dict) -> dict:
    """How far two engines' greedy outputs for the same requests agree:
    identical texts, and the common prefix as a share of the first's text."""
    shares = []
    for rid, text in a.items():
        other = b[rid]
        n = next((i for i, (x, y) in enumerate(zip(text, other)) if x != y), min(len(text), len(other)))
        shares.append(n / max(1, len(text)))
    return {
        "identical": sum(a[rid] == b[rid] for rid in a),
        "requests": len(a),
        "mean_common_prefix_share": sum(shares) / len(shares),
    }


def witness_prefill(dev, cfg, paged: dict, gather: dict, timer) -> dict:
    """Which engine the requests that the paged and gather engines answer
    differently side with. Five more gather drives: with the contiguous
    prefill kernel again (a rerun), with the kernel held against its plain
    version in fp32 on every call the engine makes (the kernel's output goes
    on; each call's max abs error, over the call's largest output, must stay
    within ``BOUND``; the plain version in bf16 is held the same way), with the
    plain version in its place (the reference's rounding: bf16
    probabilities), with the plain version in fp32, and with it at the
    kernel's stated precision (q * scale rounded to bf16, the rest in
    fp32). ``paged`` and ``gather`` are the first drives' greedy records.
    For each differing request: the first differing step, and in every run
    the choice there, the runner-up, the gap between their logits and the
    logit of the paged engine's choice minus the gather engine's; then
    which engine each witness's whole answer matches, and how many answers
    each pair of runs shares. The paged drive (both paged kernels held
    against their fp32 plain versions on every call) also counts its calls
    by (B, T) for prefill and (B, table width) for decode, and snapshots each
    prefill shape's first call; paged prefill at the most frequent shape is
    checked and timed on its snapshot (``check_drive_prefill``) and
    returned under ``paged_prefill_at_drive_shape``."""
    import cosmos_curate_tpu_torch.models.vlm.model as vlm_model
    from cosmos_curate_tpu_torch.ops.paged_attention import paged_attention_plain
    from cosmos_curate_tpu_torch.ops.prefill_attention import chunk_attention_plain

    def plain(q, k, v, wi, kl):
        return chunk_attention_plain(q, k, v, wi, kl, q.shape[-1] ** -0.5)

    def plain_fp32(q, k, v, wi, kl):
        return chunk_attention_plain(q.float(), k.float(), v.float(), wi, kl, q.shape[-1] ** -0.5).to(q.dtype)

    def plain_as_kernel(q, k, v, wi, kl):
        q_scaled = (q * q.shape[-1] ** -0.5).float()  # rounded to q's bf16 first
        return chunk_attention_plain(q_scaled, k.float(), v.float(), wi, kl, 1.0).to(q.dtype)

    saved = vlm_model.prefill_attention
    # per call: the kernel's and the bf16 plain version's max abs error
    # against the fp32 plain version, its largest |output|, (B, T), and
    # whether rows past kv_len were computed
    checked = []

    def kernel_checked(q, k, v, wi, kl):
        out = saved(q, k, v, wi, kl)
        want = chunk_attention_plain(q.float(), k.float(), v.float(), wi, kl, q.shape[-1] ** -0.5)
        errs = [(x.float() - want).abs().max().item() for x in (out, plain(q, k, v, wi, kl))]
        padded = bool((wi + q.shape[1] > kl).any())
        checked.append((*errs, want.abs().max().item(), tuple(q.shape[:2]), padded))
        return out

    # the paged drive's own calls: each kernel output against its fp32 plain
    # version (kept on the device per call: no host sync in the drive)
    saved_paged = vlm_model.paged_attention
    paged_checked = {"paged_prefill": [], "paged_decode": []}
    # calls per (B, T) / (B, table width), all layers; each prefill shape's
    # first call, its pool layer cloned (device copies: no host sync)
    paged_shapes = {"paged_prefill": collections.Counter(), "paged_decode": collections.Counter()}
    first_prefill = {}

    def paged_kernel_checked(q, pk, pv, tb, wi, kl, *, layer_index=0):
        out = saved_paged(q, pk, pv, tb, wi, kl, layer_index=layer_index)
        want = paged_attention_plain(q.float(), pk, pv, tb, wi, kl, layer_index=layer_index,
                                     sm_scale=q.shape[-1] ** -0.5)
        kind = "paged_prefill" if q.shape[1] > 1 else "paged_decode"
        paged_checked[kind].append(torch.stack([(out.float() - want).abs().max(), want.abs().max()]))
        shape = (q.shape[0], q.shape[1] if q.shape[1] > 1 else tb.shape[1] * pk.shape[2])
        paged_shapes[kind][shape] += 1
        if kind == "paged_prefill" and shape not in first_prefill:
            layer = slice(layer_index, layer_index + 1)
            first_prefill[shape] = tuple(x.clone() for x in (q, pk[layer], pv[layer], tb, wi, kl, out))
        return out

    runs = {"paged": paged, "gather": gather}
    try:
        vlm_model.paged_attention = paged_kernel_checked
        _, engine, _, _, runs["paged_kernel_checked"] = drive_slice(dev, cfg)
        engine.shutdown()
        del engine
    finally:
        vlm_model.paged_attention = saved_paged
    for label, attn in (("gather_rerun", saved), ("gather_kernel_checked", kernel_checked),
                        ("gather_plain_prefill", plain),
                        ("gather_plain_prefill_fp32", plain_fp32),
                        ("gather_plain_prefill_as_kernel", plain_as_kernel)):
        try:
            vlm_model.prefill_attention = attn
            _, engine, _, _, runs[label] = drive_slice(dev, cfg, paged_attention="gather")
            engine.shutdown()
            del engine
        finally:
            vlm_model.prefill_attention = saved
    tokens = {label: {rid: [s[i][0] for i in sorted(s)] for rid, s in run.items()} for label, run in runs.items()}

    def gap(choice: int, row: np.ndarray) -> tuple[int, float]:
        """The runner-up to ``choice`` and how far its logit is below."""
        others = row.copy()
        others[choice] = -np.inf
        return int(np.argmax(others)), float(row[choice] - others.max())

    witnesses = [label for label in runs if label not in ("paged", "gather")]
    gather_gaps = [gap(c, row)[1] for s in gather.values() for c, row in s.values()]
    differing = []
    for rid in sorted(tokens["paged"]):
        a, b = tokens["paged"][rid], tokens["gather"][rid]
        if a == b:
            continue
        k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        at_step = {}
        for label, run in runs.items():
            if k in run[rid] and k < min(len(a), len(b)):
                choice, row = run[rid][k]
                runner_up, g = gap(choice, row)
                at_step[label] = {"choice": choice, "runner_up": runner_up, "gap": g,
                                  "paged_minus_gather_choice": float(row[a[k]] - row[b[k]])}
        differing.append({
            "request": rid,
            "first_differing_step": k,
            "at_step": at_step,
            "gather_steps_with_a_smaller_gap": sum(g < at_step["gather"]["gap"] for g in gather_gaps)
            if "gather" in at_step else None,
            "gather_steps": len(gather_gaps),
            "sides_with": {label: "paged" if tokens[label][rid] == a else "gather" if tokens[label][rid] == b
                           else "neither" for label in witnesses},
        })
    labels = list(runs)
    identical = {
        f"{x} | {y}": sum(tokens[x][rid] == tokens[y][rid] for rid in tokens[x])
        for i, x in enumerate(labels) for y in labels[i + 1:]
    }
    rel = max(e / m for e, _, m, _, _ in checked)
    assert rel <= BOUND, f"prefill kernel vs plain on the engine's inputs: {rel} of the largest output > {BOUND}"
    kernel_on_engine_inputs = {
        "calls": len(checked),
        "max_abs_err": max(c[0] for c in checked),
        "max_rel_err": rel,
        "bound_rel": BOUND,
        "plain_bf16_max_abs_err": max(c[1] for c in checked),
        "plain_bf16_max_rel_err": max(c[1] / c[2] for c in checked),
        "max_abs_output": max(c[2] for c in checked),
        "batch_and_length": sorted({c[3] for c in checked}),
        "calls_with_rows_past_kv_len": sum(c[4] for c in checked),
        "max_abs_err_with_rows_past_kv_len": max((c[0] for c in checked if c[4]), default=None),
    }
    for kind, rows in paged_checked.items():
        errs = torch.stack(rows).cpu().numpy()  # [calls, (max abs err, max |output|)]
        rel_kind = float((errs[:, 0] / errs[:, 1]).max())
        assert rel_kind <= BOUND, f"{kind} kernel vs plain on the engine's inputs: {rel_kind} > {BOUND}"
        kernel_on_engine_inputs[kind] = {
            "calls": len(rows),
            "max_abs_err": float(errs[:, 0].max()),
            "max_rel_err": rel_kind,
            "bound_rel": BOUND,
            "max_abs_output": float(errs[:, 1].max()),
            "calls_by_batch_and_length": {f"B={b} {'T' if kind == 'paged_prefill' else 'width'}={n}": c
                                          for (b, n), c in paged_shapes[kind].most_common()},
        }
    (b, t), n = paged_shapes["paged_prefill"].most_common(1)[0]
    drive_prefill = {**check_drive_prefill(timer, first_prefill.pop((b, t))), "drive_calls": n}
    return {"differing": differing, "identical_tokens": identical, "requests": len(tokens["paged"]),
            "kernel_on_engine_inputs": kernel_on_engine_inputs, "paged_prefill_at_drive_shape": drive_prefill}


def profile_window(run, steps: int, unit: str, focus: str | None = None) -> dict:
    """``run`` ``steps`` times untraced (wall time), then ``steps`` times
    under torch.profiler tracing the device only:
    device busy time, launches and top kernels per ``unit``, and the
    device's idle share of the traced window; with ``focus``, the time,
    launches and busy share of the kernels whose name holds it."""
    from torch.profiler import ProfilerActivity, profile

    def window() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    plain_wall_ms = window()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced_wall_ms = window()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    assert busy_us > 0, "the profiler traced no device time"
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    focused = {}
    if focus is not None:
        hits = [e for e in kernels if focus in e.key]
        assert hits, f"no kernel named {focus} ran in the profiled window"
        focus_us = sum(e.self_device_time_total for e in hits)
        focused = {"focus": {"name": focus, "ms_per_step": focus_us / 1e3 / steps,
                             "calls_per_step": sum(e.count for e in hits) / steps, "busy_share": focus_us / busy_us}}
    return {
        "unit": unit,
        "steps": steps,
        "wall_ms_per_step": plain_wall_ms / steps,
        "traced_wall_ms_per_step": traced_wall_ms / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": 1.0 - busy_us / 1e3 / traced_wall_ms,
        "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
        "top_kernels": [
            {"name": e.key[:80], "ms_per_step": e.self_device_time_total / 1e3 / steps,
             "calls_per_step": e.count / steps}
            for e in top
        ],
        **focused,
    }


def profile_decode(engine, make_request, focus: str, steps: int = 16) -> dict:
    """Where a decode step's time goes, with both lanes decoding: first
    ``steps`` engine steps with no profiler (wall time per step), then
    ``steps`` more under torch.profiler tracing the device only, with the
    decode kernel (its name holds ``focus``) apart. The idle share is one
    window's: 1 - device busy / wall of the traced window."""
    for i in range(8):
        engine.add_request(make_request(f"profile-{i}", i))
    deadline = time.monotonic() + 120
    while not all(lane.slots for lane in engine.lanes):
        assert time.monotonic() < deadline, "profile workload never reached both lanes"
        engine.step()
    for _ in range(4):  # let the rest of the burst join the batch
        engine.step()
    # the async prep thread idle before the window: a CUDA call of that
    # thread racing the profiler's stop crashed the process (PERF.md §7),
    # so the window holds decode steps without prep's overlap
    assert engine.wait_prep_idle(max(deadline - time.monotonic(), 0.0)), "the prep thread never went idle"
    out = profile_window(engine.step, steps, "engine step", focus)
    assert all(lane.slots for lane in engine.lanes), "a lane drained inside the profiled window"
    engine.run_until_complete()
    return out


def optional_modules() -> dict:
    """Module -> its version (or True) where it imports here, else the
    import error; FFmpeg library -> the shared library the loader finds
    (or None), and whether libavcodec's headers are installed."""
    import ctypes.util
    import importlib
    from pathlib import Path

    out = {}
    for name in OPTIONAL_MODULES:
        try:
            mod = importlib.import_module(name)
            out[name] = str(getattr(mod, "__version__", True))
        except Exception as e:  # reported, not fatal: later slices read it
            out[name] = f"{type(e).__name__}: {e}"
    out["libraries"] = {name: ctypes.util.find_library(name) for name in FFMPEG_LIBRARIES}
    out["libavcodec_headers"] = Path("/usr/include/libavcodec/avcodec.h").exists() or any(
        Path("/usr/include").glob("*/libavcodec/avcodec.h"))
    return out


def drive_pipeline(dev) -> dict:
    """The annotate half of the main path through ``run_pipeline``:
    embed -> caption prep -> caption, at VIDEO_EMBED_BASE and VLM_BASE
    (``model_flavor="base"``, seeded), with ``split.py``'s stage settings
    (window_len 256, 8 frames a window, 128 new tokens, stage batch 32).
    Tasks of EMBED_CLIPS_PER_TASK clips x 8 random 224x224 frames at 8 fps,
    each clip 1 s of a 30 fps video: one caption window. First the default
    runner over PIPELINE_TASKS tasks, then SequentialRunner over
    PIPELINE_SEQUENTIAL_TASKS of them on the same frames (the same seeded
    weights: the embedder re-seeds, the caption engine is shared), then the
    caption efficiency over EFFICIENCY_TASKS tasks on that engine."""
    from cosmos_curate_tpu_torch.core.pipeline import run_pipeline
    from cosmos_curate_tpu_torch.core.pipelined_runner import PipelinedRunner
    from cosmos_curate_tpu_torch.core.runner import RUNNER_ENV, SequentialRunner, default_runner
    from cosmos_curate_tpu_torch.data.model import (
        Clip,
        FrameExtractionSignature,
        SplitPipeTask,
        Video,
        VideoMetadata,
    )
    from cosmos_curate_tpu_torch.models.embedder import VIDEO_EMBED_BASE
    from cosmos_curate_tpu_torch.models.vlm import CaptionRequest, SamplingConfig, SharedCaptionEngine
    from cosmos_curate_tpu_torch.ops import kernels
    from cosmos_curate_tpu_torch.pipelines.video.stages.captioning import CaptionPrepStage, CaptionStage
    from cosmos_curate_tpu_torch.pipelines.video.stages.embedding import ClipEmbeddingStage

    cfg = VIDEO_EMBED_BASE
    sig = FrameExtractionSignature("fps", 8.0)
    size = cfg.vit.image_size
    rng = np.random.default_rng(SEED + 3)
    frames = [
        [rng.integers(0, 256, (cfg.num_frames, size, size, 3), dtype=np.uint8) for _ in range(EMBED_CLIPS_PER_TASK)]
        for _ in range(PIPELINE_TASKS)
    ]

    def make_tasks(n: int) -> list:
        return [
            SplitPipeTask(video=Video(
                path=f"video-{t}.mp4",
                metadata=VideoMetadata(width=size, height=size, fps=30.0, num_frames=30 * EMBED_CLIPS_PER_TASK,
                                       duration_s=float(EMBED_CLIPS_PER_TASK)),
                clips=[Clip(source_video=f"video-{t}", span=(float(i), float(i + 1)),
                            extracted_frames={sig.key(): f}) for i, f in enumerate(frames[t])],
            ))
            for t in range(n)
        ]

    # the pipelined run: which host thread and CUDA stream each stage's
    # batches ran on, and when
    batches: list[tuple[str, str, int, float, float]] = []
    batches_lock = threading.Lock()

    def stages() -> list:
        out = [ClipEmbeddingStage(variant="video", extraction=sig), CaptionPrepStage(extraction=sig),
               CaptionStage(model_flavor="base")]
        for stage in out:
            def traced(tasks, _run=stage.process_data, _name=stage.name):
                t0 = time.monotonic()
                try:
                    return _run(tasks)
                finally:
                    with batches_lock:
                        batches.append((_name, threading.current_thread().name,
                                        torch.cuda.current_stream().cuda_stream, t0, time.monotonic()))

            stage.process_data = traced
        return out

    def drive(runner, n: int) -> tuple[list, float, int, dict, object]:
        ks = kernels()
        for k in ks.values():
            k.launches = 0
        batches.clear()
        used = stages()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = run_pipeline(make_tasks(n), used, runner=runner)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        caption = used[2]
        tokens = caption.model.engine.owner_decode_tokens.get(caption.owner, 0)
        return out, wall, tokens, {name: k.launches for name, k in ks.items()}, caption

    def check(out: list, n: int, label: str) -> dict:
        assert len(out) == n, f"{label}: {len(out)} of {n} tasks came out"
        clips = [c for t in out for c in t.video.clips]
        windows = [w for c in clips for w in c.windows]
        assert len(clips) == n * EMBED_CLIPS_PER_TASK, f"{label}: {len(clips)} clips"
        for c in clips:
            emb = c.embeddings.get("video-embed-tpu")
            assert emb is not None and emb.shape == (cfg.output_dim,) and np.isfinite(emb).all(), f"{label}: embedding"
            assert len(c.windows) == 1, f"{label}: {len(c.windows)} windows in a 1 s clip"
        assert all(w.caption.get("default") for w in windows), f"{label}: a window has no caption"
        return {"clips_embedded": len(clips), "windows_captioned": len(windows)}

    def outputs(out: list) -> dict:
        return {(t.video.path, c.span, (w.start_frame, w.end_frame)): (c.embeddings["video-embed-tpu"],
                                                                         w.caption["default"])
                for t in out for c in t.video.clips for w in c.windows}

    def concurrent_s(a: str, b: str) -> float:
        """Seconds during which a batch of stage ``a`` and one of ``b`` ran
        at once (the two stages' batches do not overlap themselves)."""
        spans_a = [(t0, t1) for name, _, _, t0, t1 in batches if name == a]
        spans_b = [(t0, t1) for name, _, _, t0, t1 in batches if name == b]
        return sum(max(0.0, min(a1, b1) - max(a0, b0)) for a0, a1 in spans_a for b0, b1 in spans_b)

    os.environ.pop(RUNNER_ENV, None)
    runner = default_runner()
    assert isinstance(runner, PipelinedRunner), f"default runner is {type(runner).__name__}"
    gc.collect()
    torch.cuda.reset_peak_memory_stats(dev)
    piped, wall, tokens, launches, caption = drive(runner, PIPELINE_TASKS)
    peak = torch.cuda.max_memory_allocated(dev)
    counts = check(piped, PIPELINE_TASKS, "pipelined")
    streams = collections.defaultdict(set)
    for name, thread, stream, _, _ in batches:
        streams[name].add((thread, stream))
    embed_caption_s = concurrent_s("ClipEmbeddingStage", "CaptionStage")
    assert embed_caption_s > 0, "the embed and caption stages never ran at once"
    assert runner.overlap_frac > 0, f"overlap fraction {runner.overlap_frac}"
    seq, seq_wall, seq_tokens, seq_launches, seq_caption = drive(SequentialRunner(), PIPELINE_SEQUENTIAL_TASKS)
    seq_counts = check(seq, PIPELINE_SEQUENTIAL_TASKS, "sequential")
    engine = caption.model.engine
    assert seq_caption.model.engine is engine, "the two runs' caption stages did not share one engine"
    # caption pipeline efficiency (benchmarks/caption_benchmark.py:263-390):
    # the same windows straight into the engine the runs above built and
    # warmed, then through a CaptionStage sharing it; decode tokens over
    # wall on both sides
    prepped = run_pipeline(make_tasks(EFFICIENCY_TASKS), [CaptionPrepStage(extraction=sig)],
                           runner=SequentialRunner())
    eff_stage = CaptionStage(model_flavor="base")
    windows = [(f"{c.uuid}-{i}", w) for t in prepped for c in t.video.clips for i, w in enumerate(c.windows)]
    prefix_ids, prompt_ids = eff_stage.model.encode_prompt(eff_stage.prompt_text)

    def submit(tag: str, wins: list) -> None:
        for rid, win in wins:
            engine.add_request(CaptionRequest(
                request_id=f"{tag}{rid}", prefix_ids=list(prefix_ids), prompt_ids=list(prompt_ids),
                frames=win.frames, frame_fps=win.frame_fps,
                sampling=SamplingConfig(max_new_tokens=eff_stage.max_new_tokens)))

    def timed(run) -> tuple[float, int]:
        before = engine.decode_tokens
        torch.cuda.synchronize()
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        return time.monotonic() - t0, engine.decode_tokens - before

    def standalone() -> None:
        submit("standalone-", windows)
        engine.run_until_complete()

    standalone_s, standalone_tokens = timed(standalone)
    stage_s, stage_tokens = timed(lambda: run_pipeline(prepped, [eff_stage], runner=SequentialRunner()))
    assert all(w.caption.get("default") for _, w in windows), "efficiency: a window has no caption"
    standalone_tok_s = standalone_tokens / standalone_s
    stage_tok_s = stage_tokens / stage_s
    SharedCaptionEngine.reset()

    a = outputs(piped)
    b = outputs(seq)
    assert set(b) <= set(a), "the sequential runner made clips or windows the pipelined runner did not"
    assert {k for k in a if k[0] in {t.video.path for t in seq}} == set(b), "the runners' output sets differ"
    emb_errs = [float(np.abs(a[k][0] - b[k][0]).max()) for k in b]
    same_captions = sum(a[k][1] == b[k][1] for k in b)
    emb_agree = sum(e <= EMBED_BOUND for e in emb_errs)
    assert emb_agree == len(b), f"embeddings of the two runners differ by {max(emb_errs)} > {EMBED_BOUND}"
    return dict(
        runner=type(runner).__name__,
        tasks=PIPELINE_TASKS,
        **counts,
        wall_s=wall,
        clips_per_s=counts["clips_embedded"] / wall,
        decode_tokens=tokens,
        in_pipeline_tok_s=tokens / wall,
        overlap_frac=runner.overlap_frac,
        embed_caption_concurrent_s=embed_caption_s,
        caption_efficiency={"windows": len(windows), "standalone_s": standalone_s,
                            "standalone_decode_tokens": standalone_tokens, "standalone_tok_s": standalone_tok_s,
                            "stage_s": stage_s, "stage_decode_tokens": stage_tokens, "stage_tok_s": stage_tok_s,
                            "caption_pipeline_efficiency": stage_tok_s / standalone_tok_s},
        launches=launches,
        stage_busy_s=dict(runner.stage_times),
        stage_counts=runner.stage_counts,
        streams={k: sorted(v) for k, v in streams.items()},
        peak_memory_bytes=peak,
        sequential={"tasks": PIPELINE_SEQUENTIAL_TASKS, **seq_counts, "wall_s": seq_wall,
                    "decode_tokens": seq_tokens, "launches": seq_launches},
        same_output_sets=True,
        embeddings_within_bound=emb_agree,
        max_abs_embedding_diff=max(emb_errs),
        embed_bound=EMBED_BOUND,
        identical_captions=same_captions,
        windows_compared=len(b),
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the GPU", file=sys.stderr)
        return 1
    # the port first: without the repository around it the script fails here,
    # before printing anything
    from cosmos_curate_tpu_torch.models.vlm import VLM_BASE
    from cosmos_curate_tpu_torch.ops import _build, kernels

    dev = torch.device("cuda", 0)
    card = card_line()
    emit({"phase": "device", "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "modules": optional_modules()})

    t0 = time.monotonic()
    _build.build_all()
    emit({"phase": "build", "seconds": time.monotonic() - t0, "sass": sass_counts()})

    timer = Timer(dev)
    emit({"phase": "card_state", "at": "before kernels", **gpu_state()})
    checks = check_kernels(timer, dev)
    emit({"phase": "card_state", "at": "after kernels", **gpu_state()})
    emit({"phase": "kernels", "bound": BOUND, "results": checks,
          "library": "scaled_dot_product_attention: on K/V already gathered to contiguous "
                     "[B, Hkv, S, D] with a boolean mask for the cache kernels (the gather is "
                     "not timed), on the same [B, H, S, D] q/k/v for flash"})

    embed = drive_embed(dev)
    emit({"phase": "embed", **embed})
    for label, err in embed["max_abs_err_vs_plain_flash_with_a_tile_dropped"].items():
        assert err > EMBED_BOUND, f"embed: the bound {EMBED_BOUND} does not catch {label} ({err})"

    record, engine, make_request, paged_texts, paged_greedy = drive_slice(dev, VLM_BASE)
    emit({"phase": "slice", **record})

    emit({"phase": "breakdown", **profile_decode(engine, make_request, "PagedKV")})
    engine.shutdown()

    forward = check_forward(engine.model, dev)
    emit({"phase": "forward", "max_abs_logit_diff": forward, "bound": FORWARD_BOUND})
    del engine

    gather, gather_engine, gather_request, gather_texts, gather_greedy = drive_slice(
        dev, VLM_BASE, paged_attention="gather")
    # the same seeded weights and requests; the two engines' prefill
    # kernels share one tensor-core body and their decode kernels one split
    # body, each pair bit-equal on the same K/V (the kernels phase asserts
    # both), but async prep packs each drive's chunks by host timing, so
    # agreement is reported, not asserted; the witness phase explains each
    # request that differs
    emit({"phase": "gather", **gather,
          "paged": {k: record[k] for k in ("end_to_end_tok_s", "decode_tok_s", "decode_ms_per_step")},
          "agreement_with_paged": agreement(paged_texts, gather_texts)})
    emit({"phase": "gather_breakdown", **profile_decode(gather_engine, gather_request, "ContiguousKV")})
    gather_engine.shutdown()
    del gather_engine
    for name in ("paged_decode", "paged_prefill"):
        assert gather["launches"][name] == 0, f"the gather engine launched {name}"
    witness = witness_prefill(dev, VLM_BASE, paged_greedy, gather_greedy, timer)
    drive_prefill = witness.pop("paged_prefill_at_drive_shape")
    emit({"phase": "witness", **witness})
    emit({"phase": "paged_prefill_at_drive_shape", **drive_prefill})
    checks["paged_prefill"]["cases"] = {"chunk_256": dict(checks["paged_prefill"]), "drive_mode": drive_prefill}

    pipeline = drive_pipeline(dev)
    emit({"phase": "pipeline", **pipeline})
    for name in PIPELINE_KERNELS:
        assert pipeline["launches"][name] > 0, f"kernel {name} was not launched on the pipeline path"

    launches = {"embed": embed["launches"], "slice": record["launches"], "gather": gather["launches"]}
    for path, counts in launches.items():
        for name, n in counts.items():
            if KERNEL_PATH[name] == path or (path == "gather" and name == "prefill"):
                assert n > 0, f"kernel {name} was not launched on the {path} path"

    rows = []
    for name in kernels():
        c = checks[name]
        rows.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=launches[KERNEL_PATH[name]][name], max_abs_err=c["max_abs_err"], ms=c["kernel_ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"], bound_by=c["bound_by"],
            library_ms=c["library_ms"], bound_share=c["bound_share"], vs_library=c["vs_library"],
            pipeline_launches=pipeline["launches"][name],
        ))
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
