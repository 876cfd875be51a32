"""On-card smoke test of the PyTorch/CUDA port (``cosmos_curate_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``cosmos_curate_tpu_torch/csrc``
and prints one JSON line per phase:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build: seconds to compile every kernel (one ``nvcc`` per source, in
   parallel);
3. kernels: each kernel against its plain PyTorch version at the shapes the
   caption engine gives it at ``VLM_BASE`` width (bf16 inputs, the plain
   version in fp32 on the same inputs, bound 1e-2 max abs error), timed with
   CUDA events (median of 30 launches after warm-up, L2 flushed between
   launches), beside the card's least time for the same work and one
   ``scaled_dot_product_attention`` call on the equivalent gathered /
   contiguous tensors (a yardstick only; it excludes the gather, and the port
   never calls it);
4. slice: ``CaptionEngine(VLM_BASE)`` with seeded random weights answers the
   caption benchmark's base workload (8 requests, 4 random 224x224 frames,
   the default prompt or the 686-token long prompt as shared prefix, 64 new
   tokens); every kernel's launch counter must rise during that run;
5. breakdown: with both lanes decoding, 16 engine steps without a profiler
   (wall time per step), then 16 under torch.profiler tracing the device
   only (device time by kernel, launches per step, and the device's idle
   share of that traced window);
6. forward: the engine's model on a small input with every kernel against
   the same forward with each kernel replaced by its plain version.

Then the ``{"kernels": [...]}`` line, the card line, and the last line
``{"ok": true, "device": {...}}``. Any failed check raises: the script exits
non-zero and prints no result. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
BOUND = 1e-2  # kernel vs plain version, max abs error (bf16 output)
FORWARD_BOUND = 5e-2  # 12-layer logits, kernels vs plain versions, bf16
SEED = 0

# TPU kernels these replace: the pl.pallas_call of each
REPLACES = {
    "paged_decode": "cosmos_curate_tpu/ops/paged_attention.py:210",
    "paged_prefill": "cosmos_curate_tpu/ops/paged_attention.py:264",
    "prefill": "cosmos_curate_tpu/ops/prefill_attention.py:146",
}
SOURCES = {
    "paged_decode": "cosmos_curate_tpu_torch/csrc/paged_attention.cu",
    "paged_prefill": "cosmos_curate_tpu_torch/csrc/paged_attention.cu",
    "prefill": "cosmos_curate_tpu_torch/csrc/prefill_attention.cu",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of one call, L2 flushed before each launch."""

    def __init__(self, device) -> None:
        self._flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=device)

    def __call__(self, fn, iters: int = 30, warmup: int = 5) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self._flush.zero_()
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
    from cosmos_curate_tpu_torch.ops.paged_attention import paged_attention, paged_attention_plain
    from cosmos_curate_tpu_torch.ops.prefill_attention import chunk_attention_plain, prefill_attention

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(SEED)
    hk, g, d, bs, nbl = 8, 2, 64, 16, 64

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=dev)

    results = {}

    def paged_case(name, b, t, write, kv_len, idle_row=False):
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
        gk = pk[1][tb.long()].reshape(b, nbl * bs, hk, d)
        gv = pv[1][tb.long()].reshape(b, nbl * bs, hk, d)
        qs, ks, vs, mask = sdpa_inputs(q, gk, gv, wi, kl)
        n_bytes, flops = attention_work(q.shape, np.asarray(write), np.asarray(kv_len), hk, d)
        bms, by = bound_ms(n_bytes, flops)
        results[name] = dict(
            shape=dict(B=b, T=t, Hkv=hk, G=g, D=d, bs=bs, nbl=nbl),
            max_abs_err=err,
            kernel_ms=timer(run),
            plain_ms=timer(plain),
            bound_ms=bms,
            bound_by=by,
            library_ms=timer(lambda: sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True)),
        )
        assert err <= BOUND, f"{name}: max abs err {err} > {BOUND}"

    # decode: one lane of 4 slots, random lengths, the last row idle
    kv = rng.integers(64, nbl * bs, 4)
    kv[-1] = 1
    paged_case("paged_decode", 4, 1, kv - 1, kv, idle_row=True)
    # paged prefill: a 256-token chunk, one fresh row and one mid-context row
    paged_case("paged_prefill", 2, 256, np.array([0, 300]), np.array([256, 556]))

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
    assert set(results) == set(kernels())
    return results


def check_forward(model, dev) -> dict:
    """The engine's model with its kernels vs the same forward with each
    kernel swapped for its plain version (paged prefill + decode on a
    fragmented pool, and a contiguous prefix build)."""
    import cosmos_curate_tpu_torch.models.vlm.model as vlm_model
    from cosmos_curate_tpu_torch.models.vlm.model import init_cache
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
        return pre.float(), dec.float(), con.float()

    got = run()
    saved = vlm_model.paged_attention, vlm_model.prefill_attention
    try:
        vlm_model.paged_attention = lambda q, pk, pv, tb, wi, kl, *, layer_index=0: paged_attention_plain(
            q, pk, pv, tb, wi, kl, layer_index=layer_index, sm_scale=q.shape[-1] ** -0.5
        )
        vlm_model.prefill_attention = lambda q, k, v, wi, kl: chunk_attention_plain(
            q, k, v, wi, kl, q.shape[-1] ** -0.5
        )
        want = run()
    finally:
        vlm_model.paged_attention, vlm_model.prefill_attention = saved
    out = {}
    for name, a, w in zip(("paged_prefill", "paged_decode", "contiguous_prefill"), got, want):
        assert a.shape[-1] == cfg.vocab and torch.isfinite(a).all(), name
        out[name] = (a - w).abs().max().item()
        assert out[name] <= FORWARD_BOUND, f"forward {name}: {out[name]} > {FORWARD_BOUND}"
    return out


def drive_slice(dev, cfg, kv_lanes=((256, 4), (1024, 4))) -> tuple[dict, object, object]:
    """The caption benchmark's base workload through CaptionEngine (its
    lanes: half the slots at 256 positions, half at max_seq)."""
    from cosmos_curate_tpu_torch.models.prompts import get_caption_prompt
    from cosmos_curate_tpu_torch.models.vlm import CaptionEngine, CaptionRequest, SamplingConfig
    from cosmos_curate_tpu_torch.ops import kernels

    t0 = time.monotonic()
    engine = CaptionEngine(cfg, max_batch=8, kv_lanes=kv_lanes, async_prep=True, device=dev)
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
    n_requests = 8
    t0 = time.monotonic()
    for i in range(n_requests):
        engine.add_request(make_request(f"r{i}", i))
    results = engine.run_until_complete()
    torch.cuda.synchronize()
    elapsed = time.monotonic() - t0
    launches = {name: k.launches for name, k in ks.items()}

    assert len(results) == n_requests, f"{len(results)} of {n_requests} requests answered"
    assert all(r.num_output_tokens > 0 for r in results), "a request produced no tokens"
    assert torch.isfinite(engine._pool_k.float()).all() and torch.isfinite(engine._pool_v.float()).all()
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was not launched on the main path"
    stats = engine.stats()
    out_tokens = sum(r.num_output_tokens for r in results)
    record = dict(
        config={"dim": cfg.dim, "n_layers": cfg.n_layers, "n_heads": cfg.n_heads,
                "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim, "vocab": cfg.vocab,
                "vision_width": cfg.vision.width, "vision_layers": cfg.vision.layers},
        requests=len(results),
        prompt_tokens={"short": len(prompt_ids), "long": len(long_ids)},
        output_tokens=out_tokens,
        elapsed_s=elapsed,
        end_to_end_tok_s=out_tokens / elapsed,
        decode_tok_s=engine.tokens_per_second,
        decode_steps=stats["paged_kernel_steps"],
        decode_ms_per_step=1e3 * stats["decode_s"] / max(1, stats["paged_kernel_steps"]),
        prefill_s=stats["prefill_s"],
        prefill_tokens=stats["prefill_tokens"],
        prefix_cache_misses=engine.prefix_cache_misses,
        decode_slot_utilization=engine.decode_slot_utilization,
        kv_bytes=engine.kv_bytes(),
        setup_s=setup_s,
        launches=launches,
        peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
    )
    return record, engine, make_request


def profile_decode(engine, make_request, steps: int = 16) -> dict:
    """Where a decode step's time goes, with both lanes decoding: first
    ``steps`` engine steps with no profiler (wall time per step), then
    ``steps`` more under torch.profiler tracing the device only. The idle
    share is one window's: 1 - device busy / wall of the traced window."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(8):
        engine.add_request(make_request(f"profile-{i}", i))
    deadline = time.monotonic() + 120
    while not all(lane.slots for lane in engine.lanes):
        assert time.monotonic() < deadline, "profile workload never reached both lanes"
        engine.step()
    for _ in range(4):  # let the rest of the burst join the batch
        engine.step()

    def window() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    plain_wall_ms = window()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced_wall_ms = window()
    assert all(lane.slots for lane in engine.lanes), "a lane drained inside the profiled window"
    engine.run_until_complete()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    assert busy_us > 0, "the profiler traced no device time"
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return dict(
        steps=steps,
        wall_ms_per_step=plain_wall_ms / steps,
        traced_wall_ms_per_step=traced_wall_ms / steps,
        device_busy_ms_per_step=busy_us / 1e3 / steps,
        device_idle_share=1.0 - busy_us / 1e3 / traced_wall_ms,
        kernel_launches_per_step=sum(e.count for e in kernels) / steps,
        top_kernels=[
            {"name": e.key[:80], "ms_per_step": e.self_device_time_total / 1e3 / steps,
             "calls_per_step": e.count / steps}
            for e in top
        ],
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
          "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})

    t0 = time.monotonic()
    _build.build_all()
    emit({"phase": "build", "seconds": time.monotonic() - t0})

    timer = Timer(dev)
    checks = check_kernels(timer, dev)
    emit({"phase": "kernels", "bound": BOUND, "results": checks,
          "library": "scaled_dot_product_attention on K/V already gathered to contiguous "
                     "[B, Hkv, S, D] with a boolean mask; the gather is not timed"})

    record, engine, make_request = drive_slice(dev, VLM_BASE)
    emit({"phase": "slice", **record})

    emit({"phase": "breakdown", **profile_decode(engine, make_request)})
    engine.shutdown()

    forward = check_forward(engine.model, dev)
    emit({"phase": "forward", "max_abs_logit_diff": forward, "bound": FORWARD_BOUND})

    rows = []
    for name in kernels():
        c = checks[name]
        rows.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=record["launches"][name], max_abs_err=c["max_abs_err"], ms=c["kernel_ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"], bound_by=c["bound_by"],
            library_ms=c["library_ms"],
        ))
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
