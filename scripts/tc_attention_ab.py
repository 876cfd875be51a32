"""The port's redesigned attention kernels against an earlier tree's, on the card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/tc_attention_ab.py --baseline DIR

``DIR`` is an earlier tree's ``cosmos_curate_tpu_torch/csrc`` whose
``cct_flash`` and ``cct_prefill`` have the C signatures of this tree's; its
``cct_paged_decode`` / ``cct_paged_prefill`` / ``cct_decode`` may have those
of the first versions (no split workspace, no pool block count), which the
script calls through a wrapper of the first versions' form (a source that
names no ``part_ml`` workspace is taken for a first version). It builds
``flash_attention.cu``, ``prefill_attention.cu``, ``paged_attention.cu`` and
``decode_attention.cu`` of both trees into ``build/tc_ab/`` (one ``nvcc``
each, all at once), points the wrappers at each build in turn, in the order
this tree, baseline, baseline, this tree, so drift shows, and reads at the
main path's shapes:
flash at ViT-B/16's ``[128, 12, 197, 64]`` (one 16-clip dispatch) and
``[256, 12, 197, 64]`` (32 clips), the pooler's ``[16, 8, 9, 64]`` and causal
``[1, 16, 2305, 64]``; prefill at the 1024-token prefix build (kv_len 686,
Hkv 8, G 2, D 64); paged prefill at a 256-token chunk (B 2, write 0 / 300)
and at the paged caption drive's most frequent call (one 64-token chunk
after the 686-token prefix) over a 1024-key table in pool blocks of 16, 64,
128, 8 and 4 rows, with contiguous prefill on that call's rows gathered
(the reference paged prefill is held to); paged decode over the caption
engine's two lanes (4 slots, tables of 1024 and 256 keys in blocks of 16,
the last row idle); contiguous decode at the gather engine's two lanes
(4 slots, S 1024 and 256, the last row at kv_len 1), and on paged decode's
rows gathered into a contiguous cache (``decode_on_paged_rows_*``: the
cost of the table lookup is paged decode's time less this one's); and the
timer's floor, a one-element fill.

Then the split-decode geometry: ``cct_paged_decode`` of this tree rebuilt
with each of ``SPLIT_BUILDS``' keys a thread loads per pass
(``kKeysPerThread``) and partials the merge loads at once (``kMergeBatch``)
written into a copy of ``split_decode.cuh``, timed at both lanes at every
split count of ``SPLIT_COUNTS`` (the wrapper's ``decode_split_count``
replaced by the count under test), the header's own build first and last.

Per shape:

- ``ms``: ``chip_smoke.Timer``'s device time, the median of 30 CUDA-event
  timings with L2 flushed and the host kept ahead of the device;
- ``host_ms``: the host's time in one wrapper call (input checks, the
  kernel's host code, the launch), median of 30 calls each made on a
  drained queue;
- ``wall_ms``: one call and a synchronize on the host's clock, with no
  flush and no spin, median of 30.

One JSON line per build (ptxas registers and spills) and per reading
(``chosen``: the split count the wrapper picks there), then the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import Timer  # noqa: E402
from cosmos_curate_tpu_torch.ops import _build  # noqa: E402
from cosmos_curate_tpu_torch.ops import paged_attention as paged_module  # noqa: E402
from cosmos_curate_tpu_torch.ops.decode_attention import DECODE_KERNEL, decode_attention  # noqa: E402
from cosmos_curate_tpu_torch.ops.flash_attention import FLASH_KERNEL, flash_attention  # noqa: E402
from cosmos_curate_tpu_torch.ops.paged_attention import (  # noqa: E402
    MAX_DECODE_GROUP,
    PAGED_DECODE_KERNEL,
    PAGED_PREFILL_KERNEL,
    decode_split_count,
    paged_attention,
)
from cosmos_curate_tpu_torch.ops.prefill_attention import (  # noqa: E402
    MAX_PREFILL_ROWS,
    PREFILL_KERNEL,
    check_kernel_inputs,
    prefill_attention,
)

OUT = ROOT / "build" / "tc_ab"
# library -> the kernels it holds
KERNELS = {
    "flash_attention": (FLASH_KERNEL,),
    "prefill_attention": (PREFILL_KERNEL,),
    "paged_attention": (PAGED_DECODE_KERNEL, PAGED_PREFILL_KERNEL),
    "decode_attention": (DECODE_KERNEL,),
}
_P, _I = ctypes.c_void_p, ctypes.c_int
# the first versions' paged C signatures
FIRST_PAGED = {
    "cct_paged_decode": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    "cct_paged_prefill": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
}
# the first version's contiguous decode C signature (one CTA per row, kv head)
FIRST_DECODE = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P]
FLASH_CASES = {
    "vit_b16_224": ((128, 12, 197, 64), False),
    "vit_b16_224_32_clips": ((256, 12, 197, 64), False),
    "pooler": ((16, 8, 9, 64), False),
    "causal_2305": ((1, 16, 2305, 64), True),
}
# the paged caption drive's most frequent prefill: (B, T, write, kv_len)
DRIVE_PREFILL = (1, 64, 686, 750)
DRIVE_WIDTH = 1024  # keys in its table: the caption engine's long lane
BLOCK_SIZES = (16, 64, 128, 8, 4)
# split_decode.cuh's (kKeysPerThread, kMergeBatch) per build; the header's first
SPLIT_BUILDS = ((4, 4), (2, 4), (8, 4), (4, 8), (4, 16))
SPLIT_COUNTS = (1, 2, 4, 8, 16, 32)


def build(name: str, label: str, src: Path) -> tuple[Path, subprocess.Popen]:
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"lib{name}_{label}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-o", str(lib), str(src / f"{name}.cu")]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def split_tree(keys_per_thread: int, merge_batch: int) -> Path:
    """A copy of this tree's csrc/ with split_decode.cuh's two constants set."""
    dst = OUT / f"split_u{keys_per_thread}_m{merge_batch}"
    dst.mkdir(parents=True, exist_ok=True)
    for src in _build.CSRC.glob("*.cu*"):
        text = src.read_text()
        if src.name == "split_decode.cuh":
            for const, value in (("kKeysPerThread", keys_per_thread), ("kMergeBatch", merge_batch)):
                text, n = re.subn(rf"(constexpr int {const} = )\d+;", rf"\g<1>{value};", text)
                assert n == 1, f"split_decode.cuh holds no single {const}"
        (dst / src.name).write_text(text)
    return dst


def ptxas_summary(log: str) -> list[str]:
    """ptxas's register and spill lines, one per kernel instantiation."""
    lines = log.splitlines()
    return [f"{a.strip()} | {b.strip()}" for a, b in zip(lines, lines[1:]) if "spill" in a and "registers" in b]


def host_times(fn, iters: int = 30) -> tuple[float, float]:
    """(host ms of one call, wall ms of one call and a synchronize), medians."""
    fn()
    host, wall = [], []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) * 1e3)
        wall.append((t2 - t0) * 1e3)
    return statistics.median(host), statistics.median(wall)


def first_paged(lib):
    """paged_attention as the first versions' wrapper called them: the same
    input checks, then the C entry point without split workspace or pool
    block count."""
    fns = {}
    for symbol, argtypes in FIRST_PAGED.items():
        fn = lib[symbol]  # its own function object: the A/B loop sets this tree's argtypes on lib.<symbol>
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[symbol] = fn

    def call(q, pool_k, pool_v, tables, write_index, kv_len, *, layer_index=0):
        b, t, hk, g, d = q.shape
        nb, bs = pool_k.shape[1:3]
        check_kernel_inputs(
            "paged_attention", q, (("pool_k", pool_k), ("pool_v", pool_v)),
            (("tables", tables), ("write_index", write_index), ("kv_len", kv_len)),
            max_g=MAX_DECODE_GROUP if t == 1 else MAX_PREFILL_ROWS,
        )
        out = torch.empty_like(q)
        layer_bytes = nb * bs * hk * d * pool_k.element_size()
        ptrs = (q.data_ptr(), pool_k.data_ptr() + layer_index * layer_bytes,
                pool_v.data_ptr() + layer_index * layer_bytes, tables.data_ptr(), write_index.data_ptr(),
                kv_len.data_ptr(), out.data_ptr(), b)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if t == 1:
            rc = fns["cct_paged_decode"](*ptrs, hk, g, d, tables.shape[1], bs, d**-0.5, stream)
        else:
            rc = fns["cct_paged_prefill"](*ptrs, t, hk, g, d, tables.shape[1], bs, d**-0.5, stream)
        if rc != 0:
            raise RuntimeError(f"first-version paged kernel: cudaError {rc}")
        return out

    return call


def first_decode(lib):
    """decode_attention as the first version's wrapper called it: the same
    input checks, then the C entry point without split workspace or split
    count."""
    fn = lib["cct_decode"]
    fn.argtypes = FIRST_DECODE
    fn.restype = ctypes.c_int

    def call(q, k_cache, v_cache, kv_len):
        b, hk, g, d = q.shape
        check_kernel_inputs("decode_attention", q, (("k_cache", k_cache), ("v_cache", v_cache)),
                            (("kv_len", kv_len),), max_g=MAX_DECODE_GROUP)
        out = torch.empty_like(q)
        rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
                b, hk, g, d, k_cache.shape[1], d**-0.5, torch.cuda.current_stream(q.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"first-version contiguous decode: cudaError {rc}")
        return out

    return call


def use(kernel, lib) -> None:
    """Point ``kernel``'s wrapper at ``lib``'s entry point of its symbol."""
    fn = getattr(lib, kernel.symbol)
    fn.argtypes = kernel._argtypes
    fn.restype = ctypes.c_int
    kernel._fn = fn


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", required=True, type=Path, help="an earlier tree's csrc/")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("tc_attention_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    trees = {"this": _build.CSRC, "baseline": args.baseline.resolve()}
    started = {(name, label): build(name, label, src) for name in KERNELS for label, src in trees.items()}
    for u, m in SPLIT_BUILDS[1:]:
        started[("paged_attention", f"split_u{u}_m{m}")] = build("paged_attention", f"u{u}_m{m}", split_tree(u, m))
    libs = {}
    for key, (lib, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib.name}:\n{log}")
        print(json.dumps({"build": lib.name, "ptxas": ptxas_summary(log)}), flush=True)
        libs[key] = ctypes.CDLL(str(lib))
    timer = Timer(dev)
    rng = np.random.default_rng(0)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)

    def flash_call(shape, causal):
        q, k, v = bf16(*shape), bf16(*shape), bf16(*shape)
        return lambda: flash_attention(q, k, v, causal=causal)

    calls = {("flash_attention", case): flash_call(shape, causal) for case, (shape, causal) in FLASH_CASES.items()}
    q, k, v = bf16(1, 1024, 8, 2, 64), bf16(1, 1024, 8, 64), bf16(1, 1024, 8, 64)
    wi = torch.zeros(1, dtype=torch.int32, device=dev)
    kl = torch.full((1,), 686, dtype=torch.int32, device=dev)
    calls[("prefill_attention", "prefill_1024")] = lambda: prefill_attention(q, k, v, wi, kl)

    def first_form(name: str) -> bool:
        return "part_ml" not in (trees["baseline"] / f"{name}.cu").read_text()

    # paged: through this tree's wrapper, or the first versions' form
    hk, g, d, bs = 8, 2, 64, 16
    paged_fn = {"this": paged_attention, "baseline": paged_attention}
    if first_form("paged_attention"):
        paged_fn["baseline"] = first_paged(libs[("paged_attention", "baseline")])
    tree_now = {"label": "this"}

    def paged_call(b, t, nbl, write, kv_len, idle_row=False, bs=bs):
        n_blocks = b * nbl + 1
        pk, pv = bf16(2, n_blocks, bs, hk, d), bf16(2, n_blocks, bs, hk, d)
        tables = rng.permutation(np.arange(1, n_blocks))[: b * nbl].reshape(b, nbl)
        if idle_row:
            tables[-1] = 0
        qp = bf16(b, t, hk, g, d)
        tb, wp, kp = (torch.as_tensor(np.asarray(x, np.int32), device=dev) for x in (tables, write, kv_len))
        call = lambda: paged_fn[tree_now["label"]](qp, pk, pv, tb, wp, kp, layer_index=1)  # noqa: E731
        return call, (qp, pk[1][tb.long()], pv[1][tb.long()], wp, kp)

    calls[("paged_attention", "paged_prefill_256")] = paged_call(2, 256, 64, [0, 300], [256, 556])[0]
    db, dt, dw, dkv = DRIVE_PREFILL
    for bsz in BLOCK_SIZES:
        call, (qp, gk, gv, wp, kp) = paged_call(db, dt, DRIVE_WIDTH // bsz, [dw] * db, [dkv] * db, bs=bsz)
        calls[("paged_attention", f"paged_prefill_drive_bs{bsz}")] = call
    gk, gv = (x.reshape(db, DRIVE_WIDTH, hk, d).contiguous() for x in (gk, gv))
    calls[("prefill_attention", "prefill_drive_gathered")] = lambda: prefill_attention(qp, gk, gv, wp, kp)
    decode_fn = {"this": decode_attention, "baseline": decode_attention}
    if first_form("decode_attention"):
        decode_fn["baseline"] = first_decode(libs[("decode_attention", "baseline")])
    decode_calls = {}

    def contiguous_call(*args):
        return lambda: decode_fn[tree_now["label"]](*args)

    for nbl in (64, 16):
        width = nbl * bs
        kv = rng.integers(64, width, 4)
        kv[-1] = 1
        decode_calls[width], (dq, dk, dv, _, dkl) = paged_call(4, 1, nbl, kv - 1, kv, idle_row=True)
        calls[("paged_attention", f"paged_decode_{width}")] = decode_calls[width]
        dk, dv = (x.reshape(4, width, hk, d).contiguous() for x in (dk, dv))
        calls[("decode_attention", f"decode_on_paged_rows_{width}")] = contiguous_call(
            dq[:, 0].contiguous(), dk, dv, dkl)
    # contiguous decode at the gather engine's lanes
    for width in (1024, 256):
        kv = rng.integers(64, width + 1, 4)
        kv[-1] = 1
        kld = torch.as_tensor(kv.astype(np.int32), device=dev)
        calls[("decode_attention", f"decode_{width}")] = contiguous_call(
            bf16(4, hk, g, d), bf16(4, width, hk, d), bf16(4, width, hk, d), kld)
    # the timer's floor: one launch that does next to nothing
    tiny = torch.zeros(1, device=dev)
    calls[("floor", "one_element_fill")] = tiny.zero_

    for label in ("this", "baseline", "baseline", "this"):
        tree_now["label"] = label
        for name, held in KERNELS.items():
            for kernel in held:
                use(kernel, libs[(name, label)])
        for (name, case), call in calls.items():
            host_ms, wall_ms = host_times(call)
            print(json.dumps({"kernel": name, "tree": label, "case": case, "ms": timer(call),
                              "host_ms": host_ms, "wall_ms": wall_ms}), flush=True)
    # split-decode geometry: this tree's wrapper at a fixed split count
    tree_now["label"] = "this"
    chosen = {width: decode_split_count(width, 4 * hk, paged_module._sm_count(0)) for width in decode_calls}
    for u, m in (*SPLIT_BUILDS, SPLIT_BUILDS[0]):
        label = "this" if (u, m) == SPLIT_BUILDS[0] else f"split_u{u}_m{m}"
        use(PAGED_DECODE_KERNEL, libs[("paged_attention", label)])
        for width, call in decode_calls.items():
            for n_split in SPLIT_COUNTS:
                paged_module.decode_split_count = lambda *_, n=n_split: n
                print(json.dumps({"sweep": "split_decode", "keys_per_thread": u, "merge_batch": m,
                                  "width": width, "n_split": n_split, "chosen": n_split == chosen[width],
                                  "ms": timer(call)}), flush=True)
    paged_module.decode_split_count = decode_split_count
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
