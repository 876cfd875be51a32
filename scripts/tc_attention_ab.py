"""The port's tensor-core attention kernels against an earlier tree's, on the card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/tc_attention_ab.py --baseline DIR

``DIR`` is an earlier tree's ``cosmos_curate_tpu_torch/csrc`` whose
``cct_flash`` and ``cct_prefill`` have the C signatures of this tree's. The
script builds ``flash_attention.cu`` and ``prefill_attention.cu`` of both
trees into ``build/tc_ab/`` (one ``nvcc`` each, all at once), points the
wrappers at each build in turn, in the order this tree, baseline, baseline,
this tree, so drift shows, and reads at the main path's shapes: flash at
ViT-B/16's ``[128, 12, 197, 64]`` (one 16-clip dispatch) and
``[256, 12, 197, 64]`` (32 clips), the pooler's ``[16, 8, 9, 64]`` and causal
``[1, 16, 2305, 64]``; prefill at the 1024-token prefix build (kv_len 686,
Hkv 8, G 2, D 64). Per shape:

- ``ms``: ``chip_smoke.Timer``'s device time, the median of 30 CUDA-event
  timings with L2 flushed and the host kept ahead of the device;
- ``host_ms``: the host's time in one wrapper call (input checks, the
  kernel's host code, the launch), median of 30 calls each made on a
  drained queue;
- ``wall_ms``: one call and a synchronize on the host's clock, with no
  flush and no spin, median of 30.

One JSON line per build (ptxas registers and spills) and per reading, then
the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
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
from cosmos_curate_tpu_torch.ops.flash_attention import FLASH_KERNEL, flash_attention  # noqa: E402
from cosmos_curate_tpu_torch.ops.prefill_attention import PREFILL_KERNEL, prefill_attention  # noqa: E402

OUT = ROOT / "build" / "tc_ab"
KERNELS = {"flash_attention": FLASH_KERNEL, "prefill_attention": PREFILL_KERNEL}
FLASH_CASES = {
    "vit_b16_224": ((128, 12, 197, 64), False),
    "vit_b16_224_32_clips": ((256, 12, 197, 64), False),
    "pooler": ((16, 8, 9, 64), False),
    "causal_2305": ((1, 16, 2305, 64), True),
}


def build(name: str, label: str, src: Path) -> tuple[Path, subprocess.Popen]:
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"lib{name}_{label}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas=-v", "-o", str(lib), str(src / f"{name}.cu")]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


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

    for label in ("this", "baseline", "baseline", "this"):
        for name, kernel in KERNELS.items():
            fn = getattr(libs[(name, label)], kernel.symbol)
            fn.argtypes = kernel._argtypes
            fn.restype = ctypes.c_int
            kernel._fn = fn
        for (name, case), call in calls.items():
            host_ms, wall_ms = host_times(call)
            print(json.dumps({"kernel": name, "tree": label, "case": case, "ms": timer(call),
                              "host_ms": host_ms, "wall_ms": wall_ms}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
