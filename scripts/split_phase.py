"""``chip_smoke.py``'s ``split`` phase alone, on the card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/split_phase.py

It builds the kernels, checks flash against its plain version at
``chip_smoke.FLASH_CASES`` (the shapes the split path's embed dispatches
must use), then runs ``chip_smoke.drive_split`` (bench.py's corpus through
``run_split``: run A, run B, both runners, resume) and prints the card's
name and power limit and the phase's JSON line. Its numbers are
those of the whole script's ``split`` phase, without the earlier phases'
host memory and warm-up in front of it.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("split_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from cosmos_curate_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    t0 = time.monotonic()
    _build.build_all()
    build_s = time.monotonic() - t0
    print(chip_smoke.card_line(), flush=True)
    timer = chip_smoke.Timer(dev)
    rng = np.random.default_rng(chip_smoke.SEED)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)

    flash = {label: chip_smoke.check_flash(timer, bf16, shape, causal, label)
             for label, shape, causal in chip_smoke.FLASH_CASES}
    chip_smoke.emit({"phase": "flash", "bound": chip_smoke.BOUND, "cases": flash})
    chip_smoke.emit({"phase": "split", "build_s": build_s, **chip_smoke.drive_split(dev, timer)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
