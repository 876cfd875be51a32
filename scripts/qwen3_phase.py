"""``chip_smoke.py``'s Qwen3 phases alone, on the card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/qwen3_phase.py

It builds the kernels, checks flash against its plain version at
``chip_smoke.FLASH_CASES``, checks kernels 1-4 at Qwen3-VL-30B-A3B's heads
(``chip_smoke.check_qwen_kernels``: Hkv 4, G 8, D 128) and drives
``CaptionEngine(VLM_QWEN3_VL_MOE_A3B)`` at full width and depth, paged and
gather (``chip_smoke.drive_qwen3``), then prints each phase's JSON line
after the card's name and power limit. Its numbers are those of the whole
script's phases, without the earlier phases in front of them.
"""

from __future__ import annotations

import os
import sys
import tempfile
from pathlib import Path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("qwen3_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke

    dev = torch.device("cuda", 0)
    timer, build_s = chip_smoke.phase_prologue(dev)
    checks = chip_smoke.check_qwen_kernels(timer, dev, (chip_smoke.QWEN3_FLAVOR,), chip_smoke.QWEN3_SUFFIX,
                                           chip_smoke.SEED + 11)
    chip_smoke.emit({"phase": "qwen3_kernels", "build_s": build_s, "bound": chip_smoke.BOUND, "results": checks})
    with tempfile.TemporaryDirectory(prefix="qwen3_phase-") as tmp:
        chip_smoke.emit({"phase": "qwen3", **chip_smoke.drive_qwen3(dev, timer, Path(tmp), checks)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
