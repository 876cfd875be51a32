"""``chip_smoke.py``'s Qwen phases alone, on the card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/qwen_phase.py

It builds the kernels, checks flash against its plain version at
``chip_smoke.FLASH_CASES``, checks kernels 1-4 at the Qwen drives' shapes
(``chip_smoke.check_qwen_kernels``), drives the dense Qwen-VL caption
flavors (``chip_smoke.drive_qwen``: Qwen2-VL-2B paged and gather, the
prefill forward and both towers against fp32, Qwen2.5-VL-7B end to end)
and the caption stage (``chip_smoke.drive_qwen_stage``), then prints each
phase's JSON line after the card's name and power limit. Its numbers are
those of the whole script's phases, without the earlier phases in front
of them.
"""

from __future__ import annotations

import os
import sys
import tempfile
from pathlib import Path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("qwen_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke

    dev = torch.device("cuda", 0)
    timer, build_s = chip_smoke.phase_prologue(dev)
    checks = chip_smoke.check_qwen_kernels(timer, dev)
    chip_smoke.emit({"phase": "qwen_kernels", "build_s": build_s, "bound": chip_smoke.BOUND, "results": checks})
    with tempfile.TemporaryDirectory(prefix="qwen_phase-") as tmp:
        qwen = chip_smoke.drive_qwen(dev, timer, Path(tmp), checks)
        qwen_7b = qwen.pop("qwen25vl_7b")
        chip_smoke.emit({"phase": "qwen", **qwen})
        chip_smoke.emit({"phase": "qwen_7b", **qwen_7b})
        chip_smoke.emit({"phase": "qwen_stage", **chip_smoke.drive_qwen_stage(dev, Path(tmp))})
    return 0


if __name__ == "__main__":
    sys.exit(main())
