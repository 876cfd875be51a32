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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("split_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke

    dev = torch.device("cuda", 0)
    timer, build_s = chip_smoke.phase_prologue(dev)
    with chip_smoke.split_corpus() as (root, corpus, corpus_s):
        result = chip_smoke.drive_split(dev, timer, root, corpus, corpus_s)
    chip_smoke.emit({"phase": "split", "build_s": build_s, **result})
    return 0


if __name__ == "__main__":
    sys.exit(main())
