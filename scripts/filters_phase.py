"""``chip_smoke.py``'s ``filters`` phase alone, on the card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/filters_phase.py

It builds the kernels, checks flash against its plain version at
``chip_smoke.FLASH_CASES``, writes the first ``chip_smoke.FILTER_VIDEOS``
videos of the split corpus, then runs ``chip_smoke.drive_filters`` (the OCR
models on the card against their CPU path, ``run_split`` with the text and
semantic filters, ``video`` embeddings, captions and enhanced captions, and
the fan-out pair of run A's settings) and prints the card's name and power
limit and the phase's JSON line.
"""

from __future__ import annotations

import os
import sys


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("filters_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke

    dev = torch.device("cuda", 0)
    _, build_s = chip_smoke.phase_prologue(dev)
    with chip_smoke.split_corpus(chip_smoke.FILTER_VIDEOS) as (root, corpus, corpus_s):
        result = chip_smoke.drive_filters(dev, root, corpus)
    chip_smoke.emit({"phase": "filters", "build_s": build_s, "corpus_build_s": corpus_s, **result})
    return 0


if __name__ == "__main__":
    sys.exit(main())
