"""``chip_smoke.py``'s ``canonical`` and ``iv2`` phases alone, on the card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/canonical_phase.py

It builds the kernels, checks flash against its plain version at
``chip_smoke.FLASH_CASES`` (CLIP ViT-L/14's [32, 16, 257, 64] among them),
runs ``chip_smoke.drive_iv2`` (the InternVideo2-1B embed stage), builds
bench.py's corpus and runs ``chip_smoke.drive_canonical`` (run C:
TransNetV2 shot detection -> aesthetic filter -> CLIP embeddings through
``run_split``), then prints the card's name and power limit and each
phase's JSON line. Its numbers are those of the whole script's phases,
without the earlier phases' host memory and warm-up in front of them.
"""

from __future__ import annotations

import os
import sys


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("canonical_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke

    dev = torch.device("cuda", 0)
    timer, build_s = chip_smoke.phase_prologue(dev)
    chip_smoke.emit({"phase": "iv2", **chip_smoke.drive_iv2(dev)})
    with chip_smoke.split_corpus() as (root, corpus, corpus_s):
        canonical = chip_smoke.drive_canonical(dev, timer, root, corpus)
    chip_smoke.emit({"phase": "canonical", "build_s": build_s, "corpus_s": corpus_s, **canonical})
    return 0


if __name__ == "__main__":
    sys.exit(main())
