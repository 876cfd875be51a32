"""A two-node partition on the card.

Marked ``cuda``: it skips without a CUDA device (this file imports no JAX).
Run on the GPU with ``python -m pytest -m cuda tests/test_torch_cuda_multinode.py``.

Two node processes under ``CURATE_NUM_NODES=2`` (ranks 0 and 1, no
coordinator), released at one moment, run ``run_split`` with
``chip_smoke.split_args`` (run A's settings: ``VIDEO_EMBED_BASE`` on the
card) on two corpus videos, both on the one card; each reports the launch
counts of its own process. Each node takes one video, flash launches in
both, and ``local merge-summaries`` folds their summaries into the corpus's
counts.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def phase():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, str(REPO / "scripts"))
    sys.path.insert(0, str(REPO))
    import chip_smoke
    import multinode_phase

    from cosmos_curate_tpu_torch.ops import _build

    _build.build_all()  # once, before the nodes start
    return chip_smoke, multinode_phase


def test_two_node_partition_launches_flash_in_each_node(phase):
    cs, mp = phase
    with cs.split_corpus(2) as (root, corpus, _):
        videos = cs.subset(root, corpus, "node_videos", 2)
        out = root / "out"
        run, = mp.run_nodes([sys.executable, str(REPO / "scripts" / "multinode_phase.py"), "--node"], videos,
                            [(out, {})], "cuda")
        merge = subprocess.run([sys.executable, "-m", "cosmos_curate_tpu_torch.cli.main", "local", "merge-summaries",
                                "--output-path", str(out)], cwd=REPO, capture_output=True, text=True, timeout=120)
        assert merge.returncode == 0, merge.stderr[-3000:]
        merged = json.loads((out / "summary-merged.json").read_text())
    nodes = run["nodes"]
    assert [nodes[r]["num_videos"] for r in (0, 1)] == [1, 1]
    assert all(nodes[r]["launches"]["flash"] > 0 for r in (0, 1)), nodes
    assert merged["num_videos"] == 2 and merged["num_clips"] == nodes[0]["num_clips"] + nodes[1]["num_clips"] > 0
