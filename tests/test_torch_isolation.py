"""The port stands alone: importing every module of ``cosmos_curate_tpu_torch``
loads no JAX, no flax and nothing of the JAX package, and its entry points
run on the GPU unless the caller asks for the CPU."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax_flax_or_reference_package():
    script = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import cosmos_curate_tpu_torch as port
        names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(
            m for m in sys.modules
            if m in ("jax", "flax", "cosmos_curate_tpu")
            or m.startswith(("jax.", "flax.", "cosmos_curate_tpu."))
        )
        print(len(names), bad)
        sys.exit(1 if bad else 0)
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 32


def test_engine_defaults_to_the_gpu():
    import torch

    from cosmos_curate_tpu_torch.models.vlm import CaptionEngine, VLM_TINY_TEST

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CaptionEngine(VLM_TINY_TEST)


@pytest.mark.parametrize("entry", ["embedder", "stage"])
def test_embed_leg_defaults_to_the_gpu(entry):
    import torch

    from cosmos_curate_tpu_torch.models.embedder import VIDEO_EMBED_TINY_TEST, VideoEmbedder
    from cosmos_curate_tpu_torch.pipelines.video.stages.embedding import ClipEmbeddingStage

    def make(**kw):
        if entry == "embedder":
            return VideoEmbedder(VIDEO_EMBED_TINY_TEST, **kw).device
        return ClipEmbeddingStage(video_cfg=VIDEO_EMBED_TINY_TEST, **kw).model.device

    if torch.cuda.is_available():
        assert make().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert make(device="cpu").type == "cpu"
