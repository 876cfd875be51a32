"""The image pipeline on the card against its CPU path.

Marked ``cuda``: they skip without a CUDA device (this file imports no JAX).
Run on the GPU with ``python -m pytest -m cuda tests/test_torch_cuda_image.py``.
Inputs and weights come from seeds.

- ``preprocess_frames`` (``simple`` and ``clip``) on a 4032x3024 phone photo
  and its portrait turn: the card's dense resize weights against the CPU
  path's, fp32 (TF32 is off for matmuls by default), at the CPU parity
  tests' bar (atol 2e-5, rtol 1e-4).
- ``run_image_annotate`` on 8 stills on the card: every image embedded
  (unit-norm, 512-d) and scored, flash launched; the embeddings and scores
  within ``EMBED_BOUND`` / ``SCORE_BOUND`` of the same stages on the CPU
  holding the weights the card's stages drew (the seeded init is drawn on
  the device it runs on).
"""

import hashlib
import json

import cv2
import numpy as np
import pytest
import torch

from cosmos_curate_tpu_torch.core.runner import SequentialRunner
from cosmos_curate_tpu_torch.models.vit import preprocess_frames
from cosmos_curate_tpu_torch.ops import kernels
from cosmos_curate_tpu_torch.pipelines.image import annotate

pytestmark = pytest.mark.cuda

EMBED_BOUND = 3e-3  # chip_smoke.EMBED_BOUND: bf16 towers, CPU vs card
SCORE_BOUND = 2e-2  # the aesthetic stage's bf16 bound


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _photo(seed: int, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 8, w // 8, 3), dtype=np.uint8)
    img = cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)
    return cv2.add(img, rng.integers(0, 16, (h, w, 3), dtype=np.uint8))


@pytest.mark.parametrize("mode", ["simple", "clip"])
@pytest.mark.parametrize("hw", [(3024, 4032), (4032, 3024)], ids=["landscape", "portrait"])
def test_preprocess_on_the_card_matches_the_cpu(dev, mode, hw):
    frames = _photo(hw[0], *hw)[None]
    got = preprocess_frames(torch.from_numpy(frames).to(dev), image_size=224, mode=mode).cpu().numpy()
    want = preprocess_frames(torch.from_numpy(frames), image_size=224, mode=mode).numpy()
    assert got.shape == want.shape == (1, 224, 224, 3)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_run_image_annotate_on_the_card(dev, tmp_path):
    import pyarrow.parquet as pq

    images = tmp_path / "images"
    images.mkdir()
    sizes = [(1080, 1920), (1920, 1080), (720, 1280), (480, 640), (333, 500), (1500, 2000), (224, 224), (768, 1024)]
    for i, (h, w) in enumerate(sizes):
        cv2.imwrite(str(images / f"{i}.{'png' if i % 3 == 0 else 'jpg'}"), _photo(i, h, w))
    flash = kernels()["flash"]
    flash.launches = 0
    summary = annotate.run_image_annotate(
        annotate.ImagePipelineArgs(input_path=str(images), output_path=str(tmp_path / "out"), aesthetic_threshold=0.0))
    assert flash.launches > 0
    assert (summary["num_images"], summary["num_embedded"], summary["num_errors"]) == (8, 8, 0), summary
    embs = {}
    for path in (tmp_path / "out" / "embeddings" / "clip").glob("*.parquet"):  # one a writer call
        table = pq.read_table(path).to_pydict()
        embs.update((iid, np.asarray(e, np.float32)) for iid, e in zip(table["image_id"], table["embedding"],
                                                                          strict=True))
    assert len(embs) == 8
    for e in embs.values():
        assert e.shape == (512,) and np.isfinite(e).all() and abs(np.linalg.norm(e) - 1.0) < 1e-2

    # the CPU path on the weights the card's stages drew
    stages = []
    for cls, kw in ((annotate.ImageEmbeddingStage, {}), (annotate.ImageAestheticFilterStage, {"threshold": 0.0})):
        card = cls(device=dev, **kw)
        card.setup(None)
        cpu = cls(device="cpu", **kw)
        cpu.model.params = {k: v.cpu() for k, v in card.model.model.state_dict().items()}
        cpu.setup(None)
        stages.append(cpu)
    tasks = annotate.ImageLoadStage().process_data(
        [annotate.ImageTask(path=str(p)) for p in sorted(images.iterdir())])
    for stage in stages:
        tasks = stage.process_data(tasks)
    for t in tasks:
        iid = hashlib.sha256(t.path.encode()).hexdigest()[:24]
        meta = json.loads((tmp_path / "out" / "metas" / f"{iid}.json").read_text())
        assert np.abs(t.embedding - embs[iid]).max() <= EMBED_BOUND, t.path
        assert abs(t.aesthetic_score - meta["aesthetic_score"]) <= SCORE_BOUND, t.path
        if abs(t.aesthetic_score) > SCORE_BOUND:
            assert t.filtered_by == meta["filtered_by"], t.path
    # the sequential runner on the card writes the same images
    again = annotate.run_image_annotate(
        annotate.ImagePipelineArgs(input_path=str(images), output_path=str(tmp_path / "seq"), aesthetic_threshold=0.0),
        runner=SequentialRunner())
    assert {k: v for k, v in again.items() if k != "pipeline_run_time_s"} == {
        k: v for k, v in summary.items() if k != "pipeline_run_time_s"}
