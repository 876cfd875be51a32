"""Port parity: the image annotate pipeline (``pipelines/image/annotate.py``)
on the CPU.

- ``ImagePipelineArgs``, ``ImageTask`` and ``IMAGE_SUFFIXES`` pinned to the
  reference's, field for field (``device`` aside).
- ``preprocess_frames`` in ``simple`` and ``clip`` modes at photo sizes and
  odd ones (1600x1200, a 3024x4032 portrait phone photo, 333x500,
  1000x750): the dense separable resize weights held to
  ``jax.image.resize`` at 2e-5 / 1e-4, up to an 18x antialiased downscale.
- ``ImageEmbeddingStage`` (``clip-vit-tiny-test``, and the
  ``clip-vit-b16-tpu`` tower at full width on 4 images),
  ``ImageVideoEmbeddingStage`` (a tiny ``VideoEmbedConfig``) and
  ``ImageAestheticFilterStage`` against the JAX stages on the same
  parameters, both in fp32 (the test rebinds each package's tower to its
  fp32 form, as ``test_torch_embedder.py`` does), at the whole-model bar
  (atol 1e-4, rtol 1e-3).
- ``run_image_annotate`` end to end in both packages (tiny towers served
  under the real ids from one JAX-written checkpoint each): byte-equal
  ``metas/`` and ``processed_images/``, the same ``images/`` files, parquet
  rows within the bar, the same summary but its run time; with an
  aesthetic threshold in the widest gap of the scores, the same images
  filtered. Decode edge cases (PNG with alpha, 16-bit PNG, gray JPEG, BMP,
  WebP, an EXIF-rotated JPEG, a truncated JPEG, a zero-byte PNG) and
  resume: the two broken files land in ``errors["load"]`` and are retried.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cosmos_curate_tpu.core.runner import SequentialRunner as JSequentialRunner
from cosmos_curate_tpu.models import clip as jclip
from cosmos_curate_tpu.models import embedder as jemb
from cosmos_curate_tpu.models import registry as jregistry
from cosmos_curate_tpu.models import vit as jvit
from cosmos_curate_tpu.pipelines.image import annotate as jann
from cosmos_curate_tpu_torch.core.runner import SequentialRunner
from cosmos_curate_tpu_torch.models import clip as tclip
from cosmos_curate_tpu_torch.models import embedder as temb
from cosmos_curate_tpu_torch.models import vit as tvit
from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict
from cosmos_curate_tpu_torch.pipelines.image import annotate as tann

ATOL, RTOL = 1e-4, 1e-3
RESIZE_ATOL, RESIZE_RTOL = 2e-5, 1e-4
TINY = "clip-vit-tiny-test"


# -- the image corpus ----------------------------------------------------------


def scene(rng, h: int, w: int) -> np.ndarray:
    """A photo-like RGB scene: a diagonal gradient between two colours over
    a smooth noise texture, with a bright block."""
    c0, c1 = rng.integers(0, 255, 3).astype(np.float32), rng.integers(0, 255, 3).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    angle = rng.uniform(0, 2 * np.pi)
    proj = np.cos(angle) * xx + np.sin(angle) * yy
    phase = (proj - proj.min()) / max(float(np.ptp(proj)), 1.0)
    noise = cv2.resize(rng.integers(0, 60, (max(1, h // 4), max(1, w // 4), 3), dtype=np.uint8), (w, h))
    img = c0 * (1 - phase[..., None]) + c1 * phase[..., None] + noise.astype(np.float32) - 30.0
    y, x = int(rng.integers(0, max(1, h // 2))), int(rng.integers(0, max(1, w // 2)))
    img[y : y + h // 3, x : x + w // 3] = 255.0 - c0
    return np.clip(img, 0, 255).astype(np.uint8)


def exif_oriented_jpeg(rgb: np.ndarray, orientation: int = 6) -> bytes:
    """``rgb`` as a JPEG with an EXIF APP1 segment carrying ``orientation``
    (6: the camera was turned 90 degrees clockwise)."""
    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    assert ok
    tiff = b"MM\x00*" + struct.pack(">I", 8) + struct.pack(">H", 1)
    tiff += struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(">I", 0)
    app1 = b"Exif\x00\x00" + tiff
    jpeg = buf.tobytes()
    return jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + jpeg[2:]


def write_image_corpus(root: Path, seed: int = 0) -> dict[str, Path]:
    """Every decode case the pipeline meets, under ``root``: JPEGs of three
    sizes (one portrait), a PNG with alpha, a 16-bit PNG, a gray JPEG, a
    BMP, a WebP, an EXIF-rotated JPEG, a truncated JPEG, a zero-byte PNG
    and a text file the discovery skips. Returns name -> path."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    paths: dict[str, Path] = {}

    def write(name: str, data: bytes) -> None:
        paths[name] = root / name
        paths[name].write_bytes(data)

    def encode(ext: str, img: np.ndarray, *params) -> bytes:
        ok, buf = cv2.imencode(ext, img, list(params))
        assert ok, ext
        return buf.tobytes()

    for name, (h, w) in (("land.jpg", (48, 64)), ("portrait.jpeg", (72, 40)), ("wide.jpg", (36, 96))):
        write(name, encode(".jpg", scene(rng, h, w)[..., ::-1], cv2.IMWRITE_JPEG_QUALITY, 90))
    alpha = np.concatenate([scene(rng, 40, 56), rng.integers(0, 256, (40, 56, 1), dtype=np.uint8)], axis=-1)
    write("alpha.png", encode(".png", alpha))
    write("deep.png", encode(".png", scene(rng, 44, 52).astype(np.uint16) * 257))
    write("gray.jpg", encode(".jpg", cv2.cvtColor(scene(rng, 50, 50), cv2.COLOR_RGB2GRAY)))
    write("bitmap.bmp", encode(".bmp", scene(rng, 30, 40)))
    write("still.webp", encode(".webp", scene(rng, 48, 48), cv2.IMWRITE_WEBP_QUALITY, 90))
    write("rotated.jpg", exif_oriented_jpeg(scene(rng, 40, 64)))
    good = encode(".jpg", scene(rng, 64, 64))
    write("truncated.jpg", good[: len(good) // 2])
    write("empty.png", b"")
    (root / "notes.txt").write_text("not an image")
    return paths


BROKEN = ("truncated.jpg", "empty.png")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("images")
    write_image_corpus(root)
    return root


# -- mirrored types ------------------------------------------------------------


def test_image_args_mirror_the_reference_field_for_field():
    port = [(f.name, f.default) for f in dataclasses.fields(tann.ImagePipelineArgs)]
    assert port[-1] == ("device", "cuda")
    assert port[:-1] == [(f.name, f.default) for f in dataclasses.fields(jann.ImagePipelineArgs)]
    assert [(f.name, str(f.type)) for f in dataclasses.fields(tann.ImageTask)] == [
        (f.name, str(f.type)) for f in dataclasses.fields(jann.ImageTask)]
    assert tann.IMAGE_SUFFIXES == jann.IMAGE_SUFFIXES


# -- resize at photo sizes -----------------------------------------------------


@pytest.mark.parametrize("mode", ["simple", "clip"])
@pytest.mark.parametrize("hw", [(1200, 1600), (4032, 3024), (333, 500), (750, 1000)],
                         ids=["1600x1200", "3024x4032-portrait", "333x500", "1000x750"])
def test_preprocess_matches_jax_at_photo_sizes(mode, hw):
    frames = scene(np.random.default_rng(hw[0]), *hw)[None]
    want = np.asarray(jax.jit(functools.partial(jvit.preprocess_frames, image_size=224, mode=mode))(frames))
    got = tvit.preprocess_frames(torch.from_numpy(frames), image_size=224, mode=mode).numpy()
    assert got.shape == want.shape == (1, 224, 224, 3)
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=RESIZE_RTOL)


# -- the model stages ----------------------------------------------------------


@pytest.fixture
def fp32(monkeypatch):
    """Both packages' CLIP and video towers in fp32 (their compiled JAX
    functions are cached per config: cleared around the test)."""
    monkeypatch.setattr(jclip, "ViT", functools.partial(jvit.ViT, dtype=jnp.float32))
    monkeypatch.setattr(jemb, "ViT", functools.partial(jvit.ViT, dtype=jnp.float32))
    monkeypatch.setattr(jemb, "TemporalPooler", functools.partial(jemb.TemporalPooler, dtype=jnp.float32))
    monkeypatch.setattr(tclip, "CLIPImageModel", functools.partial(tclip.CLIPImageModel, dtype=torch.float32))
    monkeypatch.setattr(temb, "VideoEmbedModel", functools.partial(temb.VideoEmbedModel, dtype=torch.float32))
    jclip._jitted_embed.cache_clear()
    jemb._jitted_apply.cache_clear()
    yield
    jclip._jitted_embed.cache_clear()
    jemb._jitted_apply.cache_clear()


@pytest.fixture
def no_weights(tmp_path, monkeypatch):
    """No staged checkpoint: both registries take their seeded inits."""
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(tmp_path / "weights"))


def _loaded(mod, paths: list[Path]):
    return mod.ImageLoadStage().process_data([mod.ImageTask(path=str(p)) for p in paths])


def _photos(root: Path, n: int, seed: int) -> list[Path]:
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    out = []
    for i, (h, w) in enumerate([(300, 400), (400, 300), (123, 517), (224, 224)][:n]):
        out.append(root / f"p{i}.png")
        cv2.imwrite(str(out[-1]), scene(rng, h, w))
    return out


def _embed_both(j_stage, t_stage, paths):
    j_stage.setup(None)
    j_out = j_stage.process_data(_loaded(jann, paths))
    # the same parameters: the JAX stage's seeded init, carried over
    t_stage.model.params = flax_to_state_dict(j_stage.model._params)
    t_stage.setup(None)
    t_out = t_stage.process_data(_loaded(tann, paths))
    return j_out, t_out


@pytest.mark.parametrize("variant,resize,n", [(TINY, (32, 32), 4), ("clip-vit-b16-tpu", (224, 224), 4)],
                         ids=["tiny-test", "b16"])
def test_embedding_stage_matches_jax(variant, resize, n, fp32, no_weights, corpus, tmp_path):
    paths = [*sorted(p for p in corpus.iterdir() if p.suffix != ".txt"), *_photos(tmp_path, n, 1)]
    if variant != TINY:
        paths = paths[-n:]
    j_out, t_out = _embed_both(jann.ImageEmbeddingStage(clip_variant=variant, resize_hw=resize),
                               tann.ImageEmbeddingStage(clip_variant=variant, resize_hw=resize, device="cpu"), paths)
    for j, t in zip(j_out, t_out, strict=True):
        assert (t.errors, t.width, t.height) == (j.errors, j.width, j.height), t.path
        if j.embedding is None:
            assert t.embedding is None and Path(t.path).name in BROKEN
            continue
        assert t.embedding.shape == (tclip._CONFIGS[variant].projection_dim,)
        np.testing.assert_allclose(t.embedding, j.embedding, atol=ATOL, rtol=RTOL, err_msg=t.path)
    assert sum(t.embedding is not None for t in t_out) == len(paths) - (len(BROKEN) if variant == TINY else 0)


def test_video_embedding_stage_matches_jax(fp32, no_weights, corpus):
    cfg = dict(vit=dict(image_size=32, patch_size=16, width=32, layers=1, heads=2, projection_dim=16),
               temporal_layers=1, temporal_heads=2, num_frames=2, output_dim=16)
    jcfg = jemb.VideoEmbedConfig(**{**cfg, "vit": jvit.ViTConfig(**cfg["vit"])})
    tcfg = temb.VideoEmbedConfig(**{**cfg, "vit": tvit.ViTConfig(**cfg["vit"])})
    paths = sorted(p for p in corpus.iterdir() if p.suffix != ".txt")
    j_out, t_out = _embed_both(jann.ImageVideoEmbeddingStage(video_cfg=jcfg),
                               tann.ImageVideoEmbeddingStage(video_cfg=tcfg, device="cpu"), paths)
    embedded = 0
    for j, t in zip(j_out, t_out, strict=True):
        if j.embedding is None:
            assert t.embedding is None
            continue
        embedded += 1
        assert t.embedding.shape == (16,)
        np.testing.assert_allclose(t.embedding, j.embedding, atol=ATOL, rtol=RTOL, err_msg=t.path)
    assert embedded == len(paths) - len(BROKEN)


def test_video_embedding_stage_variants_match_jax():
    assert tann.ImageVideoEmbeddingStage(device="cpu").model.model_id_names == \
        jann.ImageVideoEmbeddingStage().model.model_id_names == ["video-embed-tpu"]
    with pytest.raises(ValueError, match="unknown embedder variant"):
        tann.ImageVideoEmbeddingStage(variant="iv2", device="cpu")


@pytest.mark.parametrize("score_only", [True, False])
def test_aesthetic_stage_matches_jax(score_only, no_weights):
    emb = np.random.default_rng(4).standard_normal((9, 512)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    j_stage = jann.ImageAestheticFilterStage(threshold=0.0, score_only=score_only)
    j_stage.setup(None)
    t_stage = tann.ImageAestheticFilterStage(threshold=0.0, score_only=score_only, device="cpu")
    t_stage.model.params = flax_to_state_dict(j_stage.model._params)
    t_stage.setup(None)

    def tasks(mod):
        return [mod.ImageTask(path=f"i{i}.jpg", embedding=e) for i, e in enumerate(emb)] + [mod.ImageTask(path="x")]

    j_out, t_out = j_stage.process_data(tasks(jann)), t_stage.process_data(tasks(tann))
    j_scores = np.array([t.aesthetic_score for t in j_out[:-1]])
    np.testing.assert_allclose([t.aesthetic_score for t in t_out[:-1]], j_scores, atol=ATOL, rtol=RTOL)
    assert t_out[-1].aesthetic_score is None
    # away from the threshold the decisions are equal
    clear = np.abs(j_scores) > 1e-3
    assert [t.filtered_by for t, c in zip(t_out, clear) if c] == [t.filtered_by for t, c in zip(j_out, clear) if c]
    assert any(t.filtered_by for t in t_out) != score_only


# -- the pipeline end to end ---------------------------------------------------


@pytest.fixture(scope="module")
def tiny_weights(tmp_path_factory) -> Path:
    """One JAX-written checkpoint per id the default image path loads, at
    tiny widths: the tiny CLIP tower under ``clip-vit-b16-tpu`` and the
    aesthetic head over its 32-d embeddings."""
    root = tmp_path_factory.mktemp("image_weights")
    vit_init = jax.jit(jvit.ViT(jclip._CONFIGS[TINY]).init)
    jregistry.save_params("clip-vit-b16-tpu", vit_init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3))), root=root)
    jregistry.save_params("aesthetics-mlp-tpu", jclip.AestheticMLP().init(jax.random.PRNGKey(4), jnp.zeros((1, 32))),
                          root=root)
    return root


@pytest.fixture
def tiny_path(tiny_weights, monkeypatch):
    """Both packages serve the tiny tower under ``clip-vit-b16-tpu`` (at
    32x32 inputs, the aesthetic head at 32 wide), in fp32, from the staged
    checkpoints."""
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(tiny_weights))
    for mod in (jclip, tclip):
        monkeypatch.setitem(mod._CONFIGS, "clip-vit-b16-tpu", mod._CONFIGS[TINY])
    for mod in (jann, tann):
        monkeypatch.setattr(mod, "ImageEmbeddingStage", functools.partial(mod.ImageEmbeddingStage,
                                                                          resize_hw=(32, 32)))
        monkeypatch.setattr(mod, "ImageAestheticFilterStage", functools.partial(mod.ImageAestheticFilterStage,
                                                                                embedding_dim=32))


def read_output(out: Path) -> dict:
    """Every output file: raw bytes, except the parquet (uuid-named):
    image id -> embedding, and the summary without its run time."""
    import pyarrow.parquet as pq

    files, rows = {}, {}
    for p in sorted(out.rglob("*")):
        if not p.is_file():
            continue
        rel = str(p.relative_to(out))
        if p.suffix == ".parquet":
            table = pq.read_table(p).to_pydict()
            for iid, emb in zip(table["image_id"], table["embedding"], strict=True):
                assert iid not in rows
                rows[iid] = np.asarray(emb, np.float32)
        elif rel == "summary.json":
            summary = json.loads(p.read_text())
            assert summary.pop("pipeline_run_time_s") >= 0
            files[rel] = summary
        else:
            files[rel] = p.read_bytes()
    return {"files": files, "rows": rows}


def run_both(corpus: Path, tmp_path: Path, runner: str = "sequential", **kw) -> tuple[dict, dict, dict, dict]:
    """``run_image_annotate`` of each package on ``corpus``: (JAX summary,
    port summary, JAX output, port output)."""
    j_sum = jann.run_image_annotate(jann.ImagePipelineArgs(input_path=str(corpus), output_path=str(tmp_path / "jax"),
                                                           **kw), runner=JSequentialRunner())
    t_sum = tann.run_image_annotate(
        tann.ImagePipelineArgs(input_path=str(corpus), output_path=str(tmp_path / "port"), device="cpu", **kw),
        runner=SequentialRunner() if runner == "sequential" else None)
    return j_sum, t_sum, read_output(tmp_path / "jax"), read_output(tmp_path / "port")


def _metas(out: dict) -> dict[str, dict]:
    return {k: json.loads(v) for k, v in out["files"].items() if k.startswith("metas/")}


@pytest.mark.parametrize("runner", ["sequential", "default"])
def test_run_image_annotate_matches_jax(runner, tiny_path, fp32, corpus, tmp_path):
    j_sum, t_sum, j_out, t_out = run_both(corpus, tmp_path, runner)
    j_sum.pop("pipeline_run_time_s"), t_sum.pop("pipeline_run_time_s")
    assert t_sum == j_sum
    assert t_sum == {"num_images": 11, "num_embedded": 9, "num_filtered": 0, "num_captioned": 0, "num_errors": 2}
    assert t_out["files"] == j_out["files"]  # metas, processed_images, images, summary: byte for byte
    assert t_out["rows"].keys() == j_out["rows"].keys() and len(t_out["rows"]) == 9
    for iid, emb in t_out["rows"].items():
        np.testing.assert_allclose(emb, j_out["rows"][iid], atol=ATOL, rtol=RTOL)
    metas = _metas(t_out)
    broken = {Path(m["path"]).name: m for m in metas.values() if m["errors"]}
    assert sorted(broken) == sorted(BROKEN)
    assert all(set(m["errors"]) == {"load"} for m in broken.values())
    sizes = {Path(m["path"]).name: (m["width"], m["height"]) for m in metas.values()}
    assert sizes["rotated.jpg"] == (40, 64)  # EXIF orientation 6 applied: 64x40 stored, 40x64 shown
    assert sizes["portrait.jpeg"] == (40, 72)
    images = {k for k in t_out["files"] if k.startswith("images/")}
    assert len(images) == 9 and {Path(k).suffix for k in images} == {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def test_aesthetic_threshold_filters_like_jax(tiny_path, fp32, corpus, tmp_path):
    """Scores first, then a threshold in the widest gap of the JAX scores:
    the same images filtered and copied, the metas equal but for the
    scores, which sit within the bar."""
    _, _, j_out, t_out = run_both(corpus, tmp_path / "scores", aesthetic_threshold=-1e9)
    j_scores = {k: m["aesthetic_score"] for k, m in _metas(j_out).items() if m["aesthetic_score"] is not None}
    t_scores = {k: m["aesthetic_score"] for k, m in _metas(t_out).items() if m["aesthetic_score"] is not None}
    assert t_scores.keys() == j_scores.keys() and len(t_scores) == 9
    diff = max(abs(t_scores[k] - j_scores[k]) for k in t_scores)
    assert diff <= ATOL + RTOL * max(abs(v) for v in j_scores.values())
    ordered = sorted(j_scores.values())
    gap, i = max((b - a, i) for i, (a, b) in enumerate(zip(ordered[1:-2], ordered[2:-1]), start=1))
    assert gap > 2 * diff
    threshold = (ordered[i] + ordered[i + 1]) / 2

    j_sum, t_sum, j_out, t_out = run_both(corpus, tmp_path / "filtered", aesthetic_threshold=threshold)
    assert 0 < t_sum["num_filtered"] == j_sum["num_filtered"] < 9
    j_metas, t_metas = _metas(j_out), _metas(t_out)
    for k, m in t_metas.items():
        j = dict(j_metas[k])
        if m["aesthetic_score"] is not None:
            assert abs(m["aesthetic_score"] - j["aesthetic_score"]) <= diff + 1e-7
            j["aesthetic_score"] = m["aesthetic_score"]
        assert m == j, k
    assert {k for k in t_out["files"] if not k.startswith("metas/")} == {
        k for k in j_out["files"] if not k.startswith("metas/")}
    assert sum(m["filtered_by"] == "aesthetic" for m in t_metas.values()) == t_sum["num_filtered"]


def test_resume_retries_only_the_broken_images(tiny_path, fp32, corpus, tmp_path):
    run_both(corpus, tmp_path)
    for mod, name in ((jann, "jax"), (tann, "port")):
        again = mod.discover_image_tasks(str(corpus), str(tmp_path / name))
        assert sorted(Path(t.path).name for t in again) == sorted(BROKEN), name
    t_sum = tann.run_image_annotate(tann.ImagePipelineArgs(input_path=str(corpus), output_path=str(tmp_path / "port"),
                                                           device="cpu"), runner=SequentialRunner())
    assert (t_sum["num_images"], t_sum["num_embedded"], t_sum["num_errors"]) == (2, 0, 2)
    assert sorted(Path(t.path).name for t in tann.discover_image_tasks(str(corpus), str(tmp_path / "port"))) == \
        sorted(BROKEN)
    assert [Path(t.path).name for t in tann.discover_image_tasks(str(corpus), limit=3)] == [
        Path(t.path).name for t in jann.discover_image_tasks(str(corpus), limit=3)]


def test_load_stage_decodes_every_case_like_jax(corpus):
    paths = sorted(p for p in corpus.iterdir() if p.suffix != ".txt")
    for j, t in zip(_loaded(jann, paths), _loaded(tann, paths), strict=True):
        assert (t.width, t.height, t.raw_bytes) == (j.width, j.height, j.raw_bytes)
        assert t.errors.keys() == j.errors.keys()
        if j.pixels is None:
            assert t.pixels is None and "load" in t.errors
        else:
            assert t.pixels.dtype == np.uint8 and t.pixels.shape == (t.height, t.width, 3)
            np.testing.assert_array_equal(t.pixels, j.pixels)


def test_writer_matches_jax_byte_for_byte(tmp_path):
    rng = np.random.default_rng(9)

    def tasks(mod):
        return [
            mod.ImageTask(path="/data/a.JPG", raw_bytes=b"abc", width=4, height=3, embedding=rng.standard_normal(8),
                          aesthetic_score=0.25, caption="a cat", label="photo", semantic_pass=True),
            mod.ImageTask(path="/data/b", raw_bytes=b"def", filtered_by="semantic", semantic_pass=False),
            mod.ImageTask(path="/data/c.png", errors={"load": "undecodable image"}),
        ]

    jann.ImageWriterStage(str(tmp_path / "jax")).process_data(tasks(jann))
    rng = np.random.default_rng(9)
    tann.ImageWriterStage(str(tmp_path / "port")).process_data(tasks(tann))
    j_out, t_out = read_output(tmp_path / "jax"), read_output(tmp_path / "port")
    assert t_out["files"] == j_out["files"]
    assert sorted(t_out["files"]) == sorted(
        [f"metas/{hashlib.sha256(p.encode()).hexdigest()[:24]}.json" for p in ("/data/a.JPG", "/data/b",
                                                                                   "/data/c.png")]
        + [f"processed_images/{hashlib.sha256(p.encode()).hexdigest()[:24]}.json" for p in ("/data/a.JPG",
                                                                                                "/data/b")]
        + [f"images/{hashlib.sha256(b'/data/a.JPG').hexdigest()[:24]}.jpg"])
    assert {k: v.tolist() for k, v in t_out["rows"].items()} == {k: v.tolist() for k, v in j_out["rows"].items()}


def test_run_image_annotate_defaults_to_the_gpu(corpus, tmp_path):
    args = tann.ImagePipelineArgs(input_path=str(corpus), output_path=str(tmp_path))
    assert args.device == "cuda"
    stages = None
    if torch.cuda.is_available():
        stages = tann.assemble_stages(args)
        assert all(s.model.device.type == "cuda" for s in stages if s.model is not None)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tann.run_image_annotate(args)
    stages = tann.assemble_stages(dataclasses.replace(args, device="cpu", aesthetic_threshold=0.0, captioning=True,
                                                      semantic_filter="enable", classifier_labels=("a", "b")))
    assert [s.name for s in stages] == ["ImageLoadStage", "ImageEmbeddingStage", "ImageAestheticFilterStage",
                                        "ImageSemanticFilterStage", "ImageClassifierStage", "ImageCaptionStage",
                                        "ImageWriterStage"]
    assert all(s.model.device.type == "cpu" and not s.resources.uses_gpu for s in stages if s.model is not None)
