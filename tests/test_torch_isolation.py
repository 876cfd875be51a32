"""The port stands alone: importing every module of ``cosmos_curate_tpu_torch``
loads no JAX, no flax and nothing of the JAX package, and its entry points
run on the GPU unless the caller asks for the CPU."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from tests.fixtures.observability import observability_state  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
# the remote storage layer and the host utilities it uses (host code: the
# streaming engine's CPU workers, which import no torch, read and write
# object stores through it)
STORAGE_MODULES = ("storage.client", "storage.retry", "storage.writers", "storage.sigv4", "storage.s3_rest",
                   "storage.s3", "storage.azure_shared_key", "storage.azure_rest", "storage.gcs_rest", "storage.gcs",
                   "storage.zip_transport", "utils.user_config", "utils.retry", "utils.file_lock")


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
        print(" ".join(names))
        sys.exit(1 if bad else 0)
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    n_modules = int(lines[0].split()[0])
    assert n_modules >= 148
    names = set(lines[1].split())
    for module in ("models.clip", "models.internvideo2", "models.transnetv2", "pipelines.video.stages.aesthetic_filter",
                   "pipelines.video.stages.shot_detection", "models.vlm.vision_qwen", "models.vlm.chat",
                   "models.ocr", "pipelines.video.stages.artificial_text_filter",
                   "pipelines.video.stages.semantic_filter", "pipelines.video.stages.enhance_caption",
                   "engine.autoscaler", "utils.health", "models.t5", "models.clip_text",
                   "pipelines.video.stages.caption_embedding", "pipelines.video.stages.preview", "dedup.kmeans",
                   "pipelines.video.dedup", "pipelines.video.shard", "dataset.dimensions", "dataset.webdataset",
                   "dedup.index_store", "dedup.corpus_index", "dedup.index_server", "dedup.compaction",
                   "pipelines.video.stages.dedup_stage", "models.tracker", "models.tracker_learned",
                   "models.super_resolution", "models.diffusion_sr", "video.motion_vectors",
                   "pipelines.video.stages.motion_filter", "pipelines.video.stages.tracking",
                   "pipelines.video.stages.per_event_caption", "pipelines.video.stages.super_resolution",
                   "storage.retry", "utils.config", "pipelines.image.annotate", "pipelines.image.filters",
                   "pipelines.image.api_caption", "pipelines.examples.hello_world",
                   "pipelines.examples.chunking_demo", "cli.main", "cli.local_cli", "cli.index_cli",
                   "observability.tracing", "observability.stage_timer", "observability.anomaly",
                   "observability.live_status", "observability.artifacts", "observability.flight_recorder",
                   "observability.profiling", "observability.stage_replay", "observability.stage_compare",
                   "engine.object_store", "engine.worker", "engine.pool", "engine.runner", "core.map_runner",
                   "data.lazy", "cli.report_cli", "cli.top_cli", "cli.dlq_cli",
                   "pipelines.video.stages.caption_prep", *STORAGE_MODULES):
        assert f"cosmos_curate_tpu_torch.{module}" in names, module


def test_observability_layer_imports_neither_torch_nor_jax():
    """The port's observability layer is host code, as the reference's is:
    importing every module of it (and the storage client it writes through)
    loads no torch and no JAX."""
    script = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import cosmos_curate_tpu_torch.observability as obs
        names = [m.name for m in pkgutil.walk_packages(obs.__path__, obs.__name__ + ".")]
        for name in names + ["cosmos_curate_tpu_torch.storage.client", "cosmos_curate_tpu_torch.storage.retry"]:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "flax", "cosmos_curate_tpu"))
        print(len(names), bad)
        sys.exit(1 if bad or not names else 0)
        """
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) == 9  # profiling, stage_replay and stage_compare joined the six


def test_storage_layer_imports_neither_torch_nor_jax():
    """Every module of the storage package and the host utilities it uses
    (user config, retry, file lock) import no torch, no JAX and nothing of
    the JAX package."""
    script = textwrap.dedent(
        f"""
        import importlib, pkgutil, sys
        import cosmos_curate_tpu_torch.storage as storage
        names = [m.name for m in pkgutil.walk_packages(storage.__path__, storage.__name__ + ".")]
        names += ["cosmos_curate_tpu_torch." + m for m in {STORAGE_MODULES!r}]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "flax", "cosmos_curate_tpu"))
        print(len(set(names)), bad)
        sys.exit(1 if bad else 0)
        """
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) == len(STORAGE_MODULES)


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


@pytest.mark.parametrize("entry", ["clip", "aesthetic", "iv2", "transnet", "aesthetic_stage", "shot_stage"])
def test_canonical_models_default_to_the_gpu(entry):
    import torch

    from cosmos_curate_tpu_torch.models.clip import CLIPAestheticScorer, CLIPImageEmbeddings
    from cosmos_curate_tpu_torch.models.internvideo2 import IV2_TINY_TEST, IV2Embedder
    from cosmos_curate_tpu_torch.models.transnetv2 import TransNetV2
    from cosmos_curate_tpu_torch.pipelines.video.stages.aesthetic_filter import AestheticFilterStage
    from cosmos_curate_tpu_torch.pipelines.video.stages.shot_detection import TransNetV2ClipExtractionStage

    make = {
        "clip": lambda **kw: CLIPImageEmbeddings(**kw).device,
        "aesthetic": lambda **kw: CLIPAestheticScorer(**kw).device,
        "iv2": lambda **kw: IV2Embedder(IV2_TINY_TEST, **kw).device,
        "transnet": lambda **kw: TransNetV2(**kw).device,
        "aesthetic_stage": lambda **kw: AestheticFilterStage(**kw).model.device,
        "shot_stage": lambda **kw: TransNetV2ClipExtractionStage(**kw).model.device,
    }[entry]
    if torch.cuda.is_available():
        assert make().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert make(device="cpu").type == "cpu"


@pytest.mark.parametrize("entry", ["engine_qwen2vl_2b", "engine_qwen25vl_7b", "stage_qwen2vl_2b",
                                   "stage_qwen25vl_7b", "stage_qwen_chat_tiny"])
def test_qwen_caption_entry_points_default_to_the_gpu(entry):
    import torch

    from cosmos_curate_tpu_torch.models.vlm import CaptionEngine
    from cosmos_curate_tpu_torch.models.vlm.model import VLM_QWEN2_2B, VLM_QWEN25_7B
    from cosmos_curate_tpu_torch.pipelines.video.stages.captioning import CaptionStage

    make = {
        "engine_qwen2vl_2b": lambda **kw: CaptionEngine(VLM_QWEN2_2B, **kw).device,
        "engine_qwen25vl_7b": lambda **kw: CaptionEngine(VLM_QWEN25_7B, **kw).device,
        "stage_qwen2vl_2b": lambda **kw: CaptionStage(model_flavor="qwen2vl-2b", **kw).model.device,
        "stage_qwen25vl_7b": lambda **kw: CaptionStage(model_flavor="qwen25vl-7b", **kw).model.device,
        "stage_qwen_chat_tiny": lambda **kw: CaptionStage(model_flavor="qwen-chat-tiny-test", **kw).model.device,
    }[entry]
    if torch.cuda.is_available():
        assert make().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert make(device="cpu").type == "cpu"


@pytest.mark.parametrize("model", ["vlm_qwen2vl_2b", "vlm_qwen25vl_7b", "tower_qwen2", "tower_qwen25"])
def test_qwen_models_build_every_parameter_on_the_context_device(model):
    """The Qwen caption models at full width, built on ``meta`` (no memory):
    every parameter on the context device, none left on the CPU."""
    import torch

    from cosmos_curate_tpu_torch.models.vlm.model import VLM, VLM_QWEN2_2B, VLM_QWEN25_7B
    from cosmos_curate_tpu_torch.models.vlm.vision_qwen import (
        QWEN2_VL_2B_VISION,
        QWEN25_VL_7B_VISION,
        QwenVisionTower,
    )

    build = {
        "vlm_qwen2vl_2b": lambda: VLM(VLM_QWEN2_2B),
        "vlm_qwen25vl_7b": lambda: VLM(VLM_QWEN25_7B),
        "tower_qwen2": lambda: QwenVisionTower(QWEN2_VL_2B_VISION),
        "tower_qwen25": lambda: QwenVisionTower(QWEN25_VL_7B_VISION),
    }[model]
    with torch.device("meta"):
        module = build()
    assert {p.device.type for p in module.state_dict().values()} == {"meta"}


@pytest.mark.parametrize("entry", ["engine_qwen3vl_moe_a3b", "engine_qwen3moe_a3b_lm", "stage_qwen3vl_moe_a3b",
                                   "stage_qwen3moe_a3b_lm", "stage_qwen3moe_tiny"])
def test_qwen3_caption_entry_points_default_to_the_gpu(entry):
    import torch

    from cosmos_curate_tpu_torch.models.vlm import CaptionEngine
    from cosmos_curate_tpu_torch.models.vlm.model import VLM_QWEN3_MOE_A3B, VLM_QWEN3_VL_MOE_A3B
    from cosmos_curate_tpu_torch.pipelines.video.stages.captioning import CaptionStage

    make = {
        "engine_qwen3vl_moe_a3b": lambda **kw: CaptionEngine(VLM_QWEN3_VL_MOE_A3B, **kw).device,
        "engine_qwen3moe_a3b_lm": lambda **kw: CaptionEngine(VLM_QWEN3_MOE_A3B, **kw).device,
        "stage_qwen3vl_moe_a3b": lambda **kw: CaptionStage(model_flavor="qwen3vl-moe-a3b", **kw).model.device,
        "stage_qwen3moe_a3b_lm": lambda **kw: CaptionStage(model_flavor="qwen3moe-a3b-lm", **kw).model.device,
        "stage_qwen3moe_tiny": lambda **kw: CaptionStage(model_flavor="qwen3moe-tiny-test", **kw).model.device,
    }[entry]
    if torch.cuda.is_available():
        assert make().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert make(device="cpu").type == "cpu"


@pytest.mark.parametrize("model", ["vlm_qwen3vl_moe_a3b", "vlm_qwen3moe_a3b_lm", "tower_qwen3"])
def test_qwen3_models_build_every_parameter_on_the_context_device(model):
    """The Qwen3 models at full width on ``meta``: every parameter (the
    bf16 experts and the pos-embed table too) on the context device."""
    import torch

    from cosmos_curate_tpu_torch.models.vlm.model import VLM, VLM_QWEN3_MOE_A3B, VLM_QWEN3_VL_MOE_A3B
    from cosmos_curate_tpu_torch.models.vlm.vision_qwen import QWEN3_VL_MOE_VISION, QwenVisionTower

    build = {
        "vlm_qwen3vl_moe_a3b": lambda: VLM(VLM_QWEN3_VL_MOE_A3B),
        "vlm_qwen3moe_a3b_lm": lambda: VLM(VLM_QWEN3_MOE_A3B),
        "tower_qwen3": lambda: QwenVisionTower(QWEN3_VL_MOE_VISION),
    }[model]
    with torch.device("meta"):
        module = build()
    assert {p.device.type for p in module.state_dict().values()} == {"meta"}


def test_native_writer_builds_from_the_port_source_into_the_repo_build_dir():
    """The port's H.264 writer is built from its own copy of the source into
    ``<repo>/build/native/`` and never loads the JAX package's library (nor
    any module of the JAX package)."""
    script = textwrap.dedent(
        """
        import json, sys
        from cosmos_curate_tpu_torch import native
        from cosmos_curate_tpu_torch.video.h264 import h264_available, h264_status
        ok = h264_available()
        with open("/proc/self/maps") as f:
            mapped = sorted({line.split()[-1] for line in f if "/libcurate" in line})
        print(json.dumps({"build_dir": str(native.BUILD_DIR), "source": str(native.SOURCE), "ok": ok,
                          "status": h264_status(), "mapped": mapped,
                          "reference": sorted(m for m in sys.modules if m.startswith("cosmos_curate_tpu."))}))
        """
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.splitlines()[-1])
    build_dir = REPO / "build" / "native"
    assert Path(got["build_dir"]) == build_dir
    assert Path(got["source"]) == REPO / "cosmos_curate_tpu_torch" / "native" / "h264_encoder.c"
    assert got["status"] == "available" if got["ok"] else got["status"].startswith("unavailable: ")
    assert all(Path(lib).parent == build_dir and Path(lib).name.startswith("libcurate_h264-") for lib in got["mapped"])
    assert bool(got["mapped"]) == got["ok"]
    assert got["reference"] == []


def test_native_writer_rebuilds_a_cached_library_that_does_not_load(tmp_path, monkeypatch):
    """A cached library that fails to load (one built on another host and
    copied with the tree) is rebuilt here, so ``h264_error()`` reports this
    host's reason, never the stale file's load error."""
    import hashlib

    from cosmos_curate_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    tag = hashlib.sha256(native.SOURCE.read_bytes()).hexdigest()[:16]
    stale = tmp_path / f"libcurate_h264-{tag}.so"
    stale.write_bytes(b"not a shared object")
    lib = native.load_h264()
    if lib is None:
        assert "invalid ELF header" not in native.h264_error()
        assert not stale.exists()
    else:
        assert native.h264_error() is None
        assert stale.read_bytes()[:4] == b"\x7fELF"


@pytest.mark.parametrize("model", ["clip", "aesthetic_mlp", "iv2", "transnet"])
def test_canonical_models_build_every_parameter_on_the_context_device(model):
    """A model built under ``torch.device(d)`` holds every parameter on d
    (the stages build theirs that way on the card); checked on ``meta``."""
    import torch

    from cosmos_curate_tpu_torch.models.clip import _CONFIGS, AestheticMLP, CLIPImageModel
    from cosmos_curate_tpu_torch.models.internvideo2 import IV2_TINY_TEST, InternVideo2Tower
    from cosmos_curate_tpu_torch.models.transnetv2 import TRANSNET_TINY_TEST, TransNet

    build = {
        "clip": lambda: CLIPImageModel(_CONFIGS["clip-vit-tiny-test"]),
        "aesthetic_mlp": lambda: AestheticMLP(32),
        "iv2": lambda: InternVideo2Tower(IV2_TINY_TEST),
        "transnet": lambda: TransNet(TRANSNET_TINY_TEST),
    }[model]
    with torch.device("meta"):
        module = build()
    assert {p.device.type for p in module.state_dict().values()} == {"meta"}


@pytest.mark.parametrize("entry", ["ocr", "text_filter", "semantic_filter", "enhance_caption"])
def test_filter_entry_points_default_to_the_gpu(entry):
    import torch

    from cosmos_curate_tpu_torch.models.ocr import OcrModel
    from cosmos_curate_tpu_torch.pipelines.video.stages.artificial_text_filter import ArtificialTextFilterStage
    from cosmos_curate_tpu_torch.pipelines.video.stages.enhance_caption import EnhanceCaptionStage
    from cosmos_curate_tpu_torch.pipelines.video.stages.semantic_filter import SemanticFilterStage

    make = {
        "ocr": lambda **kw: OcrModel(**kw).device,
        "text_filter": lambda **kw: ArtificialTextFilterStage(**kw).device,
        "semantic_filter": lambda **kw: SemanticFilterStage(model_flavor="tiny-test", **kw).model.device,
        "enhance_caption": lambda **kw: EnhanceCaptionStage(model_flavor="tiny-test", **kw).model.device,
    }[entry]
    if torch.cuda.is_available():
        assert make().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert make(device="cpu").type == "cpu"


@pytest.mark.parametrize("option", [dict(text_filter="enable"), dict(text_filter="score-only"),
                                    dict(semantic_filter="enable", caption_model="tiny-test"),
                                    dict(captioning=True, caption_model="tiny-test", enhance_captions=True)])
def test_run_split_with_the_filters_defaults_to_the_gpu(option, tmp_path):
    """``run_split`` with a filter or enhanced captions and no ``device``:
    the stages are built for the card, so without one the run refuses
    before it starts, never falling back to the CPU."""
    import torch

    from cosmos_curate_tpu_torch.core.runner import SequentialRunner
    from cosmos_curate_tpu_torch.pipelines.video import split

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    (tmp_path / "in").mkdir()
    args = split.SplitPipelineArgs(input_path=str(tmp_path / "in"), output_path=str(tmp_path / "out"), **option)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        split.run_split(args, runner=SequentialRunner())
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("model", ["detector", "recognizer"])
def test_ocr_models_build_every_parameter_on_the_context_device(model):
    import torch

    from cosmos_curate_tpu_torch.models.ocr import TextDetector, TextRecognizer

    with torch.device("meta"):
        module = {"detector": TextDetector, "recognizer": TextRecognizer}[model]()
    assert {p.device.type for p in module.state_dict().values()} == {"meta"}


@pytest.mark.parametrize("entry", ["t5", "caption_embedding_stage", "clip_text", "kmeans_fit", "semantic_dedup",
                                   "run_dedup"])
def test_caption_embedding_and_dedup_entry_points_default_to_the_gpu(entry, tmp_path):
    """Each new entry point takes the card unless told otherwise: without
    CUDA it raises before doing any work; with ``device="cpu"`` it runs the
    plain versions."""
    import numpy as np
    import torch

    from cosmos_curate_tpu_torch.dedup.kmeans import kmeans_fit, semantic_dedup
    from cosmos_curate_tpu_torch.models.clip_text import CLIPTextEmbeddings
    from cosmos_curate_tpu_torch.models.t5 import T5_TINY_TEST, T5EncoderTPU
    from cosmos_curate_tpu_torch.pipelines.video.dedup import DedupPipelineArgs, run_dedup
    from cosmos_curate_tpu_torch.pipelines.video.stages.caption_embedding import CaptionEmbeddingStage

    x = np.eye(4, dtype=np.float32)
    make = {
        "t5": lambda **kw: T5EncoderTPU(T5_TINY_TEST, **kw).device,
        "caption_embedding_stage": lambda **kw: CaptionEmbeddingStage(cfg=T5_TINY_TEST, **kw).model.device,
        "clip_text": lambda **kw: CLIPTextEmbeddings("clip-text-tiny-test", **kw).device,
        "kmeans_fit": lambda **kw: kmeans_fit(x, 2, **kw),
        "semantic_dedup": lambda **kw: semantic_dedup(x, list("abcd"), **kw),
        "run_dedup": lambda **kw: run_dedup(DedupPipelineArgs(input_path=str(tmp_path / "none"), **kw)),
    }[entry]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    if entry == "run_dedup":
        with pytest.raises(FileNotFoundError):  # it gets as far as reading the (absent) embeddings
            make(device="cpu")
    elif entry in ("kmeans_fit", "semantic_dedup"):
        make(device="cpu")
    else:
        assert make(device="cpu").type == "cpu"


@pytest.mark.parametrize("option", [dict(t5_embeddings=True), dict(captioning=True, caption_model="tiny-test",
                                                                   t5_embeddings=True, previews=True)])
def test_run_split_with_t5_embeddings_defaults_to_the_gpu(option, tmp_path):
    import torch

    from cosmos_curate_tpu_torch.core.runner import SequentialRunner
    from cosmos_curate_tpu_torch.pipelines.video import split

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    (tmp_path / "in").mkdir()
    args = split.SplitPipelineArgs(input_path=str(tmp_path / "in"), output_path=str(tmp_path / "out"), **option)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        split.run_split(args, runner=SequentialRunner())
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("model", ["t5", "clip_text"])
def test_text_encoders_build_every_parameter_on_the_context_device(model):
    import torch

    from cosmos_curate_tpu_torch.models.clip_text import CLIP_TEXT_L, CLIPTextEncoder
    from cosmos_curate_tpu_torch.models.t5 import T5_SMALL, T5Encoder

    with torch.device("meta"):
        module = {"t5": lambda: T5Encoder(T5_SMALL), "clip_text": lambda: CLIPTextEncoder(CLIP_TEXT_L)}[model]()
    assert {p.device.type for p in module.state_dict().values()} == {"meta"}


@pytest.mark.parametrize("entry", ["corpus_index_open", "corpus_index_build", "consolidate_index", "index_server",
                                   "compact_index", "compaction_thread", "dedup_stage"])
def test_corpus_index_entry_points_default_to_the_gpu(entry, tmp_path):
    """Every entry point of the corpus index takes the card unless told
    otherwise: without CUDA it raises before doing any work; with
    ``device="cpu"`` it runs the plain products."""
    import numpy as np
    import torch

    from cosmos_curate_tpu_torch.dedup.compaction import CompactionThread, compact_index
    from cosmos_curate_tpu_torch.dedup.corpus_index import CorpusIndex, consolidate_index
    from cosmos_curate_tpu_torch.dedup.index_server import IndexServer
    from cosmos_curate_tpu_torch.pipelines.video.stages.dedup_stage import IncrementalDedupStage

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    root = str(tmp_path / "index")
    x = np.eye(4, dtype=np.float32)
    make = {
        "corpus_index_open": lambda **kw: CorpusIndex.open(root, **kw).device,
        "corpus_index_build": lambda **kw: CorpusIndex.build(str(tmp_path / "other"), list("abcd"), x, k=2,
                                                             **kw).device,
        "consolidate_index": lambda **kw: consolidate_index(str(tmp_path / "empty"), **kw),
        "index_server": lambda **kw: IndexServer(root, warmup=False, **kw),
        "compact_index": lambda **kw: compact_index(root, **kw),
        "compaction_thread": lambda **kw: CompactionThread(root, **kw).device,
        "dedup_stage": lambda **kw: IncrementalDedupStage(root, **kw).device,
    }[entry]
    if entry != "corpus_index_build":
        CorpusIndex.build(root, list("abcd"), x, k=2, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    got = make(device="cpu")
    if entry == "index_server":
        got.close()
    elif entry in ("corpus_index_open", "corpus_index_build", "compaction_thread", "dedup_stage"):
        assert got.type == "cpu"


LEG_ENTRIES = ["ncc_tracker", "siamese_tracker", "tracking_stage", "motion_filter", "srnet_model", "diffusion_model",
               "sr_stage", "sr_stage_srnet", "per_event_caption"]


@pytest.mark.parametrize("entry", LEG_ENTRIES)
def test_split_leg_entry_points_default_to_the_gpu(entry):
    import torch

    from cosmos_curate_tpu_torch.models.diffusion_sr import DIFF_SR_TINY_TEST, DiffusionSRModel
    from cosmos_curate_tpu_torch.models.super_resolution import SR_TINY_TEST, SuperResolutionModel
    from cosmos_curate_tpu_torch.models.tracker import TemplateTracker
    from cosmos_curate_tpu_torch.models.tracker_learned import SiameseTracker
    from cosmos_curate_tpu_torch.pipelines.video.stages.motion_filter import MotionFilterStage
    from cosmos_curate_tpu_torch.pipelines.video.stages.per_event_caption import PerEventCaptionStage
    from cosmos_curate_tpu_torch.pipelines.video.stages.super_resolution import SuperResolutionStage
    from cosmos_curate_tpu_torch.pipelines.video.stages.tracking import TrackingStage

    make = {
        "ncc_tracker": lambda **kw: TemplateTracker(**kw).device,
        "siamese_tracker": lambda **kw: SiameseTracker(**kw).device,
        "tracking_stage": lambda **kw: TrackingStage(**kw).device,
        "motion_filter": lambda **kw: MotionFilterStage(**kw).device,
        "srnet_model": lambda **kw: SuperResolutionModel(SR_TINY_TEST, **kw).device,
        "diffusion_model": lambda **kw: DiffusionSRModel(DIFF_SR_TINY_TEST, **kw).device,
        "sr_stage": lambda **kw: SuperResolutionStage(**kw).model.device,
        "sr_stage_srnet": lambda **kw: SuperResolutionStage(variant="srnet", **kw).model.device,
        "per_event_caption": lambda **kw: PerEventCaptionStage(model_flavor="tiny-test", **kw).model.device,
    }[entry]
    if torch.cuda.is_available():
        assert make().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert make(device="cpu").type == "cpu"


@pytest.mark.parametrize("model", ["srnet", "denoiser", "embed_net"])
def test_split_leg_models_build_every_parameter_on_the_context_device(model):
    """The SR nets at their base widths and the siamese tower, built on
    ``meta``: every parameter on the context device."""
    import torch

    from cosmos_curate_tpu_torch.models.diffusion_sr import DIFF_SR_BASE, DenoiserUNet
    from cosmos_curate_tpu_torch.models.super_resolution import SR_BASE, SRNet
    from cosmos_curate_tpu_torch.models.tracker_learned import EmbedNet

    build = {"srnet": lambda: SRNet(SR_BASE), "denoiser": lambda: DenoiserUNet(DIFF_SR_BASE),
             "embed_net": lambda: EmbedNet(32)}[model]
    with torch.device("meta"):
        module = build()
    assert {p.device.type for p in module.state_dict().values()} == {"meta"}


@pytest.mark.parametrize("option", [dict(sr=True), dict(motion_filter="enable"), dict(tracking=True),
                                    dict(per_event_captions=True)])
def test_run_split_with_the_legs_defaults_to_the_gpu(option, tmp_path):
    import torch

    from cosmos_curate_tpu_torch.core.runner import SequentialRunner
    from cosmos_curate_tpu_torch.pipelines.video import split

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    args = split.SplitPipelineArgs(input_path=str(tmp_path / "in"), output_path=str(tmp_path / "out"), **option)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        split.run_split(args, runner=SequentialRunner())
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("script", ["chip_smoke.py", "scripts/engine_phase.py", "scripts/observe_phase.py"])
def test_chip_scripts_import_neither_jax_nor_the_reference(script):
    """The card's scripts run the port alone: no import of jax, flax or the
    JAX package anywhere in them (the card's machine has no jax)."""
    import ast

    tree = ast.parse((REPO / script).read_text())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import) for a in node.names]
    names += [node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom) and node.module]
    bad = [n for n in names if n.split(".")[0] in ("jax", "flax", "cosmos_curate_tpu")]
    assert not bad, bad
    assert any(n.startswith("cosmos_curate_tpu_torch") for n in names) or script == "scripts/observe_phase.py"


def test_engine_workers_import_no_jax_and_claim_no_card():
    """What a spawned CPU worker of the streaming engine loads: the worker
    module, the split's host stages (no torch, so a worker starts in about
    a second) and its environment, which hides the cards."""
    script = textwrap.dedent(
        """
        import sys
        from cosmos_curate_tpu_torch.engine import pool, worker
        import cosmos_curate_tpu_torch.core.map_runner
        # the split's host stages: their workers start without torch
        from cosmos_curate_tpu_torch.pipelines.video.stages import (caption_prep, clip_extraction, download,
                                                                    frame_extraction, writer)
        env = pool._base_worker_env()
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "cosmos_curate_tpu", "torch"))
        print(env["CUDA_VISIBLE_DEVICES"] == "", bad)
        sys.exit(1 if bad or env["CUDA_VISIBLE_DEVICES"] != "" else 0)
        """
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("runner", ["streaming", "map"])
def test_run_split_through_the_engine_runners_defaults_to_the_gpu(runner, tmp_path, monkeypatch):
    """``CURATE_RUNNER=streaming|map`` with a model stage and no ``device``:
    the stages are built for the card, so without one the run refuses
    before any worker starts."""
    import torch

    from cosmos_curate_tpu_torch.pipelines.video import split

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    monkeypatch.setenv("CURATE_RUNNER", runner)
    (tmp_path / "in").mkdir()
    args = split.SplitPipelineArgs(input_path=str(tmp_path / "in"), output_path=str(tmp_path / "out"),
                                   embedding_model="video")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        split.run_split(args)
