"""Port parity: the command line (``cli/main.py``, ``local_cli.py``,
``index_cli.py``) and ``utils/config.py`` on the CPU.

- ``load_pipeline_config``: the same results (list -> tuple coercion) and
  the same errors as the reference's, JSON and YAML.
- The parser walk: the ``local`` (``merge-summaries`` and ``av`` included),
  ``postgres``, ``index``, ``dlq`` and ``slurm`` groups of both parsers,
  subcommand by subcommand, and the ``report``, ``top``, ``agent``, ``view``,
  ``export-lance`` and ``serve`` commands, action by action (option strings,
  dest, default, choices, required, nargs, type, const, action class); the
  only difference allowed is the port's ``--device``; the reference's
  ``image`` / ``deploy`` and ``lint`` are the only groups the port lacks
  (``models`` is walked here too; its actions in
  ``tests/test_torch_models_cli.py``). ``local merge-summaries`` prints and writes what the
  JAX CLI's does on the same per-node summaries and sidecars.
- ``main``'s exit codes (2 with no command or on ``FileNotFoundError``, 130
  on an interrupt) in both packages; every refusal raises
  ``NotImplementedError`` naming its ROADMAP item, and the lifted ones
  (``local av``, ``split --multicam``) raise what the reference raises
  where they cannot run, writing nothing.
- The commands end to end on the CPU (``--device cpu``), each against the
  JAX CLI given the same argv and inputs: ``local hello``, ``local
  image-annotate`` (the image path's tiny towers from
  ``test_torch_image_pipeline.py``), ``local split --config`` (fixed
  stride), ``local shard`` of that split, ``local dedup``, and ``index
  build`` and ``query``; the printed summaries without what the clock or
  the output path decides (nor the port's ``ops`` and ``cache`` counters
  in the index's stats), and the output files; ``local av``'s seven steps
  on the sessions of ``tests/test_torch_av_pipeline.py``, with that test's
  models and tolerances (captions by the engine rule, the state rows and
  annotation files equal once run ids are normalised); ``report``, ``top --once``
  (a run directory, and a fake job service on a local port) and ``dlq
  list|show|requeue`` through both command lines on the same run
  directory and dead-letter queue; ``export-lance`` with ``lance`` absent
  and with a stand-in module (the same exit codes, stdout and stderr).
  Split, dedup and every
  ``index`` action are also held against the port's own entry points
  called directly. Where bytes differ for a reason outside the port, the
  test says which: a split clip's mp4 is x264's, which differs between two
  runs of the same package, so clips compare by name; dedup's CSV rows
  come in k-means cluster order, whose first pick differs between the
  packages, so they compare as sets.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import subprocess
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest

from cosmos_curate_tpu.cli import local_cli as jlocal
from cosmos_curate_tpu.cli import main as jmain
from cosmos_curate_tpu.utils import config as jconfig
from cosmos_curate_tpu.video import h264 as jh264
from cosmos_curate_tpu_torch.cli import local_cli as tlocal
from cosmos_curate_tpu_torch.cli import main as tmain
from cosmos_curate_tpu_torch.core.runner import SequentialRunner
from cosmos_curate_tpu_torch.dedup.corpus_index import CorpusIndex, incremental_dedup
from cosmos_curate_tpu_torch.models.vlm.model import VLM_FLAVORS
from cosmos_curate_tpu_torch.pipelines.video import dedup as tdedup
from cosmos_curate_tpu_torch.pipelines.video import shard as tshard
from cosmos_curate_tpu_torch.pipelines.video import split as tsplit
from cosmos_curate_tpu_torch.utils import config as tconfig
from cosmos_curate_tpu_torch.video import h264 as th264
from tests.fixtures.media import make_scene_video
from tests.fixtures.observability import observability_state  # noqa: F401  (autouse)
from tests.test_torch_dedup import planted, write_split_embeddings
from tests.test_torch_image_pipeline import corpus, fp32, read_output, tiny_path, tiny_weights  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


# -- load_pipeline_config ------------------------------------------------------


@dataclasses.dataclass
class _Args:
    name: str = ""
    rate: float = 1.0
    sizes: tuple[int, ...] = ()
    flags: list = dataclasses.field(default_factory=list)


@pytest.mark.parametrize("suffix,text", [
    (".json", '{"name": "a", "sizes": [1, 2], "flags": [true]}'),
    (".yaml", "name: b\nrate: 2.5\nsizes: [3]\n"),
    (".yml", "{}"),
    (".json", '{"name": "a", "bogus": 1, "other": 2}'),
    (".json", "[1, 2]"),
    (".yaml", "- 1\n"),
], ids=["json", "yaml", "yml-empty", "unknown-keys", "json-list", "yaml-list"])
def test_load_pipeline_config_matches_jax(suffix, text, tmp_path):
    path = tmp_path / f"cfg{suffix}"
    path.write_text(text)
    results = []
    for mod in (jconfig, tconfig):
        try:
            results.append(("ok", mod.load_pipeline_config(str(path), _Args)))
        except ValueError as e:
            results.append(("error", str(e)))
    assert results[1] == results[0]
    if results[1][0] == "ok":
        assert isinstance(results[1][1].sizes, tuple) and isinstance(results[1][1].flags, list)


def test_split_config_loads_like_jax(tmp_path):
    from cosmos_curate_tpu.pipelines.video import split as jsplit

    path = tmp_path / "split.json"
    path.write_text(json.dumps({"input_path": "in", "output_path": "out", "extract_fps": [2.0, 4.0],
                                "embedding_model": "clip", "captioning": True}))
    got = dataclasses.asdict(tconfig.load_pipeline_config(str(path), tsplit.SplitPipelineArgs))
    want = dataclasses.asdict(jconfig.load_pipeline_config(str(path), jsplit.SplitPipelineArgs))
    assert got.pop("device") == "cuda"
    assert got == {k: v for k, v in want.items() if k in got} and got["extract_fps"] == (2.0, 4.0)
    with pytest.raises(FileNotFoundError):
        tconfig.load_pipeline_config(str(tmp_path / "missing.json"), tsplit.SplitPipelineArgs)


# -- the parser walk -------------------------------------------------------------


def _subcommands(parser: argparse.ArgumentParser) -> dict[str, argparse.ArgumentParser]:
    return next(a.choices for a in parser._actions if isinstance(a, argparse._SubParsersAction))


def _actions(parser: argparse.ArgumentParser) -> dict[str, tuple]:
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        if isinstance(a, argparse._SubParsersAction):
            out["<sub>"] = (a.dest, sorted(a.choices))
            continue
        choices = tuple(a.choices) if a.choices is not None else None
        out[" ".join(a.option_strings) or a.dest] = (a.dest, a.default, choices, a.required, a.nargs,
                                                    getattr(a.type, "__name__", a.type), a.const,
                                                    type(a).__name__)
    return out


def test_parser_walk_matches_jax():
    jtop, ttop = _subcommands(jmain.build_parser()), _subcommands(tmain.build_parser())
    assert sorted(ttop) == ["agent", "dlq", "export-lance", "index", "info", "lint", "local", "models", "postgres",
                            "report", "serve", "slurm", "top", "view"]
    assert set(ttop) <= set(jtop)
    # the reference's groups the port still lacks (ROADMAP queue A item 23;
    # the reference's cli/image_cli.py registers image and deploy)
    assert set(jtop) - set(ttop) == {"image", "deploy"}
    # registered in the reference's order
    assert list(ttop) == [c for c in jtop if c in ttop]
    assert _actions(tmain.build_parser()).keys() == _actions(jmain.build_parser()).keys() - {"<sub>"} | {"<sub>"}
    walked = 0
    for command in ("report", "top", "agent", "view", "export-lance"):
        assert _actions(ttop[command]) == _actions(jtop[command]), command
        walked += len(_actions(ttop[command]))
    # lint: the reference's flags; its targets default to the port's package
    lint = _actions(ttop["lint"])
    assert lint.pop("paths") == ("paths", ["cosmos_curate_tpu_torch"], None, False, "*", None, None, "_StoreAction")
    want = _actions(jtop["lint"])
    assert want.pop("paths")[1] == ["cosmos_curate_tpu"]
    assert lint == want
    walked += len(lint)
    # serve: the reference's flags and --device (where the search server runs)
    serve = _actions(ttop["serve"])
    assert serve.pop("--device") == ("device", "cuda", ("cuda", "cpu"), False, None, None, None, "_StoreAction")
    assert serve == _actions(jtop["serve"])
    walked += len(serve)
    for group in ("local", "postgres", "index", "dlq", "slurm", "models"):
        jsub, tsub = _subcommands(jtop[group]), _subcommands(ttop[group])
        assert list(tsub) == list(jsub), group
        for name, jparser in jsub.items():
            want, got = _actions(jparser), _actions(tsub[name])
            device = got.pop("--device", None)
            assert got == want, (group, name)
            if device is not None:
                assert device[0] == "device" and device[2] == ("cuda", "cpu") and device[1] in ("cuda", None)
            walked += len(want)
    assert walked > 100
    # --device where a model runs: local hello / split / av /
    # image-annotate / dedup, every index action that opens the index (index
    # serve's search included); not shard, the postgres admin or slurm
    with_device = {(g, n) for g in ("local", "postgres", "index", "slurm") for n, p in _subcommands(ttop[g]).items()
                   if "--device" in _actions(p)}
    assert with_device == {("local", "hello"), ("local", "split"), ("local", "av"), ("local", "image-annotate"),
                           ("local", "dedup"),
                           ("index", "build"), ("index", "add"), ("index", "query"), ("index", "stats"),
                           ("index", "consolidate"), ("index", "compact"), ("index", "serve")}


def test_merge_summaries_matches_jax(tmp_path, capsys):
    """``local merge-summaries`` on the same per-node summaries and node-stats
    sidecars: the same printed and written merge, the same exit code, and
    no run report without spans (as in the reference)."""
    from tests.test_torch_multinode import _summary

    node_stats = {"node-stats-0.json": {"node_rank": 0, "dead_lettered": 1, "stage_times": {"Embed": 1.5},
                                        "stage_counts": {"Embed": {"completed": 3}}, "wall_s": 4.0},
                  "node-stats-1.json": {"node_rank": 1, "dead_lettered": 2, "stage_times": {"Embed": 2.0},
                                        "stage_counts": {"Embed": {"completed": 5}}, "wall_s": 6.0}}
    outs = []
    for name, main in (("jax", jmain), ("torch", tmain)):
        root = tmp_path / name
        (root / "report").mkdir(parents=True)
        (root / "summary.json").write_text(json.dumps(_summary(0)))
        (root / "summary-node1.json").write_text(json.dumps(_summary(1)))
        for fname, doc in node_stats.items():
            (root / "report" / fname).write_text(json.dumps(doc))
        rc = main.main(["local", "merge-summaries", "--output-path", str(root)])
        printed = json.loads(capsys.readouterr().out)
        written = json.loads((root / "summary-merged.json").read_text())
        outs.append((rc, printed, written, (root / "report" / "run_report.json").exists()))
    assert outs[1] == outs[0]
    assert outs[1][0] == 0 and outs[1][1]["num_clips"] == 15 and not outs[1][3]


def test_av_args_mirror_the_reference_field_for_field():
    """``local av``'s config, ``AVPipelineArgs``: the reference's fields in
    its order with its defaults, plus ``device``."""
    from cosmos_curate_tpu.pipelines.av import pipeline as jav
    from cosmos_curate_tpu_torch.pipelines.av import pipeline as tav

    port = {f.name: f.default for f in dataclasses.fields(tav.AVPipelineArgs)}
    ref = {f.name: f.default for f in dataclasses.fields(jav.AVPipelineArgs)}
    assert port.pop("device") == "cuda" and list(port.items()) == list(ref.items())
    assert tav.AV_CAPTION_FPS == jav.AV_CAPTION_FPS
    assert tav.AVPipelineArgs(output_path="o/").resolved_db == jav.AVPipelineArgs(output_path="o/").resolved_db


def test_caption_model_choices_are_the_flavors():
    assert sorted(tlocal.CAPTION_MODEL_CHOICES) == sorted(VLM_FLAVORS)
    assert tlocal.CAPTION_MODEL_CHOICES == jlocal.CAPTION_MODEL_CHOICES


# -- exit codes and refusals -----------------------------------------------------


@pytest.mark.parametrize("argv", [[], ["local"], ["index"]], ids=["none", "local", "index"])
def test_main_without_a_command_exits_2_like_jax(argv, capsys):
    assert tmain.main(argv) == jmain.main(argv) == 2


def test_lint_shard_check_exits_2_naming_the_mesh_layer(capsys):
    """``lint --shard-check`` checks sharded entry points against a JAX mesh;
    the port has no mesh layer before ROADMAP A7, so it refuses (exit 2)
    before linting anything, as the port refuses ``mesh=``."""
    assert tmain.main(["lint", "--shard-check", "--mesh", "data=2,seq=2", "--hbm-gb", "16"]) == 2
    err = capsys.readouterr().err
    assert "ROADMAP queue A item 7" in err and "mesh" in err


def test_main_exit_codes(tmp_path, monkeypatch, capsys):
    missing = str(tmp_path / "missing.json")
    assert tmain.main(["local", "split", "--config", missing, "--device", "cpu"]) == 2
    assert jmain.main(["local", "split", "--config", missing]) == 2
    assert tmain.main(["index", "add", "--input-path", str(tmp_path), "--device", "cpu"]) == 2
    assert "error:" in capsys.readouterr().err
    assert tmain.main(["local", "split", "--input-path", "x", "--output-path", "y", "--sequential",
                       "--runner", "pipelined"]) == 2

    def interrupted(args):
        raise KeyboardInterrupt

    monkeypatch.setattr(tlocal, "_cmd_hello", interrupted)
    assert tmain.main(["local", "hello", "--device", "cpu"]) == 130
    assert "interrupted" in capsys.readouterr().err


@pytest.mark.parametrize("argv,item", [
    (["local", "split", "--runner", "streaming"], "CURATE_ENGINE_TOKEN"),
    (["local", "av", "trajectory", "--db-path", "s3://bucket/av_state.sqlite"], "s3:// storage unavailable"),
    (["local", "merge-summaries"], "no summaries found"),
    (["index", "serve", "--index-path", "x"], "no CUDA device is available"),
    (["local", "split", "--multicam", "--splitting-algorithm", "transnetv2", "--device", "cpu"], "fixed-stride only"),
    (["local", "split", "--sr", "--sr-sp-size", "2", "--device", "cpu"], "item 7"),
], ids=["streaming", "av", "merge-summaries", "index-serve", "multicam", "sr-sp"])
def test_refusals_name_their_roadmap_item(argv, item, tmp_path, monkeypatch, capsys):
    """What is not ported raises, naming its ROADMAP item; the cross-node
    plane refuses to run without its cluster secret, and merge-summaries
    refuses a root with no node summaries (exit 1). The lifted ``local av``
    and ``split --multicam`` raise what the reference raises where they
    cannot run: a remote state database with no credentials (its backend
    names what is missing), a multicam split by shot detection (fixed
    stride only). The lifted ``index serve`` asks for the card unless given
    ``--device cpu``: on a host without one its app refuses to start,
    naming the missing device, and binds no port."""
    if "s3://" in " ".join(argv):
        for var in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY", "AWS_ENDPOINT_URL"):
            monkeypatch.delenv(var, raising=False)
        argv = [*argv, "--device", "cpu"]
    if "streaming" in argv:
        monkeypatch.setenv("CURATE_ENGINE_DRIVER_PORT", "7070")
        monkeypatch.delenv("CURATE_ENGINE_TOKEN", raising=False)
    if argv[:2] in (["local", "split"], ["local", "av"]):
        argv = [*argv, "--input-path", str(tmp_path), "--output-path", str(tmp_path / "out")]
    if argv[:2] == ["local", "merge-summaries"]:
        assert tmain.main([*argv, "--output-path", str(tmp_path)]) == 1
        assert item in capsys.readouterr().out
    elif item in ("CURATE_ENGINE_TOKEN", "s3:// storage unavailable", "no CUDA device is available"):
        if argv[:2] == ["index", "serve"]:
            import torch

            if torch.cuda.is_available():
                pytest.skip("this host has a CUDA device: index serve would start on it")
        with pytest.raises(RuntimeError, match=item):
            tmain.main(argv)
    elif item == "fixed-stride only":
        with pytest.raises(ValueError, match=item):
            tmain.main(argv)
        with pytest.raises(ValueError, match=item):
            j_argv = [a for a in argv[:-2] if a not in ("--device", "cpu")]
            jmain.main([*j_argv, "--output-path", str(tmp_path / "jout")])
    else:
        with pytest.raises(NotImplementedError, match=f"ROADMAP queue A {item}|\\({item}"):
            tmain.main(argv)
    assert not (tmp_path / "out").exists()


def test_python_dash_m_runs_the_port(tmp_path):
    out = subprocess.run([sys.executable, "-m", "cosmos_curate_tpu_torch.cli.main", "info"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("cosmos-curate-tpu-torch 0.1.0\n") and "torch " in out.stdout
    # index serve asks for the card: a host without one refuses it
    import torch

    if torch.cuda.is_available():
        return
    refused = subprocess.run([sys.executable, "-m", "cosmos_curate_tpu_torch.cli.main", "index", "serve",
                              "--index-path", str(tmp_path)], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert refused.returncode != 0 and "RuntimeError" in refused.stderr
    assert "no CUDA device is available" in refused.stderr


def test_info_reports_the_host(capsys):
    import torch

    assert tmain.main(["info"]) == 0
    out = capsys.readouterr().out
    if torch.cuda.is_available():
        assert f"{torch.cuda.device_count()} CUDA device(s)" in out
    else:
        assert "no CUDA device" in out


def test_models_default_to_the_gpu(tmp_path):
    import torch

    parser = tmain.build_parser()
    assert parser.parse_args(["local", "hello"]).device == "cuda"
    assert parser.parse_args(["local", "image-annotate", "--input-path", "a", "--output-path", "b"]).device == "cuda"
    assert parser.parse_args(["local", "dedup", "--input-path", "a"]).device == "cuda"
    assert parser.parse_args(["index", "stats", "--index-path", "a"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmain.main(["local", "hello"])


# -- the commands end to end -------------------------------------------------------


def test_hello_prints_like_jax(capsys):
    assert jmain.main(["local", "hello"]) == 0
    want = capsys.readouterr().out
    assert tmain.main(["local", "hello", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.count("device=cpu") == 10


def test_image_annotate_matches_the_jax_cli(tiny_path, fp32, corpus, tmp_path, capsys):  # noqa: F811
    argv = ["local", "image-annotate", "--input-path", str(corpus), "--sequential", "--aesthetic-threshold=-1e9"]
    assert jmain.main([*argv, "--output-path", str(tmp_path / "jax")]) == 0
    want = json.loads(capsys.readouterr().out)
    assert tmain.main([*argv, "--output-path", str(tmp_path / "port"), "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got.pop("pipeline_run_time_s") >= 0 and want.pop("pipeline_run_time_s") >= 0
    assert got == want and got["num_embedded"] == 9
    j_out, t_out = read_output(tmp_path / "jax"), read_output(tmp_path / "port")
    assert {k for k in t_out["files"] if not k.startswith("metas/")} == {
        k for k in j_out["files"] if not k.startswith("metas/")}
    assert t_out["rows"].keys() == j_out["rows"].keys()


def _printed(capsys) -> dict:
    return json.loads(capsys.readouterr().out)


def _timeless(d: dict) -> dict:
    """``d`` without what the clock decides (times, rates, timestamps)."""
    return {k: v for k, v in d.items()
            if not k.endswith("_s") and k not in ("ops", "cache", "timestamp", "video_hours_per_day_per_chip")}


def _files(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _split(tmp_path, capsys) -> dict:
    """``local split --config`` (fixed stride, no embeddings) on two scene
    videos through the JAX CLI, the port's CLI and ``run_split``: name ->
    (printed summary, output root)."""
    videos = tmp_path / "videos"
    videos.mkdir()
    for i in range(2):
        make_scene_video(videos / f"v{i}.mp4", scene_len_frames=24, num_scenes=2)
    cfg = {"input_path": str(videos), "fixed_stride_len_s": 1.0, "min_clip_len_s": 0.5, "extract_fps": [2.0],
           "extract_resize_hw": [32, 32]}
    runs = {}
    for name, main, extra in (("jax", jmain.main, []), ("cli", tmain.main, ["--device", "cpu"])):
        (tmp_path / f"{name}.json").write_text(json.dumps({**cfg, "output_path": str(tmp_path / name)}))
        assert main(["local", "split", "--config", str(tmp_path / f"{name}.json"), "--sequential", *extra]) == 0
        runs[name] = (_printed(capsys), tmp_path / name)
    runs["direct"] = (tsplit.run_split(tsplit.SplitPipelineArgs(
        **{**cfg, "output_path": str(tmp_path / "direct"), "extract_fps": (2.0,), "extract_resize_hw": (32, 32)},
        device="cpu"), runner=SequentialRunner()), tmp_path / "direct")
    return runs


def test_split_with_a_config_matches_run_split(tmp_path, capsys):
    runs = _split(tmp_path, capsys)
    got = runs["cli"][0]
    assert _timeless(got) == _timeless(runs["direct"][0]) == _timeless(runs["jax"][0]) and got["num_clips"] == 4
    # every run also publishes report/live/status.json, in both packages
    files = {name: _files(root) for name, (_, root) in runs.items()}
    assert "report/live/status.json" in files["cli"]
    assert files["cli"] == files["direct"] == files["jax"]
    for name in files["cli"]:
        if name.startswith(("metas/", "processed_videos/")):
            assert (tmp_path / "cli" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


def test_split_tracing_runs_like_the_jax_cli(tmp_path, capsys):
    """``local split --tracing``, refused by earlier slices, runs: the span
    trace and the connected run report, with the JAX CLI's span names and
    report sections."""
    videos = tmp_path / "videos"
    videos.mkdir()
    make_scene_video(videos / "v0.mp4", scene_len_frames=24, num_scenes=2)
    traced = {}
    for name, main, extra in (("jax", jmain.main, []), ("cli", tmain.main, ["--device", "cpu"])):
        out = tmp_path / name
        assert main(["local", "split", "--input-path", str(videos), "--output-path", str(out), "--tracing",
                     "--fixed-stride-len-s", "1.0", "--min-clip-len-s", "0.5", *extra]) == 0
        assert _printed(capsys)["num_clips"] == 2
        spans = [json.loads(line) for line in (out / "profile" / "traces" / "driver.ndjson").read_text().splitlines()]
        traced[name] = ({s["name"] for s in spans}, json.loads((out / "report" / "run_report.json").read_text()))
    (names, report), (j_names, j_report) = traced["cli"], traced["jax"]
    assert names == j_names and "run.split" in names and "pipeline.run" in names
    assert set(report) == set(j_report) and report["connected"] and j_report["connected"]
    assert _files(tmp_path / "cli") == _files(tmp_path / "jax")


def test_shard_of_a_split_matches_the_jax_cli(tmp_path, capsys):
    runs = _split(tmp_path, capsys)
    printed = {}
    for name, main in (("jax", jmain.main), ("cli", tmain.main)):
        out = tmp_path / f"shard_{name}"
        assert main(["local", "shard", "--input-path", str(runs[name][1]), "--output-path", str(out)]) == 0
        got = _printed(capsys)
        for bucket in got["buckets"].values():
            bucket["shards"] = [str(Path(p).relative_to(out)) for p in bucket["shards"]]
        printed[name] = got
    assert _timeless(printed["cli"]) == _timeless(printed["jax"]) and printed["cli"]["num_samples"] == 4
    assert _files(tmp_path / "shard_cli") == _files(tmp_path / "shard_jax")
    for shard in printed["cli"]["buckets"]["4-3_0p_w16"]["shards"]:
        with tarfile.open(tmp_path / "shard_cli" / shard) as t, tarfile.open(tmp_path / "shard_jax" / shard) as j:
            assert t.getnames() == j.getnames() and len(t.getnames()) == 8
            for member in t.getnames():
                if member.endswith(".json"):
                    assert t.extractfile(member).read() == j.extractfile(member).read(), member


@pytest.fixture
def split_out(tmp_path) -> tuple[Path, list[str], np.ndarray]:
    """A split output's embeddings (near-copies planted) under ``tmp_path``."""
    x, _ = planted(3, 3, 6, 16, dup_every=3)
    ids = [f"c{i:02d}" for i in range(len(x))]
    write_split_embeddings(tmp_path / "run", x, ids, chunks=2, other=False)
    return tmp_path / "run", ids, x


def test_dedup_and_shard_match_their_entry_points(split_out, tmp_path, capsys):
    root = split_out[0]
    assert tmain.main(["local", "dedup", "--input-path", str(root), "--output-path", str(tmp_path / "cli"),
                       "--device", "cpu", "--eps", "0.05"]) == 0
    got = _printed(capsys)
    want = tdedup.run_dedup(tdedup.DedupPipelineArgs(input_path=str(root), output_path=str(tmp_path / "direct"),
                                                     device="cpu", eps=0.05))
    assert _timeless(got) == _timeless(want) and got["num_removed"] > 0
    csv = "dedup_summary_0.05.csv"
    assert (tmp_path / "cli" / csv).read_text() == (tmp_path / "direct" / csv).read_text()
    assert jmain.main(["local", "dedup", "--input-path", str(root), "--output-path", str(tmp_path / "jax"),
                       "--eps", "0.05"]) == 0
    assert _timeless(_printed(capsys)) == _timeless(got)
    rows = {name: (tmp_path / name / csv).read_text().splitlines() for name in ("cli", "jax")}
    assert rows["cli"][0] == rows["jax"][0] and sorted(rows["cli"]) == sorted(rows["jax"])
    # shard needs clips: an output without any packs nothing, in both
    assert tmain.main(["local", "shard", "--input-path", str(root), "--output-path", str(tmp_path / "shard"),
                       "--dedup-csv", str(tmp_path / "cli" / csv)]) == 0
    got = _printed(capsys)
    want = tshard.run_shard(tshard.ShardPipelineArgs(input_path=str(root), output_path=str(tmp_path / "shard2"),
                                                     dedup_csv=str(tmp_path / "cli" / csv)))
    assert _timeless(got) == _timeless(want)


def test_index_actions_match_their_entry_points(split_out, tmp_path, capsys):
    root, ids, x = split_out
    index = str(tmp_path / "index")
    assert tmain.main(["index", "stats", "--index-path", index, "--device", "cpu"]) == 2  # no index, nothing pending
    assert _printed(capsys)["exists"] is False
    assert tmain.main(["index", "build", "--input-path", str(root), "--index-path", index, "--k", "3",
                       "--device", "cpu", "--no-mesh"]) == 0
    built = _printed(capsys)
    direct = CorpusIndex.build(str(tmp_path / "direct"), ids, x, model="video-embed-tpu", k=3, device="cpu")
    assert {**_timeless(built), "index_path": ""} == {**_timeless(direct.stats()), "index_path": "",
                                                      "pending_cleared": 0}
    assert built["num_vectors"] == len(ids) and built["k"] == 3
    j_index = str(tmp_path / "jax_index")
    assert jmain.main(["index", "build", "--input-path", str(root), "--index-path", j_index, "--k", "3",
                       "--no-mesh"]) == 0
    # the port's stats() also carries its ``ops`` and ``cache`` counters,
    # which _timeless drops with the clock's keys
    assert {**_timeless(_printed(capsys)), "index_path": ""} == {**_timeless(built), "index_path": ""}

    assert tmain.main(["index", "query", "--input-path", str(root), "--index-path", index, "--device", "cpu",
                       "--output-csv", str(tmp_path / "q.csv")]) == 0
    queried = _printed(capsys)
    result = incremental_dedup(direct, ids, x, eps=0.07)
    assert (queried["num_kept"], queried["num_removed"], queried["duplicate_of"]) == (
        len(result["kept"]), len(result["removed"]), result["duplicate_of"])
    assert queried["num_queries"] == len(ids) and (tmp_path / "q.csv").exists()
    assert jmain.main(["index", "query", "--input-path", str(root), "--index-path", j_index,
                       "--output-csv", str(tmp_path / "jq.csv")]) == 0
    assert {**_printed(capsys), "index_path": "", "output_csv": ""} == {**queried, "index_path": "",
                                                                        "output_csv": ""}
    assert (tmp_path / "q.csv").read_text() == (tmp_path / "jq.csv").read_text()

    assert tmain.main(["index", "add", "--input-path", str(root), "--index-path", index, "--device", "cpu"]) == 0
    assert _printed(capsys)["added"] == len(ids)
    assert tmain.main(["index", "stats", "--index-path", index, "--device", "cpu"]) == 0
    assert _printed(capsys)["num_vectors"] == 2 * len(ids)
    assert tmain.main(["index", "consolidate", "--index-path", index, "--device", "cpu"]) == 0
    assert _printed(capsys)["index_path"] == index
    assert tmain.main(["index", "compact", "--index-path", index, "--device", "cpu", "--force"]) == 0
    assert _printed(capsys)["published"] is True


# -- report, top and dlq -----------------------------------------------------------


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    """A traced port split (``SequentialRunner``) that both command lines
    read: its run report, its final live status."""
    from tests.fixtures.observability import preserved_observability_state

    root = tmp_path_factory.mktemp("traced_cli")
    videos = root / "videos"
    videos.mkdir()
    make_scene_video(videos / "v0.mp4", scene_len_frames=24, num_scenes=2)
    with preserved_observability_state():
        tsplit.run_split(tsplit.SplitPipelineArgs(input_path=str(videos), output_path=str(root / "out"), tracing=True,
                                                  fixed_stride_len_s=1.0, min_clip_len_s=0.5, device="cpu"),
                         runner=SequentialRunner())
    return root / "out"


def _both(argv, capsys) -> tuple[tuple[int, str], tuple[int, str]]:
    """(exit code, stdout) of the port's and the JAX command line."""
    rc = tmain.main(argv)
    out = capsys.readouterr().out
    j_rc = jmain.main(argv)
    return (rc, out), (j_rc, capsys.readouterr().out)


def _phase_keys():
    sys.path.insert(0, str(REPO / "scripts"))
    import engine_phase

    return engine_phase


def test_report_matches_the_jax_cli(traced_run, capsys):
    """``report`` on a traced run, as JSON and rendered, and on the
    report's own path, through both command lines."""
    (rc, out), (j_rc, j_out) = _both(["report", str(traced_run), "--json"], capsys)
    assert rc == j_rc == 0 and json.loads(out) == json.loads(j_out)
    assert _phase_keys().REPORT_KEYS <= set(json.loads(j_out))  # what the engine phase asks of the card's run
    for argv in (["report", str(traced_run)], ["report", str(traced_run / "report" / "run_report.json")]):
        (rc, out), (j_rc, j_out) = _both(argv, capsys)
        assert rc == j_rc == 0 and out == j_out and "CONNECTED" in out
    (rc, out), (j_rc, j_out) = _both(["report", str(traced_run), "--rebuild", "--json"], capsys)
    rebuilt, j_rebuilt = json.loads(out), json.loads(j_out)
    assert rc == j_rc == 0 and set(rebuilt) == set(j_rebuilt)
    for key in ("span_count", "trace_ids", "connected", "critical_path", "spans_by_name", "stage_times"):
        assert rebuilt[key] == j_rebuilt[key], key


def test_report_of_a_run_without_a_report(tmp_path, capsys):
    """A running snapshot renders under RUN IN PROGRESS (exit 0); a finished
    one without spans is an error (2); nothing at all is an error too."""
    live = tmp_path / "report" / "live"
    live.mkdir(parents=True)
    for state, code in (("running", 0), ("finished", 2)):
        (live / "status.json").write_text(json.dumps({"version": 1, "ts": 0, "seq": 1, "state": state,
                                                      "runner": "streaming", "stages": {"S": {"workers": 1}},
                                                      "anomalies": []}))
        (rc, out), (j_rc, j_out) = _both(["report", str(tmp_path)], capsys)
        assert rc == j_rc == code and out == j_out
        if state == "running":
            assert "RUN IN PROGRESS" in out and "S" in out
    (rc, _), (j_rc, _) = _both(["report", str(tmp_path / "missing")], capsys)
    assert rc == j_rc == 2


def _mask_age(text: str) -> str:
    import re

    return re.sub(r"\(\d+\.\d+s old\)", "(age)", text)


def test_top_matches_the_jax_cli(traced_run, tmp_path, capsys):
    (rc, out), (j_rc, j_out) = _both(["top", str(traced_run), "--once", "--json"], capsys)
    snap = json.loads(out)
    assert rc == j_rc == 0 and snap == json.loads(j_out) and snap["state"] == "finished"
    assert _phase_keys().TOP_KEYS <= set(json.loads(j_out))
    (rc, out), (j_rc, j_out) = _both(["top", str(traced_run), "--once"], capsys)
    assert rc == j_rc == 0 and _mask_age(out) == _mask_age(j_out) and "FINISHED" in out
    (rc, out), (j_rc, j_out) = _both(["top", str(tmp_path), "--once"], capsys)
    assert rc == j_rc == 2 and out == j_out and "no live snapshot" in out


@pytest.fixture
def job_service():
    """A fake job service on a free local port: ``/health``, ``/v1/slo``
    and one job's ``/v1/jobs/<id>/status``."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    snapshot = {"version": 1, "ts": 0, "seq": 3, "state": "running", "runner": "pipelined", "wall_s": 2.5,
                "stages": {"Embed": {"queue_depth": 2, "busy_frac": 0.5, "workers": 1, "completed": 4,
                                     "errored": 0, "dead_lettered": 0, "inflight": [{"batch_id": 9, "age_s": 1.0}]}},
                "anomalies": [], "anomaly_count": 0}
    docs = {
        "/health": {"status": "ok", "ready": True, "dispatcher_running": True, "journal_writable": True,
                    "queued": {"interactive": 1, "batch": 2}, "max_concurrent": 2, "states": {"running": 1},
                    "running_jobs": ["j1"]},
        "/v1/slo": {"tenants": {"t": {"queue_wait": {"mean_s": 1.0, "max_s": 2.0},
                                      "run_duration": {"mean_s": 3.0, "max_s": 4.0},
                                      "success_rate": {"rate": 0.5}, "breaches_total": 1}}},
        "/v1/jobs/j1/status": {"job_id": "j1", "state": "running", "tenant": "t", "attempts": 1,
                               "snapshot": snapshot},
    }

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_GET(self):  # noqa: N802
            body = json.dumps(docs.get(self.path, {"detail": "missing"})).encode()
            self.send_response(200 if self.path in docs else 404)
            self.send_header("content-length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


@pytest.mark.parametrize("view", ["service", "job", "job_url"])
@pytest.mark.parametrize("as_json", [False, True], ids=["text", "json"])
def test_top_of_a_job_service_matches_the_jax_cli(job_service, view, as_json, capsys):
    argv = {"service": ["top", job_service], "job": ["top", job_service, "--job", "j1"],
            "job_url": ["top", f"{job_service}/v1/jobs/j1/status"]}[view] + ["--once"] + (["--json"] if as_json else [])
    (rc, out), (j_rc, j_out) = _both(argv, capsys)
    assert rc == j_rc == 0
    if as_json:
        assert json.loads(out) == json.loads(j_out)
    else:
        assert _mask_age(out) == _mask_age(j_out)
        assert ("queues: interactive=1  batch=2" in out) if view == "service" else ("Embed" in out)


@pytest.fixture
def dead_letters(tmp_path, monkeypatch):
    """A dead-letter queue with one batch the port's runner dropped."""
    from cosmos_curate_tpu_torch.core.pipeline import run_pipeline
    from tests.fixtures.engine_stages_torch import FailOn13Stage, Item

    root = tmp_path / "dlq"
    monkeypatch.setenv("CURATE_DLQ_DIR", str(root))
    runner = SequentialRunner(raise_on_error=False)
    run_pipeline([Item(value=v) for v in (1, 13)], [FailOn13Stage()], runner=runner)
    assert runner.dead_lettered == 1
    return root


def test_dlq_list_and_show_match_the_jax_cli(dead_letters, capsys):
    (rc, out), (j_rc, j_out) = _both(["dlq", "list", "--json", "--dlq-dir", str(dead_letters)], capsys)
    entries = json.loads(out)
    assert rc == j_rc == 0 and entries == json.loads(j_out) and len(entries) == 1
    assert _phase_keys().DLQ_KEYS <= set(entries[0])
    entry = entries[0]["entry"]
    assert entries[0]["stage"] == "FailOn13Stage" and "boom on 13" in entries[0]["error_tail"]
    for argv in (["dlq", "list", "--dlq-dir", str(dead_letters)], ["dlq", "show", entry, "--dlq-dir", str(dead_letters)],
                 ["dlq", "show", entry.split("/")[1], "--dlq-dir", str(dead_letters)]):
        (rc, out), (j_rc, j_out) = _both(argv, capsys)
        assert rc == j_rc == 0 and out == j_out
    assert "[0] Item:" in out
    (rc, out), (j_rc, j_out) = _both(["dlq", "show", "nothing-like-it", "--dlq-dir", str(dead_letters)], capsys)
    assert rc == j_rc == 2


def test_dlq_requeue_matches_the_jax_cli(dead_letters, tmp_path, capsys):
    import shutil

    import cloudpickle

    j_root = tmp_path / "jdlq"
    shutil.copytree(dead_letters, j_root)
    requeued = {}
    for name, main, root in (("port", tmain.main, dead_letters), ("jax", jmain.main, j_root)):
        entry = json.loads(_run_json(main, ["dlq", "list", "--json", "--dlq-dir", str(root)], capsys))[0]["entry"]
        out = tmp_path / f"{name}.pkl"
        assert main(["dlq", "requeue", entry, "--dlq-dir", str(root), "--out", str(out)]) == 0
        printed = capsys.readouterr().out
        assert printed == f"1 task(s) from {entry} -> {out}\n"
        listed = json.loads(_run_json(main, ["dlq", "list", "--json", "--dlq-dir", str(root)], capsys))
        requeued[name] = ([t.value for t in cloudpickle.loads(out.read_bytes())], listed[0]["requeued_at"] > 0)
    assert requeued["port"] == requeued["jax"] == ([13], True)


def _run_json(main, argv, capsys) -> str:
    assert main(argv) == 0
    return capsys.readouterr().out


# -- local av ----------------------------------------------------------------------


def test_av_steps_match_the_jax_cli(tmp_path, monkeypatch, capsys):
    """``local av``'s seven steps through both command lines on the same
    sessions. The steps build their models inside; both packages' constructors
    hand out ``tests/test_torch_av_pipeline.py``'s tiny models on shared
    parameters (T5 in fp32), whose logits the engine rule then reads."""
    import jax.numpy as jnp
    import torch

    from cosmos_curate_tpu.models import t5 as jt5
    from cosmos_curate_tpu.models import vlm as jvlm
    from cosmos_curate_tpu.pipelines.av import pipeline as jav
    from cosmos_curate_tpu_torch.pipelines.av import pipeline as tav
    from tests import test_torch_av_pipeline as avt

    monkeypatch.setattr(jt5, "T5Encoder", functools.partial(jt5.T5Encoder, dtype=jnp.float32))
    monkeypatch.setattr(avt.tt5, "T5Encoder", functools.partial(avt.tt5.T5Encoder, dtype=torch.float32))
    monkeypatch.setenv("CURATE_MODEL_WEIGHTS_DIR", str(tmp_path / "weights"))
    monkeypatch.delenv("CURATE_RUNNER", raising=False)
    for module in (jh264, th264):
        monkeypatch.setattr(module, "_probe_result", False)
    models = avt.make_models()
    for model in (models.j_engine, models.t_engine, models.j_t5, models.t_t5):
        model.setup = lambda *a, **k: None  # built above; a rebuild would drop the logits tracing
    monkeypatch.setattr(jvlm, "CaptionEngine", lambda cfg, **kw: models.j_engine)
    monkeypatch.setattr(jt5, "T5EncoderTPU", lambda cfg: models.j_t5)
    monkeypatch.setattr(tav, "CaptionEngine", lambda cfg, **kw: models.t_engine)
    monkeypatch.setattr(tav, "T5EncoderTPU", lambda cfg, **kw: models.t_t5)
    inputs = tmp_path / "in"
    inputs.mkdir()
    for stem, scenes in avt.AV_FILES.items():
        make_scene_video(inputs / f"{stem}.mp4", scene_len_frames=24, num_scenes=scenes)
    roots = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    argv = ["--input-path", str(inputs), "--clip-len-s", "3.0", "--min-clip-len-s", "0.5", "--caption-variants",
            "av,short", "--sequential"]
    printed: dict[str, dict] = {"jax": {}, "port": {}}
    for step in avt.STEPS:
        for pkg, main, extra in (("jax", jmain, []), ("port", tmain, ["--device", "cpu"])):
            assert main.main(["local", "av", step, *argv, "--output-path", str(roots[pkg]), *extra]) == 0
            printed[pkg][step] = json.loads(capsys.readouterr().out)
        if step == "caption":
            j_db, t_db = (jav.AVPipelineArgs(output_path=str(roots[p])).resolved_db for p in ("jax", "port"))
            compared = avt.assert_captions_by_rule(models.j_trace, models.t_trace, j_db, t_db)
            avt.copy_differing_captions(j_db, t_db, compared)
            # the default 8-frame windows: one a request, 4 clips x 2 variants
            assert len(compared) == 8
    for pkg in printed:
        printed[pkg]["ingest"]["db"] = printed[pkg]["ingest"]["db"].replace(str(roots[pkg]), "<root>")
        printed[pkg]["shard"]["buckets"] = json.loads(
            json.dumps(printed[pkg]["shard"]["buckets"]).replace(str(roots[pkg]), "<root>"))
    labels = {pkg: {printed[pkg][s]["run_uuid"]: f"<{s}-run>" for s in ("split", "annotate")} for pkg in printed}
    for step in avt.STEPS:
        got, want = avt._summary(printed["port"][step], labels["port"]), avt._summary(printed["jax"][step],
                                                                                      labels["jax"])
        if step == "caption":
            got.pop("tokens_per_s"), want.pop("tokens_per_s")
        assert got == want, step
    assert printed["port"]["package"]["num_packaged"] == 4 and printed["port"]["shard"]["num_samples"] == 4
    got = avt.normalized_rows(tav.AVPipelineArgs(output_path=str(roots["port"])).resolved_db, roots["port"])
    want = avt.normalized_rows(jav.AVPipelineArgs(output_path=str(roots["jax"])).resolved_db, roots["jax"])
    assert got == want
    for prefix in ("metas", "processed_sessions", "trajectories"):
        assert set(avt._files(roots["port"], prefix)) == set(avt._files(roots["jax"], prefix))
    assert avt._normalized_json(roots["port"], "processed_sessions") == \
        avt._normalized_json(roots["jax"], "processed_sessions")


@pytest.mark.parametrize("lance", ["absent", "fake", "no_embeddings"])
def test_export_lance_matches_the_jax_cli(lance, tmp_path, monkeypatch, capsys):
    """``export-lance`` through both command lines on one split output's
    ``embeddings/``: without ``lance`` both exit 2 with the ``pip install
    pylance`` guidance; with a stand-in module both write one dataset a
    model and print its rows; without embeddings both exit 2."""
    import types

    from cosmos_curate_tpu.storage.writers import write_parquet

    src = tmp_path / "embeddings"
    if lance == "no_embeddings":
        src.mkdir()
    else:
        for model, rows in (("video-embed-tpu", 3), ("clip-vit-b16-tpu", 2)):
            (src / model).mkdir(parents=True)
            for c in range(2):
                write_parquet(str(src / model / f"chunk-{c}.parquet"),
                              {"clip_uuid": [f"{model}-{c}-{i}" for i in range(rows)],
                               "embedding": [np.full(4, i, np.float32) for i in range(rows)]})
    calls = []
    if lance == "fake":
        fake = types.ModuleType("lance")
        fake.write_dataset = lambda table, uri, mode: calls.append((table.num_rows, uri, mode))
        monkeypatch.setitem(sys.modules, "lance", fake)
    else:
        monkeypatch.setitem(sys.modules, "lance", None)
    argv = ["export-lance", "--src", str(src), "--dest", str(tmp_path / "out"), "--mode", "overwrite"]
    outs = []
    for main in (jmain.main, tmain.main):
        rc = main(argv)
        outs.append((rc, *capsys.readouterr()))
    assert outs[0] == outs[1]
    rc, out, err = outs[1]
    if lance == "fake":
        assert rc == 0 and err == ""
        assert sorted(out.splitlines()) == sorted(f"{tmp_path / 'out' / m}.lance: {n} rows"
                                                  for m, n in (("video-embed-tpu", 6), ("clip-vit-b16-tpu", 4)))
        assert calls[:2] == calls[2:] and {mode for *_, mode in calls} == {"overwrite"}
    else:
        assert rc == 2 and out == "" and err.startswith("error: ")
        assert ("pip install pylance" in err) is (lance == "absent")
