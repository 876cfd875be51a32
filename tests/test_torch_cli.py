"""Port parity: the command line (``cli/main.py``, ``local_cli.py``,
``index_cli.py``) and ``utils/config.py`` on the CPU.

- ``load_pipeline_config``: the same results (list -> tuple coercion) and
  the same errors as the reference's, JSON and YAML.
- The parser walk: the ``local`` and ``index`` groups of both parsers,
  subcommand by subcommand and action by action (option strings, dest,
  default, choices, required, nargs, type, const, action class); the only
  difference allowed is the port's ``--device``; ``info``, ``local`` and
  ``index`` are the port's only groups.
- ``main``'s exit codes (2 with no command or on ``FileNotFoundError``, 130
  on an interrupt) in both packages; every refusal raises
  ``NotImplementedError`` naming its ROADMAP item.
- The commands end to end on the CPU (``--device cpu``), each against the
  JAX CLI given the same argv and inputs: ``local hello``, ``local
  image-annotate`` (the image path's tiny towers from
  ``test_torch_image_pipeline.py``), ``local split --config`` (fixed
  stride), ``local shard`` of that split, ``local dedup``, and ``index
  build`` and ``query``; the printed summaries without what the clock or
  the output path decides (nor the port's ``ops`` and ``cache`` counters
  in the index's stats), and the output files. Split, dedup and every
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
from cosmos_curate_tpu_torch.cli import local_cli as tlocal
from cosmos_curate_tpu_torch.cli import main as tmain
from cosmos_curate_tpu_torch.core.runner import SequentialRunner
from cosmos_curate_tpu_torch.dedup.corpus_index import CorpusIndex, incremental_dedup
from cosmos_curate_tpu_torch.models.vlm.model import VLM_FLAVORS
from cosmos_curate_tpu_torch.pipelines.video import dedup as tdedup
from cosmos_curate_tpu_torch.pipelines.video import shard as tshard
from cosmos_curate_tpu_torch.pipelines.video import split as tsplit
from cosmos_curate_tpu_torch.utils import config as tconfig
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
    assert sorted(ttop) == ["index", "info", "local"] and set(ttop) <= set(jtop)
    assert _actions(tmain.build_parser()).keys() == _actions(jmain.build_parser()).keys() - {"<sub>"} | {"<sub>"}
    walked = 0
    for group in ("local", "index"):
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
    # --device where a model runs: local hello / split / image-annotate /
    # dedup, every index action that opens the index; not shard or serve
    with_device = {(g, n) for g in ("local", "index") for n, p in _subcommands(ttop[g]).items()
                   if "--device" in _actions(p)}
    assert with_device == {("local", "hello"), ("local", "split"), ("local", "image-annotate"), ("local", "dedup"),
                           ("index", "build"), ("index", "add"), ("index", "query"), ("index", "stats"),
                           ("index", "consolidate"), ("index", "compact")}


def test_caption_model_choices_are_the_flavors():
    assert sorted(tlocal.CAPTION_MODEL_CHOICES) == sorted(VLM_FLAVORS)
    assert tlocal.CAPTION_MODEL_CHOICES == jlocal.CAPTION_MODEL_CHOICES


# -- exit codes and refusals -----------------------------------------------------


@pytest.mark.parametrize("argv", [[], ["local"], ["index"]], ids=["none", "local", "index"])
def test_main_without_a_command_exits_2_like_jax(argv, capsys):
    assert tmain.main(argv) == jmain.main(argv) == 2


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
    (["local", "split", "--runner", "streaming"], "item 9b"),
    (["local", "split", "--runner", "map"], "item 9b"),
    (["local", "av", "ingest"], "item 19"),
    (["local", "merge-summaries"], "item 15"),
    (["index", "serve", "--index-path", "x"], "item 19"),
    (["local", "split", "--multicam", "--device", "cpu"], "item 11"),
    (["local", "split", "--sr", "--sr-sp-size", "2", "--device", "cpu"], "item 7"),
], ids=["streaming", "map", "av", "merge-summaries", "index-serve", "multicam", "sr-sp"])
def test_refusals_name_their_roadmap_item(argv, item, tmp_path):
    if argv[:2] in (["local", "split"], ["local", "av"]):
        argv = [*argv, "--input-path", str(tmp_path), "--output-path", str(tmp_path / "out")]
    if argv[:2] == ["local", "merge-summaries"]:
        argv = [*argv, "--output-path", str(tmp_path)]
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue A {item}|\\({item}"):
        tmain.main(argv)
    assert not (tmp_path / "out").exists()


def test_python_dash_m_runs_the_port(tmp_path):
    out = subprocess.run([sys.executable, "-m", "cosmos_curate_tpu_torch.cli.main", "info"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("cosmos-curate-tpu-torch 0.1.0\n") and "torch " in out.stdout
    refused = subprocess.run([sys.executable, "-m", "cosmos_curate_tpu_torch.cli.main", "index", "serve",
                              "--index-path", str(tmp_path)], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert refused.returncode != 0 and "NotImplementedError" in refused.stderr and "item 19" in refused.stderr


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
