"""``chip_smoke.py``'s ``remote`` phase, which ``chip_smoke.py`` runs after its
image and command-line phases on the split phase's corpus, or alone on the
card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/remote_phase.py

Alone, it builds the kernels, checks flash at ``chip_smoke.FLASH_CASES`` and
writes the first ``REMOTE_VIDEOS`` videos of the split corpus. The object
stores are the repository's in-process fakes (``tests/storage/fake_s3.py``,
``fake_gcs.py``, ``fake_azure.py``) on 127.0.0.1, in this process: no
request leaves the host. The fake S3 and Azure servers recompute every
SigV4 and Shared Key signature and refuse a wrong one; the phase fails if
either refused any. Every run has every kernel's launch counter zeroed just
before it and read just after. One JSON line, ``remote``:

1. **setup**: the three fakes, the ``AWS_*``, ``STORAGE_EMULATOR_HOST`` and
   ``AZURE_STORAGE_*`` variables pointed at them (restored at the end), the
   corpus's first ``REMOTE_VIDEOS`` videos uploaded to ``s3://`` under
   names with a space, ``+``, ``%`` and a non-ASCII letter; a seeded
   ``VIDEO_EMBED_BASE`` checkpoint (``params.msgpack``, flax's layout, ~397
   MB, so a multipart upload) and its ``.sha256`` sidecar under an
   ``s3://`` weights prefix.
2. **local run**: run A's settings (``chip_smoke.split_args``) on the same
   videos and the same checkpoint staged locally, from a local input to a
   local output, through the default runner; first, so that neither run
   pays the process's first model setup when the phase runs alone.
3. **remote run**: the same settings from the ``s3://`` input to an
   ``az://`` output, with ``CURATE_WEIGHTS_URI`` at the prefix and
   ``CURATE_MODEL_WEIGHTS_DIR`` empty: the checkpoint pulled once, by
   ranged reads of ``registry.PULL_CHUNK``, its sha256 the sidecar's; every
   clip cut, embedded and written, unit-norm parquet embeddings, flash
   launched; the same files and metas as the local run and every embedding
   within ``EMBED_BOUND`` of its. Clip uuids and resume records derive
   from the video's path, so the two runs are matched by (video, span) and
   the file sets compared with that key in place of the uuid.
4. **resume**: a second ``run_split`` on the ``az://`` output discovers no
   video.
5. **retries**: the remote run again, traced, with ``fail_next = 2`` (HTTP
   503) armed on the fake S3 once discovery has listed the input: it
   succeeds, and its ``storage.read`` spans carry the retries.
6. **dedup and shard**: ``run_dedup`` and ``run_shard`` from the ``az://``
   output to ``gs://``, and the same calls on a byte-for-byte local copy
   of that output: the dedup rows equal as a set, every shard member byte
   for byte; the local run's dedup keeps and removes the same clips (by
   video and span).
7. **cli**: ``local split --config`` as a subprocess from ``s3://`` to
   ``gs://`` (it reaches the fakes through the environment it inherits):
   exit 0 and the remote run's files.

Reported: each run's wall beside the local run's, the requests and bytes
each backend served, the pull's seconds and MB/s, and the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import collections
import contextlib
import csv
import functools
import hashlib
import io
import json
import os
import subprocess
import sys
import tarfile
import threading
import time
from pathlib import Path

import numpy as np

# a spawned child (the corpus writers) imports this script again as
# ``__mp_main__`` and runs none of its device code
if __name__ != "__mp_main__":
    import torch

REPO = Path(__file__).resolve().parents[1]
SEED = 18
REMOTE_VIDEOS = 2
S3_VIDEOS = "s3://corpus/raw videos"
WEIGHTS_URI = "s3://weights/v1"
AZ_OUT = "az://curated/split"
GS_ROOT = "gs://datasets"
DEDUP_EPS = 0.07
BACKENDS = ("s3", "gcs", "azure")


def remote_name(i: int, path: Path) -> str:
    """The object name video ``i`` is uploaded under: a space, ``+``, ``%``
    and a non-ASCII letter, which SigV4 and Shared Key must encode as
    sent."""
    return f"take+{i} 100% é {path.name}"


@contextlib.contextmanager
def patched_environ(values: dict[str, str | None]):
    """``os.environ`` with ``values`` set (None: removed), restored after."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def counted_traffic(servers: dict) -> dict:
    """Wrap each fake's request handlers: per backend, requests by method,
    request and response body bytes; for S3, the Range header of every GET
    of a ``params.msgpack`` and the GETs of its sidecar."""
    lock = threading.Lock()
    stats = {name: {"requests": collections.Counter(), "bytes_in": 0, "bytes_out": 0} for name in servers}
    stats["s3"]["params_gets"] = []
    stats["s3"]["sidecar_gets"] = 0

    for name, srv in servers.items():
        handler = srv._server.RequestHandlerClass
        st = stats[name]

        def wrap_method(fn, method, st=st, name=name):
            @functools.wraps(fn)
            def do(self):
                with lock:
                    st["requests"][method] += 1
                    st["bytes_in"] += int(self.headers.get("content-length") or 0)
                    if name == "s3" and method == "GET":
                        path = self.path.split("?", 1)[0]
                        if path.endswith("/params.msgpack"):
                            st["params_gets"].append(self.headers.get("range"))
                        elif path.endswith("/params.msgpack.sha256"):
                            st["sidecar_gets"] += 1
                return fn(self)
            return do

        for method in ("GET", "PUT", "POST", "HEAD", "DELETE"):
            fn = getattr(handler, f"do_{method}", None)
            if fn is not None:
                setattr(handler, f"do_{method}", wrap_method(fn, method))
        reply = handler._reply

        def counted_reply(self, status, body=b"", *rest, reply=reply, st=st, **kw):
            if body and self.command != "HEAD":
                with lock:
                    st["bytes_out"] += len(body)
            return reply(self, status, body, *rest, **kw)

        handler._reply = counted_reply
    return stats


def traffic_snapshot(stats: dict) -> dict:
    return {name: {"requests": dict(st["requests"]), "bytes_in": st["bytes_in"], "bytes_out": st["bytes_out"]}
            for name, st in stats.items() if name in BACKENDS}


def traffic_delta(before: dict, after: dict) -> dict:
    out = {}
    for name, a in after.items():
        b = before[name]
        reqs = {m: n - b["requests"].get(m, 0) for m, n in a["requests"].items() if n - b["requests"].get(m, 0)}
        out[name] = {"requests": reqs, "total_requests": sum(reqs.values()),
                     "bytes_in": a["bytes_in"] - b["bytes_in"], "bytes_out": a["bytes_out"] - b["bytes_out"]}
    return out


def seeded_checkpoint(dev, directory: Path) -> tuple[str, bytes]:
    """A seeded ``VIDEO_EMBED_BASE`` checkpoint in flax's msgpack layout
    under ``directory`` (the video embedder's registry id), held to load
    back through the registry's reader into the same ``state_dict``:
    (model id, its bytes)."""
    from legs_phase import save_flax_msgpack

    from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict
    from cosmos_curate_tpu_torch.models.embedder import VIDEO_EMBED_VARIANTS, VideoEmbedModel
    from cosmos_curate_tpu_torch.models.registry import read_flax_msgpack

    cfg, model_id = VIDEO_EMBED_VARIANTS["video"]
    with torch.device(dev):
        model = VideoEmbedModel(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    model.init_weights(gen)
    sd = {k: v.detach().float().cpu() for k, v in model.state_dict().items()}
    del model
    tree: dict = {}
    for name, value in sd.items():
        parts = name.split(".")
        node = tree
        i = 0
        while i < len(parts) - 1:  # blocks.N / layers.N are flax's block_N / layer_N
            part = parts[i]
            if part in ("blocks", "layers") and parts[i + 1].isdigit():
                part = f"{part[:-1]}_{parts[i + 1]}"
                i += 1
            node = node.setdefault(part, {})
            i += 1
        leaf, arr = parts[-1], value.numpy()
        if leaf == "weight" and arr.ndim == 1:
            leaf = "scale"
        elif leaf == "weight":
            leaf, arr = "kernel", (arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0))
        node[leaf] = np.ascontiguousarray(arr)
    path = directory / model_id / "params.msgpack"
    save_flax_msgpack(path, {"params": tree})
    data = path.read_bytes()
    back = flax_to_state_dict(read_flax_msgpack(data))
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd), "checkpoint round trip"
    return model_id, data


def remote_outputs(root: str, model: str) -> tuple[dict, dict, dict]:
    """(uuid -> meta, uuid -> embedding, relative path -> bytes) of a split
    output on any backend."""
    import pyarrow.parquet as pq

    from cosmos_curate_tpu_torch.storage.client import get_storage_client

    client = get_storage_client(root)
    files = {rel: client.read_bytes(f"{root.rstrip('/')}/{rel}") for rel in client.list_relative(root)}
    metas = {rel.rsplit("/", 1)[1][:-5]: json.loads(data) for rel, data in files.items()
             if rel.startswith("metas/v0/")}
    embs = {}
    for rel, data in files.items():
        if rel.startswith(f"embeddings/{model}/"):
            table = pq.read_table(io.BytesIO(data)).to_pydict()
            for uuid, emb in zip(table["clip_uuid"], table["embedding"], strict=True):
                assert uuid not in embs, f"{uuid} embedded twice"
                embs[uuid] = np.asarray(emb, np.float32)
    return metas, embs, files


def clip_keys(metas: dict, names: dict[str, str]) -> dict[str, str]:
    """uuid -> "<video>@<start>-<end>", the video named by ``names`` (its
    path -> a name shared by both runs)."""
    return {u: f"{names[m['source_video']]}@{m['span_start']:.3f}-{m['span_end']:.3f}" for u, m in metas.items()}


def keyed_files(files, keys: dict[str, str], records: dict[str, str]) -> set[str]:
    """Relative paths with each clip uuid and resume-record id replaced by
    its shared key."""
    out = set()
    for rel in files:
        for old, new in (*keys.items(), *records.items()):
            rel = rel.replace(old, new)
        out.add(rel)
    return out


def keyed_meta(meta: dict, keys: dict[str, str], names: dict[str, str]) -> dict:
    return {**meta, "uuid": keys[meta["uuid"]], "source_video": names[meta["source_video"]]}


def storage_read_retries(files: dict[str, bytes]) -> dict:
    spans = [json.loads(line) for rel, data in files.items()
             if rel.startswith("profile/traces/") and rel.endswith(".ndjson") for line in data.decode().splitlines()]
    reads = [s for s in spans if s["name"] == "storage.read"]
    retried = [s["attributes"] for s in reads if s["attributes"].get("attempt")]
    return {"storage_read_spans": len(reads), "retried_spans": len(retried),
            "retries": sum(a["attempt"] - 1 for a in retried),
            "backoff_s": sum(a.get("backoff_s", 0.0) for a in retried),
            "backends": sorted({a["backend"] for a in retried})}


def csv_rows(data: bytes) -> set[tuple]:
    return {tuple(row.values()) for row in csv.DictReader(io.StringIO(data.decode()))}


def tar_members(data: bytes) -> list[tuple[str, bytes]]:
    with tarfile.open(fileobj=io.BytesIO(data)) as tar:
        return [(m.name, tar.extractfile(m).read()) for m in tar.getmembers()]


def shard_members(root: str) -> dict[str, list]:
    from cosmos_curate_tpu_torch.storage.client import get_storage_client

    client = get_storage_client(root)
    return {rel: tar_members(client.read_bytes(f"{root}/{rel}")) for rel in client.list_relative(root)
            if rel.endswith(".tar")}


def drive_remote(cs, dev, timer, root: Path, corpus: list[Path]) -> dict:
    from tests.storage.fake_azure import FakeAzureServer, TEST_ACCOUNT, TEST_KEY
    from tests.storage.fake_gcs import FakeGcsServer
    from tests.storage.fake_s3 import FakeS3Server, TEST_ACCESS_KEY, TEST_SECRET_KEY

    from cosmos_curate_tpu_torch.core.runner import RUNNER_ENV, default_runner
    from cosmos_curate_tpu_torch.models import registry
    from cosmos_curate_tpu_torch.models.embedder import VIDEO_EMBED_VARIANTS
    from cosmos_curate_tpu_torch.pipelines.video import dedup, shard, split
    from cosmos_curate_tpu_torch.pipelines.video.input_discovery import discover_split_tasks
    from cosmos_curate_tpu_torch.pipelines.video.stages.writer import ClipWriterStage, video_record_id
    from cosmos_curate_tpu_torch.storage import client as storage_client
    from cosmos_curate_tpu_torch.storage import s3_rest

    stage_classes = (split.VideoDownloadStage, split.FixedStrideExtractorStage, split.ClipTranscodingStage,
                     split.ClipFrameExtractionStage, split.ClipEmbeddingStage, ClipWriterStage)
    t_setup = time.monotonic()
    local_weights = root / "remote_local_weights"
    model_id, ckpt = seeded_checkpoint(dev, local_weights)
    digest = hashlib.sha256(ckpt).hexdigest()
    videos = corpus[:REMOTE_VIDEOS]
    local_videos = cs.subset(root, corpus, "remote_local_videos", REMOTE_VIDEOS)
    pulled = root / "remote_pulled_weights"
    stack = contextlib.ExitStack()
    with stack:
        s3, gcs, azure = (stack.enter_context(srv()) for srv in (FakeS3Server, FakeGcsServer, FakeAzureServer))
        stats = counted_traffic({"s3": s3, "gcs": gcs, "azure": azure})
        stack.enter_context(patched_environ({
            "AWS_ACCESS_KEY_ID": TEST_ACCESS_KEY, "AWS_SECRET_ACCESS_KEY": TEST_SECRET_KEY,
            "AWS_DEFAULT_REGION": "us-east-1", "AWS_ENDPOINT_URL": s3.endpoint, "AWS_SESSION_TOKEN": None,
            "STORAGE_EMULATOR_HOST": gcs.endpoint, "GCS_OAUTH_TOKEN": None,
            "AZURE_STORAGE_ACCOUNT": TEST_ACCOUNT, "AZURE_STORAGE_KEY": TEST_KEY,
            "AZURE_STORAGE_ENDPOINT": azure.endpoint, "AZURE_STORAGE_SAS_TOKEN": None,
            "CURATE_CONFIG_PATH": str(root / "no-user-config.yaml"), RUNNER_ENV: None,
            registry.WEIGHTS_URI_ENV: WEIGHTS_URI, registry.WEIGHTS_DIR_ENV: str(pulled)}))
        from cosmos_curate_tpu_torch.utils.user_config import load_user_config

        load_user_config.cache_clear()
        names = {}  # video path (either run's) -> the name both runs share
        for i, path in enumerate(videos):
            url = f"{S3_VIDEOS}/{remote_name(i, path)}"
            storage_client.write_bytes(url, path.read_bytes())
            names[url] = names[str(local_videos / path.name)] = path.name
        uploads_before = s3.state.next_upload
        t0 = time.monotonic()
        storage_client.write_bytes(f"{WEIGHTS_URI}/{model_id}/params.msgpack", ckpt)
        upload_s = time.monotonic() - t0
        storage_client.write_bytes(f"{WEIGHTS_URI}/{model_id}/params.msgpack.sha256",
                                   f"{digest}  params.msgpack\n".encode())
        assert s3.state.next_upload == uploads_before + 1 and not s3.state.uploads, "checkpoint: not one multipart"
        setup = dict(seconds=time.monotonic() - t_setup, checkpoint_bytes=len(ckpt), sha256=digest,
                     upload_s=upload_s, upload_mb_per_s=len(ckpt) / upload_s / 1e6,
                     multipart_parts=-(-len(ckpt) // s3_rest.MULTIPART_CHUNK),
                     traffic=traffic_snapshot(stats))

        # the local run first (the same videos and checkpoint, all on local disk), so
        # that neither run pays the process's first model setup in the phase alone
        with patched_environ({registry.WEIGHTS_URI_ENV: None, registry.WEIGHTS_DIR_ENV: str(local_weights)}):
            local = cs.split_run(dev, cs.split_args(local_videos, root / "remote_local_out"), default_runner(),
                                 stage_classes)
        # the remote run: s3:// -> az://, the checkpoint pulled from the prefix
        pulls: list = []
        real_pull = registry.maybe_pull_remote_weights

        def timed_pull(model: str):
            t = time.monotonic()
            out = real_pull(model)
            pulls.append((model, time.monotonic() - t, out))
            return out

        registry.maybe_pull_remote_weights = timed_pull
        try:
            before = traffic_snapshot(stats)
            remote = cs.split_run(dev, cs.split_args(S3_VIDEOS, AZ_OUT), default_runner(), stage_classes)
            remote_traffic = traffic_delta(before, traffic_snapshot(stats))
        finally:
            registry.maybe_pull_remote_weights = real_pull
        n_clips = REMOTE_VIDEOS * cs.SPLIT_CLIPS // cs.SPLIT_VIDEOS
        summary = remote["summary"]
        for key in ("num_clips", "num_transcoded", "num_with_embeddings"):
            assert summary[key] == n_clips, f"remote run: {key} = {summary[key]}, not {n_clips}"
        assert summary["num_videos"] == REMOTE_VIDEOS and summary["num_errors"] == 0, summary
        assert remote["launches"]["flash"] > 0, "remote run: flash was not launched"
        staged = pulled / model_id / "params.msgpack"
        ranged = stats["s3"]["params_gets"]
        chunk = registry.PULL_CHUNK
        assert len(pulls) == 1 and pulls[0][2] == staged, f"remote run: pulls {pulls}"
        assert ranged == [f"bytes={s}-{min(s + chunk, len(ckpt)) - 1}" for s in range(0, len(ckpt), chunk)], ranged
        assert stats["s3"]["sidecar_gets"] == 1, "remote run: the sha256 sidecar was not read once"
        assert hashlib.sha256(staged.read_bytes()).hexdigest() == digest, "remote run: staged checkpoint"
        assert summary["weights_provenance"] == {model_id: f"checkpoint:{digest[:12]}"}, summary["weights_provenance"]
        metas, embs, files = remote_outputs(AZ_OUT, model_id)
        assert len(metas) == len(embs) == n_clips and set(embs) == set(metas), f"remote run: {len(metas)} metas"
        assert sum(f.startswith("clips/") for f in files) == n_clips, "remote run: clip objects"
        cs.check_unit_embeddings(embs, VIDEO_EMBED_VARIANTS["video"][0].output_dim, "remote run")
        pull_s = pulls[0][1]

        l_metas, l_embs, l_files = cs.split_outputs(root / "remote_local_out", model_id)
        keys, l_keys = clip_keys(metas, names), clip_keys(l_metas, names)
        records = {video_record_id(p): n for p, n in names.items()}
        assert sorted(keys.values()) == sorted(l_keys.values()) and len(set(keys.values())) == n_clips, "clips"
        assert keyed_files(files, keys, records) == keyed_files(l_files, l_keys, records) - {
            "report/live/status.json"}, "remote and local runs: output files"
        by_key = {l_keys[u]: u for u in l_metas}
        emb_diff = 0.0
        for u, meta in metas.items():
            lu = by_key[keys[u]]
            assert keyed_meta(meta, keys, names) == keyed_meta(l_metas[lu], l_keys, names), f"meta of {keys[u]}"
            emb_diff = max(emb_diff, float(np.abs(embs[u] - l_embs[lu]).max()))
        assert emb_diff <= cs.EMBED_BOUND, f"remote vs local embeddings: {emb_diff} > {cs.EMBED_BOUND}"

        # resume: the az:// output records both videos done
        assert discover_split_tasks(S3_VIDEOS, AZ_OUT) == [], "resume: videos rediscovered"
        again = cs.split_run(dev, cs.split_args(S3_VIDEOS, AZ_OUT), default_runner(), stage_classes)
        assert again["summary"]["num_videos"] == 0, f"resume: {again['summary']['num_videos']} videos rerun"

        # retries: two 503s on the fake S3, armed once discovery has listed the input
        discover = split.discover_split_tasks

        def discover_then_fail(*a, **kw):
            tasks = discover(*a, **kw)
            s3.state.fail_next = 2
            return tasks

        split.discover_split_tasks = discover_then_fail
        try:
            retry_out = f"{AZ_OUT}-retried"
            retried = cs.split_run(dev, cs.split_args(S3_VIDEOS, retry_out, tracing=True), default_runner(),
                                   stage_classes)
        finally:
            split.discover_split_tasks = discover
        assert s3.state.fail_next == 0, "retries: the 503s were not served"
        assert retried["summary"]["num_clips"] == n_clips and retried["summary"]["num_errors"] == 0, \
            retried["summary"]
        retries = storage_read_retries(remote_outputs(retry_out, model_id)[2])
        assert retries["retries"] >= 2 and retries["backends"] == ["s3"], retries
        assert len(stats["s3"]["params_gets"]) == len(ranged), "the checkpoint was pulled again"

        # dedup and shard to gs://, against the same calls on a local copy
        local_copy = root / "remote_split_copy"
        for rel, data in files.items():
            (local_copy / rel).parent.mkdir(parents=True, exist_ok=True)
            (local_copy / rel).write_bytes(data)
        csv_name = f"dedup_summary_{DEDUP_EPS:g}.csv"
        walls = {}
        d_local = dedup.run_dedup(dedup.DedupPipelineArgs(input_path=str(root / "remote_local_out"), output_path=str(
            root / "remote_dedup_local"), eps=DEDUP_EPS, device=str(dev)))
        t0 = time.monotonic()
        d_copy = dedup.run_dedup(dedup.DedupPipelineArgs(input_path=str(local_copy), output_path=str(
            root / "remote_dedup_copy"), eps=DEDUP_EPS, device=str(dev)))
        walls["dedup_local_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        d_remote = dedup.run_dedup(dedup.DedupPipelineArgs(input_path=AZ_OUT, output_path=f"{GS_ROOT}/dedup",
                                                           eps=DEDUP_EPS, device=str(dev)))
        walls["dedup_remote_s"] = time.monotonic() - t0
        rows = csv_rows(storage_client.read_bytes(f"{GS_ROOT}/dedup/{csv_name}"))
        assert rows == csv_rows((root / "remote_dedup_copy" / csv_name).read_bytes()), "dedup rows"
        assert len(rows) == n_clips, f"dedup: {len(rows)} rows"
        local_rows = csv_rows((root / "remote_dedup_local" / csv_name).read_bytes())
        mapped = {(keys[u], action, keys.get(dup, dup)) for u, action, dup in rows}
        assert mapped == {(l_keys[u], action, l_keys.get(dup, dup)) for u, action, dup in local_rows}, \
            "dedup of the local run"
        t0 = time.monotonic()
        s_remote = shard.run_shard(shard.ShardPipelineArgs(input_path=AZ_OUT, output_path=f"{GS_ROOT}/shards",
                                                           dedup_csv=f"{GS_ROOT}/dedup/{csv_name}"))
        walls["shard_remote_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        s_copy = shard.run_shard(shard.ShardPipelineArgs(input_path=str(local_copy), output_path=str(
            root / "remote_shards_copy"), dedup_csv=str(root / "remote_dedup_copy" / csv_name)))
        walls["shard_local_s"] = time.monotonic() - t0
        shards = shard_members(f"{GS_ROOT}/shards")
        copy_shards = {str(p.relative_to(root / "remote_shards_copy")): tar_members(p.read_bytes())
                       for p in sorted((root / "remote_shards_copy").rglob("*.tar"))}
        assert shards and shards == copy_shards, "shards"
        assert s_remote["num_samples"] == s_copy["num_samples"] == d_remote["num_kept"], (s_remote, s_copy)

        # local split as a subprocess: s3:// -> gs://
        cfg_path = root / "remote_cli_split.json"
        cli_out = f"{GS_ROOT}/cli-split"
        a = cs.split_args(S3_VIDEOS, cli_out)  # run A's settings, as the remote run had them
        cfg_path.write_text(json.dumps({k: getattr(a, k) for k in (
            "input_path", "output_path", "fixed_stride_len_s", "min_clip_len_s", "extract_fps", "extract_resize_hw",
            "embedding_model", "device")}))
        t0 = time.monotonic()
        proc = subprocess.run([sys.executable, "-m", "cosmos_curate_tpu_torch.cli.main", "local", "split",
                               "--config", str(cfg_path), "--runner", "sequential"], cwd=REPO, capture_output=True,
                              text=True, timeout=600)
        cli_s = time.monotonic() - t0
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
        _, cli_embs, cli_files = remote_outputs(cli_out, model_id)
        assert set(cli_files) - {"summary.json"} == set(files) - {"summary.json"}, "cli: output files"
        cli_diff = max(float(np.abs(cli_embs[u] - embs[u]).max()) for u in embs)
        assert cli_diff <= cs.EMBED_BOUND, f"cli vs remote run embeddings: {cli_diff}"
        failures = s3.state.auth_failures + azure.state.auth_failures
        assert not failures, f"refused signatures: {failures[:3]}"
        traffic = traffic_snapshot(stats)

    ran = set().union(*(r["flash_shapes"] for r in (remote, local, again, retried)))
    return dict(
        videos=REMOTE_VIDEOS, clips=n_clips, setup=setup,
        runs={"remote": {"wall_s": remote["wall"], "launches": remote["launches"], "traffic": remote_traffic},
              "local": {"wall_s": local["wall"], "launches": local["launches"]},
              "resume": {"wall_s": again["wall"], "videos_discovered": again["summary"]["num_videos"]},
              "retried": {"wall_s": retried["wall"], "launches": retried["launches"], **retries},
              "cli_subprocess": {"wall_s": cli_s}},
        remote_over_local=remote["wall"] / local["wall"],
        remote_less_pull_over_local=(remote["wall"] - pulls[0][1]) / local["wall"],
        pull={"seconds": pull_s, "bytes": len(ckpt), "mb_per_s": len(ckpt) / pull_s / 1e6,
              "ranged_reads": len(ranged), "chunk_bytes": chunk, "sha256_verified": True, "pulls": len(pulls)},
        agreement={"max_abs_embedding_diff_vs_local": emb_diff, "cli_max_abs_embedding_diff": cli_diff,
                   "embed_bound": cs.EMBED_BOUND, "same_files_by_video_and_span": True, "same_metas": True},
        dedup={"method": d_remote["method"], "num_kept": d_remote["num_kept"], "num_removed": d_remote["num_removed"],
               "equal_to_local_copy": d_copy["num_kept"] == d_remote["num_kept"],
               "local_run_kept": d_local["num_kept"]},
        shard={"num_samples": s_remote["num_samples"], "shards": len(shards), "members_equal_to_local_copy": True},
        walls=walls, traffic=traffic, launches=remote["launches"],
        flash_checked_here=cs.check_new_flash_shapes(timer, ran, SEED),
    )


def run(cs, dev, timer, root: Path, corpus: list[Path]) -> dict:
    """The phase, its line emitted as it ends; returns the record."""
    t0 = time.monotonic()
    record = {**drive_remote(cs, dev, timer, root, corpus), "phase_s": time.monotonic() - t0, "card": cs.card_line()}
    cs.emit({"phase": "remote", **record})
    runs = record["runs"]
    print(f"remote: run {runs['remote']['wall_s']:.3f} s vs local {runs['local']['wall_s']:.3f} s; pull "
          f"{record['pull']['seconds']:.3f} s ({record['pull']['mb_per_s']:.1f} MB/s); phase {record['phase_s']:.1f} s",
          flush=True)
    return record


def main() -> int:
    if not torch.cuda.is_available():
        print("remote_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    # pyarrow imported first in a worker thread has crashed a later read in
    # the main thread (pyarrow 25): import it here
    import pyarrow.parquet  # noqa: F401

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    started = time.monotonic()
    timer, build_s = cs.phase_prologue(dev)
    with cs.split_corpus(REMOTE_VIDEOS) as (root, corpus, corpus_s):
        cs.emit({"phase": "remote_prologue", "build_s": build_s, "corpus_build_s": corpus_s})
        run(cs, dev, timer, root, corpus)
    cs.emit({"phase": "timing", "script_s": time.monotonic() - started})
    return 0


if __name__ == "__main__":
    sys.exit(main())
