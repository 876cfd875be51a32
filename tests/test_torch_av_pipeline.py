"""Port parity: the AV pipeline (``pipelines/av/``), its seven steps against
the JAX package's on the same inputs.

The session files are ``tests/fixtures/media.make_scene_video``'s (96x64 at
24 fps, one second a scene) named ``<session>_<camera>.mp4``; one camera of
``drive_a`` is a scene shorter than the other. Both packages run ingest →
split → caption → trajectory → annotate → package → shard (with the T5
``e`` and clip-session tars, then the ``h`` tars) into their own roots, on
cv2's codec (which repeats itself bit for bit) and with the caption windows
at 2 frames, so a 3-second clip captions in two windows, the second padded
by repeating its last frame. The caption engine is ``VLM_TINY_TEST``, the
port's given the JAX engine's seeded parameters (both in bf16, as they
serve); the T5 encoder is ``T5_TINY_TEST`` in fp32 in both, the port's
given the JAX encoder's parameters. Tolerances:

- state database rows: equal once run ids (by run type), times, the
  output roots and the port's ``device`` in the stored parameters are
  normalised;
- captions: ``tests/test_torch_engine.py``'s rule (bf16 logits within
  ``LOGIT_TOL`` at every compared step; a request's comparison stops at a
  JAX top-2 margin below ``2 * LOGIT_TOL``), and equal text where a request
  compared to its end; a caption that could differ is then copied from the
  JAX database, so the later steps compare on equal inputs;
- trajectories: equal displacements on planted shifts, the correlation
  surface within atol 1e-4 / rtol 1e-3; on the clips, equal positions,
  stats and tags;
- T5: the pickles' and tars' member names and every non-float byte equal,
  the embeddings within atol 1e-4 / rtol 1e-3;
- the annotation JSON files, the clip-session tars and the shards: equal
  (run ids normalised).

A caption run with nothing left to caption builds no engine and reports
``num_captioned: 0`` in both packages.
"""

from __future__ import annotations

import dataclasses
import functools
import io
import json
import pickle
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cosmos_curate_tpu.core.runner import SequentialRunner as JSequentialRunner
from cosmos_curate_tpu.models import t5 as jt5
from cosmos_curate_tpu.models.vlm import VLM_TINY_TEST as J_TINY
from cosmos_curate_tpu.models.vlm import CaptionEngine as JEngine
from cosmos_curate_tpu.pipelines.av import pipeline as jav
from cosmos_curate_tpu.pipelines.av import state_db as jstate
from cosmos_curate_tpu.pipelines.av import trajectory as jtraj
from cosmos_curate_tpu_torch.core.runner import SequentialRunner
from cosmos_curate_tpu_torch.models import t5 as tt5
from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict
from cosmos_curate_tpu_torch.models.vlm import VLM_TINY_TEST, CaptionEngine
from cosmos_curate_tpu_torch.pipelines.av import pipeline as tav
from cosmos_curate_tpu_torch.pipelines.av import state_db as tstate
from cosmos_curate_tpu_torch.pipelines.av import trajectory as ttraj
from tests.fixtures.media import make_scene_video
from tests.fixtures.observability import observability_state, preserved_observability_state  # noqa: F401
from tests.test_torch_engine import LOGIT_TOL, _record_logits

ATOL, RTOL = 1e-4, 1e-3
# <session>_<camera> -> scenes (one second each); drive_a's rear is shorter
AV_FILES = {"drive_a_front": 3, "drive_a_rear": 2, "drive_b_front": 4}
AV_ARGS = dict(clip_len_s=3.0, min_clip_len_s=0.5, extra_caption_variants=("short",), caption_window_frames=2,
               t5_packaging="e", clip_packaging=True)
STEPS = ("ingest", "split", "caption", "trajectory", "annotate", "package", "shard")
CLOCK_KEYS = ("elapsed_s", "timestamp", "pipeline_run_time_s", "video_hours_per_day_per_chip")


@pytest.fixture(scope="module")
def av_inputs(tmp_path_factory) -> Path:
    d = tmp_path_factory.mktemp("av_inputs")
    for stem, scenes in AV_FILES.items():
        make_scene_video(d / f"{stem}.mp4", scene_len_frames=24, num_scenes=scenes)
    (d / "notes.mp4").write_bytes(b"not <session>_<camera>")
    return d


@dataclasses.dataclass
class Models:
    """Both packages' caption engines and T5 encoders on the same
    parameters, and the logits of every greedy step each engine took."""

    j_engine: object
    t_engine: object
    j_t5: object
    t_t5: object
    j_trace: dict
    t_trace: dict


def make_models(max_batch: int = 8) -> Models:
    j_engine = JEngine(J_TINY, max_batch=max_batch)
    j_engine.setup(0)
    t_engine = CaptionEngine(VLM_TINY_TEST, max_batch=max_batch, params=flax_to_state_dict(j_engine.params),
                             device="cpu")
    t_engine.setup(0)
    j_t5 = jt5.T5EncoderTPU(jt5.T5_TINY_TEST)
    j_t5.setup()
    t_t5 = tt5.T5EncoderTPU(tt5.T5_TINY_TEST, params=flax_to_state_dict(j_t5._params), device="cpu")
    t_t5.setup()
    return Models(j_engine, t_engine, j_t5, t_t5, _record_logits(j_engine), _record_logits(t_engine))


@pytest.fixture(scope="module")
def fp32_t5_and_weights(tmp_path_factory):
    """Both T5 encoders in fp32; both registries on an empty root."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jt5, "T5Encoder", functools.partial(jt5.T5Encoder, dtype=jnp.float32))
    mp.setattr(tt5, "T5Encoder", functools.partial(tt5.T5Encoder, dtype=torch.float32))
    mp.setenv("CURATE_MODEL_WEIGHTS_DIR", str(tmp_path_factory.mktemp("weights")))
    mp.delenv("CURATE_RUNNER", raising=False)
    yield
    mp.undo()


@pytest.fixture(scope="module", autouse=True)
def _cv2_codec():
    from cosmos_curate_tpu.video import h264 as jh264
    from cosmos_curate_tpu_torch.video import h264 as th264

    mp = pytest.MonkeyPatch()
    mp.setattr(jh264, "_probe_result", False)
    mp.setattr(th264, "_probe_result", False)
    yield
    mp.undo()


def copy_differing_captions(j_db_path: str, t_db_path: str, compared: dict[str, bool]) -> None:
    """Where a request's comparison stopped at a near-tie, the JAX caption
    goes into the port's database, so the later steps get equal inputs."""
    j_db, t_db = jstate.AVStateDB(j_db_path), tstate.AVStateDB(t_db_path)
    try:
        for clip in j_db.clips():
            for variant, text in j_db.variant_captions(clip.clip_uuid).items():
                if not compared.get(request_id(clip.clip_uuid, variant), True):
                    t_db.set_caption(clip.clip_uuid, text, variant)
    finally:
        j_db.close()
        t_db.close()


def request_id(clip_uuid: str, variant: str, primary: str = "av") -> str:
    """The caption request behind a stored variant ('default#w1' ->
    '<uuid>::av::w1')."""
    base, k = tstate.parse_caption_variant(variant)
    return f"{clip_uuid}::{primary if base == 'default' else base}::w{k}"


def assert_captions_by_rule(j_trace: dict, t_trace: dict, j_db_path: str, t_db_path: str) -> dict[str, bool]:
    """The engine rule on every caption request; equal stored text where a
    request compared to its end. Returns request id -> compared fully."""
    assert set(t_trace) == set(j_trace) and j_trace
    full, steps = {}, {}
    for rid in sorted(j_trace):
        full[rid], steps[rid] = True, 0
        for step, (j, p) in enumerate(zip(j_trace[rid], t_trace[rid], strict=True)):
            assert np.abs(j - p).max() <= LOGIT_TOL, (rid, step)
            top2 = np.sort(j)[-2:]
            if top2[1] - top2[0] < 2 * LOGIT_TOL:
                full[rid] = False
                break
            assert int(np.argmax(j)) == int(np.argmax(p)), (rid, step)
            steps[rid] += 1
    j_db, t_db = jstate.AVStateDB(j_db_path), tstate.AVStateDB(t_db_path)
    try:
        for clip in j_db.clips(state="captioned"):
            want, got = j_db.variant_captions(clip.clip_uuid), t_db.variant_captions(clip.clip_uuid)
            assert set(got) == set(want)
            for variant, text in want.items():
                if full[request_id(clip.clip_uuid, variant)]:
                    assert got[variant] == text, (clip.clip_uuid, variant)
    finally:
        j_db.close()
        t_db.close()
    # the seeded tiny VLM's logits near-tie often, a request's first token
    # now and then: held to as many compared steps as requests (19 of them
    # over the 10 requests here)
    assert sum(steps.values()) >= len(steps), steps
    return full


def _sorted_dicts(rows) -> list[dict]:
    return sorted((dataclasses.asdict(r) for r in rows), key=lambda d: json.dumps(d, sort_keys=True))


def normalized_rows(db_path: str, root: Path) -> dict:
    """Every table's rows with the output root, run ids (by run type),
    clocks and the port's ``device`` parameter normalised."""
    db = tstate.AVStateDB(db_path)
    try:
        runs = db.runs()
        rows = {
            "sessions": sorted(db.sessions()),
            "clips": _sorted_dicts(db.clips()),
            "variants": {c.clip_uuid: db.variant_captions(c.clip_uuid) for c in db.clips()},
            "annotations": _sorted_dicts(db.caption_annotations()),
            "runs": _sorted_dicts(runs),
            "clipped": _sorted_dicts(db.clipped_sessions()),
            "spans": _sorted_dicts(db.video_spans()),
            "tags": _sorted_dicts(db.clip_tags()),
        }
    finally:
        db.close()
    text = json.dumps(rows, sort_keys=True).replace(str(root), "<root>")
    for run in runs:
        text = text.replace(run.run_uuid, f"<{run.run_type}-run>")
    out = json.loads(text)
    for run in out["runs"]:
        run["params"] = json.loads(run["params"])
        run["params"].pop("device", None)
    return out


def _summary(out: dict, run_uuids: dict) -> dict:
    text = json.dumps({k: v for k, v in out.items() if k not in CLOCK_KEYS}, sort_keys=True)
    for rid, label in run_uuids.items():
        text = text.replace(rid, label)
    return json.loads(text)


def run_steps(pkg: str, inputs: Path, root: Path, models: Models, steps=(*STEPS, "shard_h", "caption_again")) -> dict:
    """``steps`` of one package into ``root``; step -> summary."""
    av, traj = (jav, jtraj) if pkg == "jax" else (tav, ttraj)
    kw = dict(AV_ARGS, input_path=str(inputs), output_path=str(root))
    if pkg == "port":
        kw["device"] = "cpu"
    args = av.AVPipelineArgs(**kw)
    engine, encoder = (models.j_engine, models.j_t5) if pkg == "jax" else (models.t_engine, models.t_t5)
    runner = JSequentialRunner() if pkg == "jax" else SequentialRunner()
    calls = {
        "ingest": lambda: av.run_av_ingest(args),
        "split": lambda: av.run_av_split(args, runner=runner),
        "caption": lambda: av.run_av_caption(args, engine=engine),
        "trajectory": lambda: traj.run_av_trajectory(args),
        "annotate": lambda: av.run_av_annotate(args),
        "package": lambda: av.run_av_package(args, encoder=encoder),
        "shard": lambda: av.run_av_shard(args),
        "shard_h": lambda: av._shard_t5_packaging(dataclasses.replace(args, t5_packaging="h")),
        "caption_again": lambda: av.run_av_caption(args),
    }
    with preserved_observability_state():
        return {step: calls[step]() for step in steps}


@pytest.fixture(scope="module")
def av_runs(av_inputs, fp32_t5_and_weights, tmp_path_factory):
    """Both packages' seven steps; the port's captions are held to the rule
    before its later steps run, and where a caption could differ the JAX
    one is copied across first."""
    models = make_models()
    base = tmp_path_factory.mktemp("av_runs")
    roots = {pkg: base / pkg for pkg in ("jax", "port")}
    outs = {"jax": run_steps("jax", av_inputs, roots["jax"], models)}
    outs["port"] = run_steps("port", av_inputs, roots["port"], models, STEPS[:3])
    j_db, t_db = (jav.AVPipelineArgs(output_path=str(roots[pkg])).resolved_db for pkg in ("jax", "port"))
    compared = assert_captions_by_rule(models.j_trace, models.t_trace, j_db, t_db)
    copy_differing_captions(j_db, t_db, compared)
    outs["port"] |= run_steps("port", av_inputs, roots["port"], models, (*STEPS[3:], "shard_h", "caption_again"))
    return roots, outs, models, compared


def test_discover_sessions_matches_jax(av_inputs):
    assert tav.discover_sessions(str(av_inputs)) == jav.discover_sessions(str(av_inputs))
    assert set(tav.discover_sessions(str(av_inputs))["drive_a"]) == {"front", "rear"}


def test_step_summaries_match_jax(av_runs):
    roots, outs, _, _ = av_runs
    for pkg in outs:
        outs[pkg]["ingest"]["db"] = outs[pkg]["ingest"]["db"].replace(str(roots[pkg]), "<root>")
    labels = {pkg: {outs[pkg][s]["run_uuid"]: f"<{s}-run>" for s in ("split", "annotate")} for pkg in outs}
    for step in (*STEPS, "shard_h", "caption_again"):
        got, want = _summary(outs["port"][step], labels["port"]), _summary(outs["jax"][step], labels["jax"])
        if step == "caption":
            got.pop("tokens_per_s"), want.pop("tokens_per_s")
        if step == "shard":
            got["buckets"] = json.loads(json.dumps(got["buckets"]).replace(str(roots["port"]), "<root>"))
            want["buckets"] = json.loads(json.dumps(want["buckets"]).replace(str(roots["jax"]), "<root>"))
        assert got == want, step
    assert {k: outs["port"]["caption"][k] for k in ("num_captioned", "num_windows", "num_variants")} == \
        {"num_captioned": 4, "num_windows": 10, "num_variants": 2}
    assert outs["port"]["split"]["num_clips"] == 4 and outs["port"]["trajectory"]["num_trajectories"] == 4
    assert outs["port"]["caption_again"] == {"num_captioned": 0, "tokens_per_s": 0.0,
                                             "elapsed_s": outs["port"]["caption_again"]["elapsed_s"]}


def test_state_rows_match_jax(av_runs):
    roots, _, _, _ = av_runs
    got = normalized_rows(tav.AVPipelineArgs(output_path=str(roots["port"])).resolved_db, roots["port"])
    want = normalized_rows(jav.AVPipelineArgs(output_path=str(roots["jax"])).resolved_db, roots["jax"])
    assert got == want
    assert {c["state"] for c in got["clips"]} == {"packaged"}
    assert sorted(r["run_type"] for r in got["runs"]) == ["annotate", "split", "trajectory"]
    assert len(got["spans"]) == 4 and len(got["tags"]) == 4


def test_captions_follow_the_rule(av_runs):
    _, _, models, compared = av_runs
    # 4 clips: two 3-s clips caption 2 windows of the primary and 1 of the
    # extra variant, the 2-s and 1-s clips one window of each
    assert len(compared) == 10 and any(rid.endswith("::av::w1") for rid in compared)
    assert all(models.t_trace[rid] for rid in compared)


def _files(root: Path, prefix: str) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted((root / prefix).rglob("*")) if p.is_file()}


def test_trajectories_match_jax(av_runs):
    roots, _, _, _ = av_runs
    got, want = _files(roots["port"], "trajectories"), _files(roots["jax"], "trajectories")
    assert set(got) == set(want) and len(got) == 5
    for rel in want:
        if rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(io.BytesIO(got[rel])), np.load(io.BytesIO(want[rel])))
        else:
            assert json.loads(got[rel]) == json.loads(want[rel])


def _tar_members(data: bytes) -> dict[str, bytes]:
    with tarfile.open(fileobj=io.BytesIO(data)) as tf:
        return {m.name: tf.extractfile(m).read() for m in tf.getmembers()}


def _assert_pickles_close(got: bytes, want: bytes, what: str) -> None:
    g, w = pickle.loads(got), pickle.loads(want)
    g, w = (g if isinstance(g, list) else [g]), (w if isinstance(w, list) else [w])
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        assert np.asarray(a).dtype == np.asarray(b).dtype and np.asarray(a).shape == np.asarray(b).shape, what
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=what)


def test_t5_packaging_matches_jax(av_runs):
    """The predict2 pickles and both tar layouts: the same members, the
    same non-float bytes, embeddings within the fp32 bar."""
    roots, _, _, _ = av_runs
    got, want = _files(roots["port"], "datasets"), _files(roots["jax"], "datasets")
    assert set(got) == set(want)
    t5_tars = [rel for rel in want if "/t5_xxl/" in rel and rel.endswith(".tar")]
    # one e tar a clip-session: the session's span (a shorter camera's
    # clip spans a session of its own)
    assert len([r for r in t5_tars if "/part_" not in r]) == 4 and any("/part_" in r for r in t5_tars)
    for rel, data in want.items():
        if rel.endswith(".pkl"):
            _assert_pickles_close(got[rel], data, rel)
        elif rel.endswith(".tar"):
            members, j_members = _tar_members(got[rel]), _tar_members(data)
            assert list(members) == list(j_members), rel
            for name, blob in j_members.items():
                if name.endswith(".bin") and "/t5_xxl/" in rel:
                    _assert_pickles_close(members[name], blob, f"{rel}:{name}")
                else:
                    assert members[name] == blob, f"{rel}:{name}"
        else:
            assert got[rel] == data, rel  # clip mp4s and caption texts


def _normalized_json(root: Path, prefix: str) -> dict:
    out = {}
    for rel, data in _files(root, prefix).items():
        doc = json.loads(data)
        if isinstance(doc, dict) and "run_uuid" in doc:
            doc["run_uuid"] = "<annotate-run>"
        out[rel] = doc
    return out


def test_annotation_files_match_jax(av_runs):
    roots, _, _, _ = av_runs
    for prefix in ("processed_sessions", "processed_session_chunks"):
        got, want = _normalized_json(roots["port"], prefix), _normalized_json(roots["jax"], prefix)
        assert got == want and len(got) == 2, prefix
    metas = {r: d for r, d in _normalized_json(roots["port"], "metas").items() if not r.startswith("metas/v0/")}
    j_metas = {r: d for r, d in _normalized_json(roots["jax"], "metas").items() if not r.startswith("metas/v0/")}
    assert metas == j_metas and len(metas) == 4
    assert any(len(doc["captions"]["default"]) == 2 for doc in metas.values())


def test_shards_match_jax(av_runs):
    roots, _, _, _ = av_runs
    got, want = _files(roots["port"], "shards"), _files(roots["jax"], "shards")
    assert set(got) == set(want) and want
    for rel, data in want.items():
        if not rel.endswith(".tar"):
            index, j_index = (json.loads(d.decode().replace(str(roots[pkg]), "<root>"))
                              for d, pkg in ((got[rel], "port"), (data, "jax")))
            assert _summary(index, {}) == _summary(j_index, {}), rel
            continue
        members, j_members = _tar_members(got[rel]), _tar_members(data)
        assert list(members) == list(j_members), rel
        for name, blob in j_members.items():
            if name.endswith((".npy", ".pkl")):
                np.testing.assert_allclose(np.load(io.BytesIO(members[name])), np.load(io.BytesIO(blob)),
                                           atol=ATOL, rtol=RTOL)
            else:
                assert members[name] == blob, f"{rel}:{name}"


def test_resumed_caption_builds_no_engine(av_runs, monkeypatch):
    """Nothing left to caption: the step returns before it would build the
    (VLM_BASE) engine, in both packages."""
    roots, _, _, _ = av_runs

    def refuse(*a, **k):
        raise AssertionError("built an engine with nothing to caption")

    monkeypatch.setattr(tav, "CaptionEngine", refuse)
    got = tav.run_av_caption(tav.AVPipelineArgs(output_path=str(roots["port"]), device="cpu"))
    assert got["num_captioned"] == 0 and got["tokens_per_s"] == 0.0


# -- the trajectory program ---------------------------------------------------------


def _jax_surface(gray: np.ndarray) -> np.ndarray:
    """The JAX package's correlation surface (its ``_phase_correlate_pairs``
    up to the argmax)."""
    _, h, w = gray.shape
    x = jnp.asarray(gray)
    windowed = x * (jnp.hanning(h)[:, None] * jnp.hanning(w)[None, :])[None]
    f = jnp.fft.rfft2(windowed)
    cross = f[:-1] * jnp.conj(f[1:])
    cross = cross / jnp.maximum(jnp.abs(cross), 1e-9)
    return np.asarray(jnp.fft.irfft2(cross, s=(h, w)))


def _planted(shifts, hw=(64, 96), seed=0) -> np.ndarray:
    """uint8 frames of one random texture rolled by the cumulative planted
    (dy, dx) shifts."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (hw[0] * 2, hw[1] * 2, 3), np.uint8)
    frames, pos = [], np.zeros(2, int)
    for i in range(len(shifts) + 1):
        if i:
            pos += shifts[i - 1]
        frames.append(np.roll(base, tuple(pos), axis=(0, 1))[hw[0] // 2: hw[0] // 2 + hw[0],
                                                              hw[1] // 2: hw[1] // 2 + hw[1]])
    return np.stack(frames)


@pytest.mark.parametrize("shifts", [
    [(0, -3)] * 6, [(2, 1), (-1, 4), (0, 0), (5, -2), (3, 3)], [(0, 0)] * 3, [(-7, 11)],
], ids=["pan", "mixed", "still", "one-pair"])
def test_phase_correlation_matches_jax(shifts):
    frames = _planted(shifts)
    gray = frames.astype(np.float32).mean(axis=-1) / 255.0
    got = ttraj.phase_correlate_pairs(torch.from_numpy(gray)).numpy()
    want = np.asarray(jtraj._phase_correlate_pairs(jnp.asarray(gray)))
    np.testing.assert_array_equal(got, want)
    # the planted displacements, content moving by (dy, dx) reading as (-dx, -dy)
    np.testing.assert_array_equal(got, -np.asarray(shifts, np.float32)[:, ::-1])
    surface = ttraj.correlation_surface(torch.from_numpy(gray)).numpy()
    np.testing.assert_allclose(surface, _jax_surface(gray), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_estimate_trajectory_matches_jax(n):
    frames = _planted([(1, -2)] * (n - 1), seed=n) if n > 1 else _planted([], seed=1)
    got = ttraj.estimate_trajectory(frames, device="cpu")
    want = jtraj.estimate_trajectory(frames)
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype
            np.testing.assert_array_equal(got[key], value)
        else:
            assert got[key] == value, key


def test_trajectory_defaults_to_the_gpu(tmp_path):
    frames = _planted([(0, 1)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttraj.estimate_trajectory(frames)
    with pytest.raises(ValueError, match="writes locally"):
        ttraj.run_av_trajectory(tav.AVPipelineArgs(output_path="s3://bucket/out", device="cpu"))
