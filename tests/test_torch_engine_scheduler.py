"""The port's copy of the caption engine's host scheduler, on the CPU.

The scheduler is copied from the JAX engine rather than imported, so these
tests hold the copy to the reference engine's own behavioural tests
(tests/models/test_vlm_engine.py, test_paged_kv.py, test_prefix_cache.py,
test_sampling.py), case for case, at ``tiny-test`` size: lanes and
routing, chunked prefill, the refcounted shared-prefix blocks with
copy-on-write and deferred frees, pool backpressure, owners, refinement
follow-ups, host sampling and async prep. Greedy texts must not depend on
the scheduling geometry: decode rows are independent.
"""

import threading
import zlib

import numpy as np
import pytest
import torch

import cosmos_curate_tpu_torch.models.vlm.model as vlm_model
from cosmos_curate_tpu_torch.models.tokenizer import ByteTokenizer
from cosmos_curate_tpu_torch.models.vlm import (
    CaptionEngine,
    CaptionRequest,
    SamplingConfig,
    VLM_TINY_TEST,
)
from cosmos_curate_tpu_torch.ops._build import KernelInputError, KernelLaunchError

TOK = ByteTokenizer()
PREFIX = "system: you are a terse captioner. user:"


def _engine(**kw):
    kw.setdefault("max_batch", 4)
    eng = CaptionEngine(VLM_TINY_TEST, tokenizer=TOK, device="cpu", **kw)
    eng.setup(0)
    return eng


def _req(rid, text="describe", prefix=PREFIX, frames=2, max_new=6, **kw):
    return CaptionRequest(
        request_id=rid,
        prefix_ids=TOK.encode(prefix) if prefix else [],
        prompt_ids=TOK.encode(text),
        frames=(
            np.random.default_rng(zlib.crc32(rid.encode())).integers(0, 255, (frames, 32, 32, 3), np.uint8)
            if frames
            else None
        ),
        sampling=kw.pop("sampling", SamplingConfig(max_new_tokens=max_new)),
        **kw,
    )


def _drain(eng, reqs):
    for r in reqs:
        eng.add_request(r)
    return {r.request_id: r.text for r in eng.run_until_complete()}


@pytest.fixture(scope="module")
def full():
    """Single worst-case lane, no prefix cache, unchunked: the reference
    geometry the others must match."""
    return _engine(enable_prefix_cache=False)


def test_requires_setup():
    eng = CaptionEngine(VLM_TINY_TEST, max_batch=2, device="cpu")
    eng.add_request(_req("x"))
    with pytest.raises(RuntimeError, match="setup"):
        eng.step()


def test_long_text_prompt_keeps_its_tail(full):
    got = _drain(full, [_req("long", text="x" * 500, prefix="", frames=0, max_new=4)])
    assert list(got) == ["long"]


@pytest.mark.parametrize(
    "geometry",
    [
        dict(kv_lanes=((64, 2), (128, 2)), prefill_chunk=16),
        dict(kv_lanes=((32, 2), (64, 2), (128, 4))),
        dict(prefill_chunk=8, enable_prefix_cache=False),
    ],
)
def test_greedy_text_independent_of_geometry(full, geometry):
    """Lanes, chunk size and the prefix cache change where K/V live and in
    which programs they are written, never the greedy text."""
    reqs = lambda: [  # noqa: E731
        _req("g0", text="tiny"),
        _req("g1", text="medium prompt here"),
        _req("g2", text="l " * 30, frames=0),
    ]
    assert _drain(_engine(**geometry), reqs()) == _drain(full, reqs())


def test_chunked_only_while_decoding():
    eng = _engine(prefill_chunk=8)
    eng.add_request(_req("c0", text="a " * 40, prefix="", frames=0, max_new=4))
    eng.step()
    assert not eng.pending, "an idle engine prefills the long prompt in one go"
    eng.run_until_complete()
    eng.add_request(_req("s0", text="hi", prefix="", frames=0, max_new=30))
    eng.step()
    assert eng.slots and not eng.pending
    eng.add_request(_req("c1", text="b " * 40, prefix="", frames=0, max_new=4))
    eng.step()
    assert eng.pending, "a long prompt chunks while decode is active"
    decoded_while_pending = 0
    while eng.pending and 0 in eng.slots:
        before = len(eng.slots[0].generated)
        eng.step()
        decoded_while_pending += 0 in eng.slots and len(eng.slots[0].generated) > before
    assert decoded_while_pending >= 2, "decode advanced while the prefill was pending"
    assert sorted(r.request_id for r in eng.run_until_complete()) == ["c1", "s0"]


def test_lane_routing():
    """A short request joins the ACTIVE long lane while it has slots to
    spare, but never takes its last free slot; an idle engine routes to the
    smallest lane that fits."""
    long_req = lambda: _req("long", text="w " * 40, prefix="", frames=0, max_new=8)  # noqa: E731
    short_req = lambda: _req("short", text="hi", prefix="", frames=0, max_new=4)  # noqa: E731
    for long_slots, short_joins_long in ((3, True), (2, False)):
        eng = _engine(kv_lanes=((64, 2), (128, long_slots)))
        eng.add_request(long_req())
        eng.step()
        short_lane, long_lane = eng.lanes
        eng.add_request(short_req())
        eng.step()
        in_long = len(long_lane.slots) + len(long_lane.pending)
        in_short = len(short_lane.slots) + len(short_lane.pending)
        assert (in_long, in_short) == ((2, 0) if short_joins_long else (1, 1))
        assert {r.request_id for r in eng.run_until_complete()} == {"long", "short"}
    eng = _engine(kv_lanes=((64, 2), (128, 2)))
    eng.add_request(short_req())
    eng.step()
    assert len(eng.lanes[0].slots) == 1 and not eng.lanes[1].slots


def test_overflow_waits_for_a_free_slot():
    eng = _engine(kv_lanes=((64, 1),))
    got = _drain(eng, [_req(f"q{i}", text="abc", prefix="", frames=0, max_new=4) for i in range(3)])
    assert sorted(got) == ["q0", "q1", "q2"]


def test_owners_get_only_their_completions():
    eng = _engine()
    results = {}

    def stage(name, n):
        for i in range(n):
            eng.add_request(_req(f"{name}-{i}", text=f"{name} {i}", max_new=4))
        results[name] = eng.run_until_complete()

    threads = [threading.Thread(target=stage, args=("sa", 4)), threading.Thread(target=stage, args=("sb", 3))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert sorted(r.request_id for r in results["sa"]) == [f"sa-{i}" for i in range(4)]
    assert sorted(r.request_id for r in results["sb"]) == [f"sb-{i}" for i in range(3)]
    assert not eng.completed and not eng.slots and not eng.waiting
    eng.add_request(_req("oa"), owner="A")
    eng.add_request(_req("ob"), owner="B")
    assert [r.request_id for r in eng.run_until_complete(owner="A")] == ["oa"]
    assert [r.request_id for r in eng.run_until_complete(owner="B")] == ["ob"]


def test_prefix_blocks_are_referenced_with_copy_on_write_tail(full):
    eng = _engine(kv_lanes=((64, 2), (128, 2)))
    pre = "system: reference, do not copy, these tokens. user:"
    tp = len(TOK.encode(pre))
    n_full = tp // eng.block_size
    assert n_full >= 1 and tp % eng.block_size, "the case needs a partial tail block"
    reqs = lambda: [_req(f"c{i}", prefix=pre, text=f"v{i}") for i in range(3)]  # noqa: E731
    assert _drain(eng, reqs()) == _drain(full, reqs())
    assert eng.prefix_copy_dispatches == 0
    assert eng.prefix_block_refs == 3 * n_full
    assert eng.kv_cow_copies == 3
    assert eng.prefix_tokens_saved == tp * 2  # the first request builds it


def test_eviction_defers_free_while_referenced(full):
    """Evicting a prefix whose blocks an in-flight slot maps must not free
    them: the slot decodes against intact K/V, and the blocks free at its
    release."""
    eng = _engine(max_batch=2, kv_lanes=((128, 2),), prefix_cache_size=1)
    pre_a = "system: the first shared prefix text. user:"
    pre_b = "system: a second, different prefix. user:"
    eng.add_request(_req("a", prefix=pre_a, text="go", max_new=48, frames=0))
    eng.step()
    entry = next(iter(eng._prefix_cache.values()))
    shared = entry.blocks[: entry.n_full]
    assert all(eng._allocator.ref(b) == 2 for b in shared)  # LRU + slot
    eng.add_request(_req("b", prefix=pre_b, text="hm", max_new=2, frames=0))
    got = {r.request_id: r.text for r in eng.run_until_complete()}
    assert tuple(TOK.encode(pre_a)) not in eng._prefix_cache
    live = next(iter(eng._prefix_cache.values()))
    assert eng.kv_blocks_used == len(live.blocks)
    want = _drain(full, [_req("a", prefix=pre_a, text="go", max_new=48, frames=0)])
    assert got["a"] == want["a"]


def test_pool_exhaustion_backpressures_admission():
    eng = _engine(kv_lanes=((128, 4),), enable_prefix_cache=False, kv_pool_blocks=1 + 2 * 8)
    assert eng.kv_blocks_total == 4 * 8  # floored at the lane sum
    got = _drain(eng, [_req(f"p{i}", text="x " * 40, prefix="", max_new=8, frames=0) for i in range(4)])
    assert sorted(got) == [f"p{i}" for i in range(4)]


def test_prefix_hoarding_an_idle_pool_does_not_deadlock():
    eng = _engine(max_batch=1, kv_lanes=((128, 1),), kv_pool_blocks=1 + 8)
    got = _drain(eng, [_req("h", text="x " * 28, max_new=24, frames=0)])
    assert got["h"]
    eng.shutdown()
    assert eng.kv_blocks_used == 0


def test_kv_reservation_below_worst_case():
    eng = _engine(kv_lanes=((64, 2), (128, 2)))
    _drain(eng, [_req(f"k{i}", text="w " * 15, max_new=4) for i in range(2)])
    assert 0 < eng.kv_bytes_reserved_per_request < eng.kv_bytes_worstcase_per_request


def test_refinement_reuses_vision_features():
    """A follow-up over the SAME frames array skips the vision tower and
    yields the text a fresh encode of a copy yields."""

    def run(reuse: bool):
        eng = _engine()
        frames = np.random.default_rng(7).integers(0, 255, (2, 32, 32, 3), np.uint8)
        follow = []

        def on_complete(text, _depth=[0]):
            if _depth[0]:
                follow.append(text)
                return None
            _depth[0] += 1
            return CaptionRequest(
                request_id="w0",
                prefix_ids=TOK.encode(PREFIX),
                prompt_ids=TOK.encode("refine: " + text),
                frames=frames if reuse else frames.copy(),
                sampling=SamplingConfig(max_new_tokens=6),
                on_complete=on_complete,
                share_prefix=False,
            )

        eng.add_request(
            CaptionRequest(
                request_id="w0",
                prefix_ids=TOK.encode(PREFIX),
                prompt_ids=TOK.encode("describe"),
                frames=frames,
                sampling=SamplingConfig(max_new_tokens=6),
                on_complete=on_complete,
            )
        )
        results = eng.run_until_complete()
        assert [r.request_id for r in results] == ["w0"]
        return follow[0], eng.vision_encodes, eng.vision_reuses

    text_reused, encodes, reuses = run(True)
    text_fresh, encodes_fresh, reuses_fresh = run(False)
    assert (encodes, reuses) == (1, 1)
    assert (encodes_fresh, reuses_fresh) == (2, 0)
    assert text_reused == text_fresh


def test_host_sampling_paths():
    """min_tokens suppresses EOS, a stop string truncates, and a pinned
    seed reproduces a request's draws whatever rides beside it."""
    eng = _engine(max_batch=4)
    got = {}
    for rid, sampling in (
        ("min", SamplingConfig(max_new_tokens=12, min_tokens=6)),
        ("probe", SamplingConfig(max_new_tokens=24)),
    ):
        eng.add_request(_req(rid, prefix="", frames=0, sampling=sampling))
        (got[rid],) = eng.run_until_complete()
    assert got["min"].num_output_tokens >= 6
    probe = got["probe"]
    if len(probe.text) >= 4:
        stop = probe.text[2:4]
        sampling = SamplingConfig(max_new_tokens=24, stop=(stop,))
        eng.add_request(_req("stopped", prefix="", frames=0, sampling=sampling))
        (res,) = eng.run_until_complete()
        assert stop not in res.text and res.num_output_tokens <= probe.num_output_tokens

    def pinned(riders: int) -> str:
        e = _engine(max_batch=4)
        for j in range(riders):
            e.add_request(_req(f"rider{j}", prefix="", frames=0,
                               sampling=SamplingConfig(max_new_tokens=6, temperature=1.0)))
        e.add_request(_req("pinned", prefix="", frames=0,
                           sampling=SamplingConfig(max_new_tokens=8, temperature=1.0, seed=0)))
        return {r.request_id: r.text for r in e.run_until_complete()}["pinned"]

    assert pinned(0) == pinned(2)


def test_async_prep_matches_sync_and_packs_the_burst(full):
    eng = _engine(async_prep=True, admission_linger_s=0.3)
    try:
        reqs = lambda: [_req(f"r{i}", text=f"clip {i}") for i in range(4)]  # noqa: E731
        assert _drain(eng, reqs()) == _drain(full, reqs())
        assert eng.decode_slot_utilization > 0.9
    finally:
        eng.shutdown()
    assert eng.kv_blocks_used == 0


@pytest.mark.parametrize(
    "op, when, fault, async_prep",
    [
        # a paged prefill group: the scheduler would otherwise retry each
        # request alone and drop it
        ("paged_attention", "prefill", KernelLaunchError, False),
        ("paged_attention", "decode", KernelLaunchError, False),
        ("paged_attention", "prefill", KernelInputError, False),
        ("paged_attention", "prefill", torch.AcceleratorError, False),
        # the shared-prefix build runs inside request prep, inline or on the
        # prep thread
        ("prefill_attention", "prefix", KernelLaunchError, False),
        ("prefill_attention", "prefix", KernelLaunchError, True),
    ],
)
def test_device_faults_propagate_instead_of_dropping_requests(monkeypatch, op, when, fault, async_prep):
    """A kernel that fails on the card fails the caller's drive: the
    scheduler's per-request drop handlers must not turn it into missing
    results and log lines."""
    real = getattr(vlm_model, op)

    def failing(q, *args, **kw):
        if when != "decode" or q.shape[1] == 1:
            raise fault(f"{op}: injected device fault")
        return real(q, *args, **kw)

    monkeypatch.setattr(vlm_model, op, failing)
    eng = _engine(async_prep=async_prep)
    try:
        for i in range(2):
            eng.add_request(_req(f"f{i}", text=f"clip {i}", frames=0))
        with pytest.raises(fault, match="injected device fault"):
            eng.run_until_complete()
        assert not eng.completed
        with pytest.raises(fault):  # the engine stays failed
            eng.step()
        with pytest.raises(fault):
            eng.run_until_complete()
    finally:
        eng.shutdown()
