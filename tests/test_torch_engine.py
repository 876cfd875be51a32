"""Port parity: the caption engine.

- Against the JAX ``CaptionEngine`` on ``tiny-test``: the same bridged
  parameters, both in bf16 as both engines serve, the same crc32-seeded
  requests (frames, a shared text prefix, a long prompt that arrives while
  others decode and so prefills in chunks on the second lane). Greedy
  tokens must agree. Tolerance: the two frameworks' bf16 logits agree within
  ``LOGIT_TOL`` (observed <= 0.006 at |logit| ~ 0.5, where one bf16 ulp is
  0.004), which is asserted at every compared step; a step whose JAX top-2
  margin is below ``2 * LOGIT_TOL`` could flip either way, so the test says
  so and stops comparing that request there.
- Inside the port: the paged and gather program families give bit-equal
  tokens and pool contents on the CPU, with a fragmented block table.
- The pool is fully free after a drained shutdown.
- ``wait_prep_idle`` returns once the prep thread has taken every request.
"""

import zlib
from collections import defaultdict

import numpy as np
import pytest
import torch

from cosmos_curate_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
from cosmos_curate_tpu.models.vlm import CaptionEngine as JEngine
from cosmos_curate_tpu.models.vlm import CaptionRequest as JRequest
from cosmos_curate_tpu.models.vlm import SamplingConfig as JSampling
from cosmos_curate_tpu.models.vlm import VLM_TINY_TEST as J_TINY
from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict
from cosmos_curate_tpu_torch.models.tokenizer import ByteTokenizer
from cosmos_curate_tpu_torch.models.vlm import CaptionEngine, CaptionRequest, SamplingConfig, VLM_TINY_TEST

LOGIT_TOL = 0.01
PREFIX = "system: you are a terse captioner. user:"
LANES = ((80, 2), (128, 2))


def _request(req_cls, sampling_cls, tok, rid, text, frames=2, max_new=10):
    return req_cls(
        request_id=rid,
        prefix_ids=tok.encode(PREFIX),
        prompt_ids=tok.encode(text),
        frames=(
            np.random.default_rng(zlib.crc32(rid.encode())).integers(0, 255, (frames, 32, 32, 3), np.uint8)
            if frames
            else None
        ),
        sampling=sampling_cls(max_new_tokens=max_new),
    )


def _as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x).astype(np.float32)


def _record_logits(eng) -> dict:
    """request id -> the logits row each of its greedy tokens came from
    (first token from the prefill, the rest from decode steps)."""
    trace = defaultdict(list)
    pending = []
    start_slot, decode, decode_once = eng._start_slot, eng._decode, eng._decode_once

    def _start_slot(lane, slot_idx, req, t_valid, next_rope, logits_row):
        trace[req.request_id].append(_as_np(logits_row))
        return start_slot(lane, slot_idx, req, t_valid, next_rope, logits_row)

    def _decode(*args):
        out = decode(*args)
        pending.append(out[1])
        return out

    def _decode_once(lane):
        rows = {i: s.request.request_id for i, s in lane.slots.items()}
        decode_once(lane)
        logits = _as_np(pending.pop())
        for i, rid in rows.items():
            trace[rid].append(logits[i])

    eng._start_slot, eng._decode, eng._decode_once = _start_slot, _decode, _decode_once
    return trace


def _drive(eng, req_cls, sampling_cls, tok):
    """Three multimodal requests sharing a prefix; once they decode, a long
    text prompt joins and prefills in chunks on the long lane."""
    for rid, text in (("a", "describe"), ("b", "what happens here"), ("c", "hi")):
        eng.add_request(_request(req_cls, sampling_cls, tok, rid, text))
    eng.step()
    transcript = "the camera pans across the scene. " * 3
    eng.add_request(_request(req_cls, sampling_cls, tok, "long", transcript, frames=0))
    return {r.request_id: r.text for r in eng.run_until_complete()}


@pytest.fixture(scope="module")
def jax_engine():
    eng = JEngine(J_TINY, max_batch=4, kv_lanes=LANES, tokenizer=JByteTokenizer(), prefill_chunk=32)
    eng.setup(0)
    return eng


def test_greedy_tokens_match_jax_engine(jax_engine):
    port = CaptionEngine(
        VLM_TINY_TEST, max_batch=4, kv_lanes=LANES, tokenizer=ByteTokenizer(), prefill_chunk=32,
        params=flax_to_state_dict(jax_engine.params), device="cpu",
    )
    port.setup(0)
    jtrace = _record_logits(jax_engine)
    ptrace = _record_logits(port)
    jtext = _drive(jax_engine, JRequest, JSampling, JByteTokenizer())
    ptext = _drive(port, CaptionRequest, SamplingConfig, ByteTokenizer())
    assert set(jtext) == set(ptext) == {"a", "b", "c", "long"}
    assert port.stats()["prefill_tokens"] == jax_engine.stats()["prefill_tokens"]
    compared = 0
    for rid in sorted(jtext):
        full = True
        for step, (j, p) in enumerate(zip(jtrace[rid], ptrace[rid], strict=True)):
            assert np.abs(j - p).max() <= LOGIT_TOL, (rid, step)
            top2 = np.sort(j)[-2:]
            if top2[1] - top2[0] < 2 * LOGIT_TOL:
                print(f"{rid}: step {step} JAX top-2 margin {top2[1] - top2[0]:.4f} "
                      f"< {2 * LOGIT_TOL}; not comparing further")
                full = False
                break
            assert int(np.argmax(j)) == int(np.argmax(p)), (rid, step)
            compared += 1
        if full:
            assert ptext[rid] == jtext[rid]
    assert compared >= 20


def _gnarly_engine(mode, params=None):
    eng = CaptionEngine(
        VLM_TINY_TEST, max_batch=4, kv_lanes=((64, 2), (128, 2)), tokenizer=ByteTokenizer(),
        prefill_chunk=32, paged_attention=mode, params=params, device="cpu",
    )
    eng.setup(0)
    # punch holes so tables interleave recycled and fresh blocks
    held = eng._allocator.alloc(9)
    eng._allocator.decref(held[::2])
    return eng


def test_paged_and_gather_engines_bit_equal_with_fragmented_tables():
    paged = _gnarly_engine("auto")
    gather = _gnarly_engine("gather", paged.model.state_dict())
    ptrace, gtrace = _record_logits(paged), _record_logits(gather)
    tok = ByteTokenizer()
    ptext = _drive(paged, CaptionRequest, SamplingConfig, tok)
    gtext = _drive(gather, CaptionRequest, SamplingConfig, tok)
    assert ptext == gtext
    for rid in ptrace:
        for p, g in zip(ptrace[rid], gtrace[rid], strict=True):
            np.testing.assert_array_equal(p, g)
    # every block but the garbage block 0 holds the same bits
    assert torch.equal(paged._pool_k[:, 1:], gather._pool_k[:, 1:])
    assert torch.equal(paged._pool_v[:, 1:], gather._pool_v[:, 1:])
    assert paged.paged_kernel_steps > 0 and gather.paged_kernel_steps == 0
    tables_seen = [b for lane in paged.lanes for b in lane.table.ravel().tolist()]
    assert tables_seen == [0] * len(tables_seen)  # all released


def test_pool_fully_free_after_drain_and_shutdown():
    eng = CaptionEngine(
        VLM_TINY_TEST, max_batch=2, kv_lanes=((128, 2),), tokenizer=ByteTokenizer(), device="cpu",
        async_prep=True,
    )
    eng.setup(0)
    tok = ByteTokenizer()
    for i in range(3):
        eng.add_request(_request(CaptionRequest, SamplingConfig, tok, f"r{i}", "describe", max_new=4))
    results = eng.run_until_complete()
    assert sorted(r.request_id for r in results) == ["r0", "r1", "r2"]
    assert eng.prefix_cache_hits >= 2
    eng.shutdown()
    assert eng.kv_blocks_used == 0
    assert eng._allocator.free_blocks == eng.kv_blocks_total


def test_wait_prep_idle_returns_once_prep_has_taken_every_request():
    eng = CaptionEngine(
        VLM_TINY_TEST, max_batch=2, kv_lanes=((128, 2),), tokenizer=ByteTokenizer(), device="cpu",
        async_prep=True,
    )
    eng.setup(0)
    assert eng.wait_prep_idle(timeout=0.0)  # nothing queued
    tok = ByteTokenizer()
    for i in range(3):
        eng.add_request(_request(CaptionRequest, SamplingConfig, tok, f"r{i}", "describe", max_new=2))
    assert eng.wait_prep_idle(timeout=60.0)
    assert not eng.waiting and eng._prep_inflight is None
    assert sorted(p.request.request_id for p in eng._ready) == ["r0", "r1", "r2"]
    assert sorted(r.request_id for r in eng.run_until_complete()) == ["r0", "r1", "r2"]
    eng.shutdown()


def test_engine_refuses_mesh_and_unknown_mode():
    with pytest.raises(NotImplementedError, match="mesh"):
        CaptionEngine(VLM_TINY_TEST, device="cpu", mesh=object())
    for mode in ("bogus", "kernel"):
        with pytest.raises(ValueError, match="auto\\|gather"):
            CaptionEngine(VLM_TINY_TEST, device="cpu", paged_attention=mode)
