"""Port parity: the example pipelines (``pipelines/examples/``) on the CPU.

- ``run_hello_world``: the same texts and devices, scores within 1e-6 of
  the JAX package's (``ScoreStage``, the counterpart of its
  ``JaxScoreStage``: ``tanh(bytes / 128).mean(-1)`` in fp32), through both
  runners; on the GPU by default.
- ``run_chunking_demo``: the same tasks, chunk for chunk.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from cosmos_curate_tpu.pipelines.examples import chunking_demo as jchunk
from cosmos_curate_tpu.pipelines.examples import hello_world as jhello
from cosmos_curate_tpu_torch.core.pipelined_runner import PipelinedRunner
from cosmos_curate_tpu_torch.core.runner import SequentialRunner
from cosmos_curate_tpu_torch.pipelines.examples import chunking_demo as tchunk
from cosmos_curate_tpu_torch.pipelines.examples import hello_world as thello

TEXTS = [None, ["", "a", "héllo wörld", "x" * 200, "\x00\xff"]]


@pytest.mark.parametrize("texts", TEXTS, ids=["default", "edge"])
@pytest.mark.parametrize("runner", ["sequential", "pipelined"])
def test_hello_world_matches_jax(texts, runner):
    want = jhello.run_hello_world(texts)
    got = thello.run_hello_world(texts, runner=SequentialRunner() if runner == "sequential" else PipelinedRunner(),
                                 device="cpu")
    assert [(t.text, t.device) for t in got] == [(t.text, t.device) for t in want]
    assert len(got) == (10 if texts is None else len(texts))
    for g, w in zip(got, want, strict=True):
        assert abs(g.score - w.score) <= 1e-6, g.text
    assert [(f.name, f.default) for f in dataclasses.fields(thello.HelloTask)] == [
        (f.name, f.default) for f in dataclasses.fields(jhello.HelloTask)]


def test_hello_world_defaults_to_the_gpu():
    if torch.cuda.is_available():
        assert thello.ScoreStage().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            thello.run_hello_world()
    stage = thello.ScoreStage(device="cpu")
    assert stage.batch_size == 8 and not stage.resources.uses_gpu


@pytest.mark.parametrize("num_inputs", [1, 3])
def test_chunking_demo_matches_jax(num_inputs):
    want = jchunk.run_chunking_demo(num_inputs)
    got = tchunk.run_chunking_demo(num_inputs)
    assert [dataclasses.asdict(t) for t in got] == [dataclasses.asdict(t) for t in want]
    assert len(got) == 7 * num_inputs and [t.fraction for t in got] == [t.fraction for t in want]
    assert tchunk.ChunkStage().resources.cpus == jchunk.ChunkStage().resources.cpus == 0.25
