"""Port parity: the five trainers (``models/{tracker,transnet,ocr,sr,
diffusion_sr}_train.py``), their shared optimizers and the checkpoint
writer against the JAX package, on the CPU.

Inputs come from numpy seeds; initial weights are the JAX package's seeded
init, carried over through ``models/convert_jax.py``; small configs.

- **Synthesizers** and the OCR golden fixtures: bit-equal arrays for the
  same numpy seed.
- **Checkpoint format**: ``registry.save_params`` writes the bytes of the
  JAX package's ``save_params`` (flax's ``to_bytes``) for the same tree,
  chunked arrays included; ``state_dict_to_flax`` inverts
  ``flax_to_state_dict`` exactly on each trained model's JAX init.
- **One step's loss and gradients**: the JAX side takes
  ``jax.value_and_grad`` of the loss the trainer writes (its step closure is
  not importable, so the test writes it the same way); the port side its
  loss function and ``backward``. fp32 models (the tracker, the OCR pair,
  TransNet at ``dtype=float32`` in both): loss and every gradient leaf
  within atol 1e-5 / rtol 1e-4 (``FP32_ATOL``, ``FP32_RTOL``). SR and
  diffusion SR: their JAX convs are bf16 with no fp32 switch, so the port
  keeps bf16 too. The loss is held within ``BF16_SHARE`` (2e-2) of the
  JAX one, the share ``tests/test_torch_super_resolution.py`` holds both
  models' outputs to (it measured up to 6.7e-3 on the denoiser). A
  gradient sums over every pixel, so bf16 rounding reaches it larger: each
  gradient leaf is held within ``BF16_GRAD_SHARE`` (5e-2) of its scale
  (the leaf's largest magnitude in an fp32 run of the same step, the
  port's at ``compute_dtype=float32``, floored at 1e-2 of the whole
  tree's largest, since some leaves are zero up to rounding: a bias ahead
  of a norm, the key bias under a softmax) against that fp32 run, and
  against the JAX gradient (measured: up to 2.8e-2 and 2.0e-2 of scale).
  The bf16 convs' biases are held against the fp32 run only: the JAX
  package sums their gradient in bf16 over every output pixel, 20-35% off
  the fp32 run on SR where the port's is within 2.5%
  (``test_jax_bf16_conv_bias_gradients_are_the_divergent_side``).
  Diffusion takes the JAX draws of ``ts`` and ``eps`` on both sides.
- **Optimizers**: three steps from identical gradients give
  ``optax.adamw(lr)`` / ``optax.adam(lr)``'s parameters to atol 1e-6.
"""

from __future__ import annotations

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cosmos_curate_tpu.models import diffusion_sr as jdiff
from cosmos_curate_tpu.models import diffusion_sr_train as jdiff_train
from cosmos_curate_tpu.models import ocr as jocr
from cosmos_curate_tpu.models import ocr_train as jocr_train
from cosmos_curate_tpu.models import registry as jregistry
from cosmos_curate_tpu.models import sr_train as jsr_train
from cosmos_curate_tpu.models import super_resolution as jsr
from cosmos_curate_tpu.models import tracker_learned as jtracker
from cosmos_curate_tpu.models import tracker_train as jtracker_train
from cosmos_curate_tpu.models import transnet_train as jtransnet_train
from cosmos_curate_tpu.models import transnetv2 as jtransnet
from cosmos_curate_tpu_torch.models import diffusion_sr as tdiff
from cosmos_curate_tpu_torch.models import diffusion_sr_train as tdiff_train
from cosmos_curate_tpu_torch.models import ocr as tocr
from cosmos_curate_tpu_torch.models import ocr_train as tocr_train
from cosmos_curate_tpu_torch.models import registry as tregistry
from cosmos_curate_tpu_torch.models import sr_train as tsr_train
from cosmos_curate_tpu_torch.models import super_resolution as tsr
from cosmos_curate_tpu_torch.models import tracker_learned as ttracker
from cosmos_curate_tpu_torch.models import tracker_train as ttracker_train
from cosmos_curate_tpu_torch.models import train_common
from cosmos_curate_tpu_torch.models import transnet_train as ttransnet_train
from cosmos_curate_tpu_torch.models import transnetv2 as ttransnet
from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict, state_dict_to_flax

FP32_ATOL, FP32_RTOL = 1e-5, 1e-4
BF16_SHARE = 2e-2
BF16_GRAD_SHARE = 5e-2
GRAD_FLOOR = 1e-2
OPT_ATOL = 1e-6

TRACKER_CFG = (jtracker.SiameseConfig(features=8), ttracker.SiameseConfig(features=8))
TRANSNET_CFG = (jtransnet.TransNetConfig(filters=(4,), dilations=(1, 2), head_dim=16), ttransnet.TRANSNET_TINY_TEST)
DET_CFG = (jocr.DetectorConfig(height=32, width=64, base_filters=4),
           tocr.DetectorConfig(height=32, width=64, base_filters=4))
REC_CFG = (jocr.RecognizerConfig(base_filters=4, hidden=16), tocr.RecognizerConfig(base_filters=4, hidden=16))
SR_CFG = (jsr.SRConfig(channels=8, blocks=1), tsr.SR_TINY_TEST)
DIFF_CFG = (jdiff.DIFF_SR_TINY_TEST, tdiff.DIFF_SR_TINY_TEST)


def _np_tree(tree):
    tree = flax.core.unfreeze(tree) if isinstance(tree, flax.core.FrozenDict) else tree
    return jax.tree_util.tree_map(np.asarray, flax.linen.unbox(tree))


def assert_trees_equal(got: dict, want: dict, path: str = "") -> None:
    """Exactly the same keys, dtypes and values."""
    assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            w = np.asarray(want[k])
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, f"{path}/{k}"
            np.testing.assert_array_equal(got[k], w, err_msg=f"{path}/{k}")


def assert_trees_close(got: dict, want: dict, *, share: float | None = None, path: str = "") -> None:
    """fp32 bounds, or with ``share`` each leaf within that share of its
    largest magnitude."""
    assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_close(got[k], want[k], share=share, path=f"{path}/{k}")
            continue
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        if share is None:
            np.testing.assert_allclose(g, w, atol=FP32_ATOL, rtol=FP32_RTOL, err_msg=f"{path}/{k}")
        else:
            scale = max(float(np.abs(w).max()), 1e-12)
            err = float(np.abs(g - w).max())
            assert err <= share * scale, f"{path}/{k}: {err} above {share} x {scale}"


def port_grads(module: torch.nn.Module, loss_fn) -> tuple[float, dict]:
    """(loss, the gradient tree in flax's names) of ``loss_fn()``."""
    module.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    grads = {name: p.grad for name, p in module.named_parameters()}
    return float(loss.detach()), state_dict_to_flax(module, grads)


def crossed(module: torch.nn.Module, jparams) -> torch.nn.Module:
    module.load_state_dict(flax_to_state_dict(_np_tree(jparams)))
    return module


# --------------------------------------------------------------------- synthesizers


def _same(got, want) -> None:
    got, want = (got, want) if isinstance(want, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["transnet", "tracker", "ocr_detector", "ocr_recognizer", "sr", "diffusion_sr",
                                  "golden_eval_frames", "golden_rec_sample"])
def test_synthesizers_are_bit_equal(name):
    calls = {
        "transnet": (jtransnet_train.synthesize_batch, ttransnet_train.synthesize_batch, (3, 16), {}),
        "tracker": (jtracker_train.synthesize_pair_batch, ttracker_train.synthesize_pair_batch, (4,),
                    {"cfg": None}),
        "ocr_detector": (jocr_train.synthesize_detector_batch, tocr_train.synthesize_detector_batch, (4,),
                         {"cfg": "det"}),
        "ocr_recognizer": (jocr_train.synthesize_recognizer_batch, tocr_train.synthesize_recognizer_batch, (6,),
                           {"cfg": "rec"}),
        "sr": (jsr_train.synthesize_batch, tsr_train.synthesize_batch, (6, 32, 2), {}),
        "diffusion_sr": (jdiff_train.synthesize_windows, tdiff_train.synthesize_windows, (3, 4, 16, 2), {}),
    }
    if name == "golden_eval_frames":
        _same(tocr_train.golden_eval_frames(), jocr_train.golden_eval_frames())
        return
    if name == "golden_rec_sample":
        for text in ("HELLO 42", "subscribe now!"):
            _same(tocr_train.golden_rec_sample(text), jocr_train.golden_rec_sample(text))
        return
    jfn, tfn, args, kw = calls[name]
    cfgs = {None: (jtracker.SiameseConfig(), ttracker.SiameseConfig()), "det": (jocr.DetectorConfig(),
            tocr.DetectorConfig()), "rec": (jocr.RecognizerConfig(), tocr.RecognizerConfig())}
    for seed in (0, 7):
        jkw, tkw = {}, {}
        if "cfg" in kw:
            jkw["cfg"], tkw["cfg"] = cfgs[kw["cfg"]]
        want = jfn(np.random.default_rng(seed), *args, **jkw)
        got = tfn(np.random.default_rng(seed), *args, **tkw)
        _same(got, want)


# --------------------------------------------------------------------- the checkpoint format


def _random_tree(rng) -> dict:
    """A nested tree in a non-sorted insertion order, with the leaf kinds a
    checkpoint holds."""
    return {"params": {
        "zeta": {"kernel": rng.standard_normal((3, 4)).astype(np.float32),
                 "bias": rng.standard_normal(4).astype(np.float32)},
        "Conv_10": {"kernel": rng.standard_normal((3, 3, 2, 5)).astype(np.float32)},
        "Conv_2": {"kernel": rng.standard_normal((1, 1, 5, 2)).astype(np.float32)},
        "alpha": rng.standard_normal((2, 1, 3)).astype(np.float32),
        "ids": np.arange(5, dtype=np.int32),
        "empty": np.zeros((0, 3), np.float32),
        "scalar": np.float32(0.5),
    }}


def test_save_params_bytes_equal_flax(tmp_path):
    tree = _random_tree(np.random.default_rng(0))
    want = jregistry.save_params("m", tree, root=tmp_path / "jax").read_bytes()
    path = tregistry.save_params("m", tree, root=tmp_path / "port")
    assert path == tmp_path / "port" / "m" / "params.msgpack"
    assert path.read_bytes() == want
    assert not list(path.parent.glob("*.tmp"))  # published by rename
    assert_trees_equal(tregistry.read_flax_msgpack(want), jax.tree_util.tree_map(np.asarray, tree))


def test_save_params_chunks_large_arrays_as_flax_does(tmp_path, monkeypatch):
    """Arrays above flax's chunk size go as flat chunks: the same bytes at a
    chunk size shrunk to 64 bytes in both packages (an array of 40 floats
    splits into 3 chunks of 16, 16 and 8), and the reader rejoins them."""
    import flax.serialization

    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(tregistry, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"params": {"big": {"kernel": rng.standard_normal((5, 8)).astype(np.float32)},
                       "small": rng.standard_normal(4).astype(np.float32)}}
    want = jregistry.save_params("m", tree, root=tmp_path / "jax").read_bytes()
    got = tregistry.save_params("m", tree, root=tmp_path / "port").read_bytes()
    assert got == want and b"__msgpack_chunked_array__" in got
    assert_trees_equal(tregistry.read_flax_msgpack(got), tree)


def test_save_params_streams_large_arrays_with_flax_bytes(tmp_path):
    """Arrays of 64 KiB or more go to the file straight from their memory (a
    transposed or reversed view through one C-order copy), with the bytes of
    the JAX package's ``save_params``."""
    rng = np.random.default_rng(2)
    tree = {"params": {
        "dense": {"kernel": rng.standard_normal((96, 256)).astype(np.float32).T,
                  "bias": rng.standard_normal(96).astype(np.float32)},
        "ids": np.arange(1 << 15, dtype=np.int64)[::-1],
        "half": rng.standard_normal((128, 512)).astype(np.float16),
    }}
    want = jregistry.save_params("m", tree, root=tmp_path / "jax").read_bytes()
    got = tregistry.save_params("m", tree, root=tmp_path / "port").read_bytes()
    assert got == want
    assert_trees_equal(tregistry.read_flax_msgpack(got), tree)


def test_checkpoint_reader_matches_msgpack(tmp_path, monkeypatch):
    """The reader gives the tree that flax's own msgpack restore gives:
    large and small arrays, a bf16 leaf (widened to fp32: numpy has no
    bfloat16), a numpy scalar and a chunked array."""
    import flax.serialization

    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 1 << 12)
    rng = np.random.default_rng(3)
    tree = {"params": {
        "big": rng.standard_normal((64, 300)).astype(np.float32),
        "chunked": rng.standard_normal(2000).astype(np.float32),
        "bf16": jnp.asarray(rng.standard_normal((4, 8)), dtype=jnp.bfloat16),
        "ids": np.arange(7, dtype=np.int32),
        "scalar": np.float32(0.25),
    }}
    data = jregistry.save_params("m", tree, root=tmp_path).read_bytes()
    want = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 else np.asarray(x),
        flax.serialization.msgpack_restore(data))
    assert_trees_equal(tregistry.read_flax_msgpack(data), want)


@pytest.mark.parametrize("shape", [(16, 1), (1, 8), (3, 1, 2, 4)])
def test_flax_to_state_dict_returns_new_tensors(shape):
    """Every leaf comes back as a new contiguous fp32 tensor, never a view
    of the tree's memory: a kernel whose transpose is already contiguous
    (a size-1 axis), a read-only leaf as a read checkpoint has, and a
    reversed view."""
    from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict

    rng = np.random.default_rng(4)
    kernel = rng.standard_normal(shape).astype(np.float32)
    kernel.flags.writeable = False
    bias = rng.standard_normal(shape[-1]).astype(np.float32)[::-1]
    sd = flax_to_state_dict({"params": {"d": {"kernel": kernel, "bias": bias}}})
    order = {2: (1, 0), 4: (3, 2, 0, 1)}[len(shape)]
    np.testing.assert_array_equal(sd["d.weight"].numpy(), kernel.transpose(order))
    np.testing.assert_array_equal(sd["d.bias"].numpy(), bias)
    for t, src in ((sd["d.weight"], kernel), (sd["d.bias"], bias)):
        assert t.dtype == torch.float32 and t.is_contiguous()
        assert not np.shares_memory(t.numpy(), src)


def test_save_params_needs_the_module_of_a_state_dict(tmp_path):
    """A flat ``state_dict`` is refused (its names do not give flax's); its
    module, or the tree ``state_dict_to_flax`` makes with it, writes."""
    net = ttracker.EmbedNet(8)
    with pytest.raises(TypeError, match="state_dict_to_flax"):
        tregistry.save_params("m", net.state_dict(), root=tmp_path)
    a = tregistry.save_params("a", state_dict_to_flax(net, net.state_dict()), root=tmp_path).read_bytes()
    assert a == tregistry.save_params("b", net, root=tmp_path).read_bytes()


@functools.cache
def _jax_init(name: str):
    """(the JAX seeded init tree of ``name``'s model, its port module)."""
    k = jax.random.PRNGKey(0)
    jtc, ttc = TRACKER_CFG
    jn, tn = TRANSNET_CFG
    jd, td = DET_CFG
    jr, tr = REC_CFG
    js, ts = SR_CFG
    jf, tf = DIFF_CFG
    dummy = jnp.zeros((jf.window, 16, 16, 3), jnp.float32)
    models = {
        "tracker": (lambda: jtracker.EmbedNet(jtc.features).init(k, jnp.zeros((1, 32, 32, 3))),
                    lambda: ttracker.EmbedNet(ttc.features)),
        "transnet": (lambda: jtransnet.TransNet(jn).init(k, jnp.zeros((1, 32, 27, 48, 3), jnp.uint8)),
                     lambda: ttransnet.TransNet(tn)),
        "ocr_detector": (lambda: jocr.TextDetector(jd).init(k, jnp.zeros((1, jd.height, jd.width, 3), jnp.uint8)),
                         lambda: tocr.TextDetector(td)),
        "ocr_recognizer": (lambda: jocr.TextRecognizer(jr).init(k, jnp.zeros((1, jr.height, jr.max_width, 3),
                                                                             jnp.uint8)),
                           lambda: tocr.TextRecognizer(tr)),
        "sr": (lambda: jsr.SRNet(js).init(k, jnp.zeros((1, 8, 8, 3), jnp.uint8)), lambda: tsr.SRNet(ts)),
        "diffusion_sr": (lambda: jdiff.DenoiserUNet(jf).init(k, dummy, dummy, jnp.float32(0.5)),
                         lambda: tdiff.DenoiserUNet(tf)),
    }
    jinit, tmodule = models[name]
    return jax.jit(jinit)(), tmodule()


@pytest.mark.parametrize("name", ["tracker", "transnet", "ocr_detector", "ocr_recognizer", "sr", "diffusion_sr"])
def test_state_dict_to_flax_inverts_the_bridge_exactly(name, tmp_path):
    jparams, module = _jax_init(name)
    tree = _np_tree(jparams)
    crossed(module, jparams)
    assert_trees_equal(state_dict_to_flax(module, flax_to_state_dict(tree)), tree)
    # and the file: the JAX package's bytes for its own tree
    want = jregistry.save_params("m", jparams, root=tmp_path / "jax").read_bytes()
    assert tregistry.save_params("m", module, root=tmp_path / "port").read_bytes() == want


# --------------------------------------------------------------------- one step's loss and gradients


def test_tracker_loss_and_gradients_match_jax():
    jcfg, tcfg = TRACKER_CFG
    net = jtracker.EmbedNet(jcfg.features)
    jparams = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    t, s, y = jtracker_train.synthesize_pair_batch(np.random.default_rng(3), 4, jcfg)
    resp_edge = (jcfg.search_size - jcfg.template_size) // jtracker.STRIDE + 1

    def loss_fn(p):  # tracker_train.train's step, as written there
        tfeat = net.apply(p, jtracker._prep(t))
        sfeat = net.apply(p, jtracker._prep(s))

        def one(tf, sf):
            return jax.lax.conv_general_dilated(
                sf.transpose(2, 0, 1)[None], tf.transpose(2, 0, 1)[None].transpose(1, 0, 2, 3),
                window_strides=(1, 1), padding="VALID", feature_group_count=tf.shape[-1],
            ).sum(axis=1)[0]

        resp = jax.vmap(one)(tfeat, sfeat)
        logits = resp.reshape(resp.shape[0], -1) / (tfeat.shape[1] * tfeat.shape[2] * tfeat.shape[3])
        labels = y[:, 0] * resp_edge + y[:, 1]
        return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    module = crossed(ttracker.EmbedNet(tcfg.features), jparams)
    tt, ts, ty = (torch.from_numpy(a) for a in (t, s, y))
    loss, grads = port_grads(module, lambda: ttracker_train.pair_loss(module, tt, ts, ty, resp_edge))
    np.testing.assert_allclose(loss, float(jloss), atol=FP32_ATOL, rtol=FP32_RTOL)
    assert_trees_close(grads, _np_tree(jgrads))


def test_transnet_loss_and_gradients_match_jax():
    jcfg, tcfg = TRANSNET_CFG
    model = jtransnet.TransNet(jcfg, dtype=jnp.float32)
    jparams = jax.jit(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 27, 48, 3), jnp.uint8)))()
    frames, labels = jtransnet_train.synthesize_batch(np.random.default_rng(4), 2, 32)
    pos_weight = 8.0

    @jax.jit
    def value_and_grad(p):
        def loss_fn(p):  # transnet_train.train's step
            logits = model.apply(p, frames)
            per = optax.sigmoid_binary_cross_entropy(logits, labels)
            return (per * (1.0 + (pos_weight - 1.0) * labels)).mean()

        return jax.value_and_grad(loss_fn)(p)

    jloss, jgrads = value_and_grad(jparams)
    module = crossed(ttransnet.TransNet(tcfg, dtype=torch.float32), jparams)
    x, y = torch.from_numpy(frames), torch.from_numpy(labels)
    loss, grads = port_grads(module, lambda: ttransnet_train.cut_loss(module, x, y, pos_weight))
    np.testing.assert_allclose(loss, float(jloss), atol=FP32_ATOL, rtol=FP32_RTOL)
    assert_trees_close(grads, _np_tree(jgrads))


def test_ocr_detector_loss_and_gradients_match_jax():
    jcfg, tcfg = DET_CFG
    model = jocr.TextDetector(jcfg)
    jparams = model.init(jax.random.PRNGKey(0), jnp.zeros((1, jcfg.height, jcfg.width, 3), jnp.uint8))
    frames, targets = jocr_train.synthesize_detector_batch(np.random.default_rng(5), 3, jcfg)

    def loss_fn(p):  # ocr_train.train_detector's step
        per = optax.sigmoid_binary_cross_entropy(model.apply(p, frames), targets)
        return (per * (1.0 + (3.0 - 1.0) * targets)).mean()

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    module = crossed(tocr.TextDetector(tcfg), jparams)
    x, y = torch.from_numpy(frames), torch.from_numpy(targets)
    loss, grads = port_grads(module, lambda: tocr_train.detector_loss(module, x, y, 3.0))
    np.testing.assert_allclose(loss, float(jloss), atol=FP32_ATOL, rtol=FP32_RTOL)
    assert_trees_close(grads, _np_tree(jgrads))


def test_ocr_recognizer_ctc_loss_and_gradients_match_jax():
    jcfg, tcfg = REC_CFG
    model = jocr.TextRecognizer(jcfg)
    jparams = model.init(jax.random.PRNGKey(0), jnp.zeros((1, jcfg.height, jcfg.max_width, 3), jnp.uint8))
    crops, labels, pads = jocr_train.synthesize_recognizer_batch(np.random.default_rng(6), 4, jcfg)
    assert len({int((1 - p).sum()) for p in pads}) > 1  # labels of several lengths

    def loss_fn(p):  # ocr_train.train_recognizer's step
        logits = model.apply(p, crops)
        logit_pads = jnp.zeros(logits.shape[:2], jnp.float32)
        return optax.ctc_loss(logits, logit_pads, labels, pads, blank_id=jocr.BLANK_ID).mean()

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    module = crossed(tocr.TextRecognizer(tcfg), jparams)
    x, y, p = (torch.from_numpy(a) for a in (crops, labels, pads))
    loss, grads = port_grads(module, lambda: tocr_train.recognizer_loss(module, x, y, p))
    np.testing.assert_allclose(loss, float(jloss), atol=FP32_ATOL, rtol=FP32_RTOL)
    assert_trees_close(grads, _np_tree(jgrads))


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float64)
    return out


def _bf16_conv_biases(module: torch.nn.Module, fp32_convs: tuple[str, ...] = ()) -> set:
    """Flax paths of the biases of the convs that compute in bf16."""
    return {"/params/" + name.replace(".", "/") + "/bias" for name, m in module.named_modules()
            if isinstance(m, torch.nn.Conv2d) and name not in fp32_convs}


def assert_bf16_grads(jgrads: dict, bf16: dict, fp32: dict, conv_biases: set) -> dict:
    """The bf16 rule of the module docstring; returns each leaf's errors
    over its scale."""
    j, b, f = _flat(jgrads), _flat(bf16), _flat(fp32)
    assert j.keys() == b.keys() == f.keys()
    top = max(float(np.abs(v).max()) for v in f.values())
    shares = {}
    for k in f:
        scale = max(float(np.abs(f[k]).max()), GRAD_FLOOR * top)
        vs_fp32, vs_jax = float(np.abs(b[k] - f[k]).max()) / scale, float(np.abs(b[k] - j[k]).max()) / scale
        assert vs_fp32 <= BF16_GRAD_SHARE, f"{k}: {vs_fp32} of its scale off the fp32 run"
        if k not in conv_biases:
            assert vs_jax <= BF16_GRAD_SHARE, f"{k}: {vs_jax} of its scale off the JAX gradient"
        shares[k] = (vs_fp32, vs_jax, float(np.abs(j[k] - f[k]).max()) / scale)
    return shares


@functools.cache
def _sr_step():
    jcfg, tcfg = SR_CFG
    model = jsr.SRNet(jcfg)
    lrs, hrs = jsr_train.synthesize_batch(np.random.default_rng(7), 4, 32, jcfg.scale)
    jparams = model.init(jax.random.PRNGKey(0), jnp.asarray(lrs[:1]))

    def loss_fn(p):  # sr_train.train's loss_fn
        out = jax.vmap(lambda x: model.apply(p, x[None], float_out=True)[0])(lrs)
        return jnp.abs(out - hrs.astype(jnp.float32) / 255.0).mean()

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    x, y = torch.from_numpy(lrs), torch.from_numpy(hrs)
    port = {}
    for dtype in (torch.bfloat16, torch.float32):
        module = crossed(tsr.SRNet(tcfg), jparams)
        module.compute_dtype = dtype
        port[dtype] = port_grads(module, lambda m=module: tsr_train.l1_loss(m, x, y))
    return float(jloss), _np_tree(jgrads), port, _bf16_conv_biases(module)


def test_sr_loss_and_gradients_match_jax_within_bf16():
    jloss, jgrads, port, biases = _sr_step()
    loss, grads = port[torch.bfloat16]
    assert abs(loss - jloss) <= BF16_SHARE * abs(jloss)
    assert_bf16_grads(jgrads, grads, port[torch.float32][1], biases)


def test_jax_bf16_conv_bias_gradients_are_the_divergent_side():
    """Why the bf16 convs' biases are held against the fp32 run: on the SR
    step the JAX package's bias gradients are farther from it than the
    port's, by more than the bound."""
    jloss, jgrads, port, biases = _sr_step()
    shares = assert_bf16_grads(jgrads, port[torch.bfloat16][1], port[torch.float32][1], biases)
    worst_port = max(shares[k][0] for k in biases)
    worst_jax = max(shares[k][2] for k in biases)
    assert worst_port <= BF16_GRAD_SHARE < worst_jax, (worst_port, worst_jax)


def _nonzero_final_conv(params, rng):
    """The denoiser's tree with its zero-initialised last conv drawn
    non-zero, so every gradient upstream of it is non-zero too."""
    p = _np_tree(params)
    last = max((k for k in p["params"] if k.startswith("Conv_")), key=lambda k: int(k.split("_")[1]))
    p["params"][last]["kernel"] = (rng.standard_normal(p["params"][last]["kernel"].shape) * 0.1).astype(np.float32)
    return p


def test_diffusion_sr_loss_and_gradients_match_jax_within_bf16():
    jcfg, tcfg = DIFF_CFG
    model = jdiff.DenoiserUNet(jcfg)
    rng = np.random.default_rng(8)
    conds, residuals = jdiff_train.synthesize_windows(rng, 3, jcfg.window, 16, jcfg.scale)
    dummy = jnp.zeros_like(jnp.asarray(conds[0]))
    jparams = _nonzero_final_conv(
        jax.jit(lambda: model.init(jax.random.PRNGKey(0), dummy, dummy, jnp.float32(0.5)))(), rng)
    k_t, k_eps = jax.random.split(jax.random.PRNGKey(1))
    ts = jax.random.uniform(k_t, (3,), minval=1e-3, maxval=1.0)
    eps = jax.random.normal(k_eps, residuals.shape)

    def loss_fn(p):  # diffusion_sr_train.train's loss_fn, the draws passed in
        def one(cond, x0, e, t):
            a, s = jdiff.cosine_alpha_sigma(t)
            v = model.apply(p, a * x0 + s * e, cond, t)
            return jnp.mean((v - (a * e - s * x0)) ** 2)

        return jnp.mean(jax.vmap(one)(conds, residuals, eps, ts))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    c, r, t, e = (torch.from_numpy(np.asarray(a)) for a in (conds, residuals, ts, eps))
    port = {}
    for dtype in (torch.bfloat16, torch.float32):
        module = crossed(tdiff.DenoiserUNet(tcfg), jparams)
        module.compute_dtype = dtype
        port[dtype] = port_grads(module, lambda m=module: tdiff_train.v_loss(m, c, r, t, e))
    loss, grads = port[torch.bfloat16]
    assert abs(loss - float(jloss)) <= BF16_SHARE * abs(float(jloss))
    assert_bf16_grads(_np_tree(jgrads), grads, port[torch.float32][1],
                      _bf16_conv_biases(module, fp32_convs=(module.conv_out,)))


def test_diffusion_draws_are_seeded_per_step():
    """``ts`` in [1e-3, 1) first, then ``eps``, from one generator: the same
    seed, the same draws."""
    a = tdiff_train.draw_noise(torch.Generator().manual_seed(1), 4, (4, 2, 3))
    b = tdiff_train.draw_noise(torch.Generator().manual_seed(1), 4, (4, 2, 3))
    for x, y in zip(a, b, strict=True):
        assert torch.equal(x, y)
    assert a[0].shape == (4,) and bool(((a[0] >= 1e-3) & (a[0] < 1.0)).all())
    assert a[1].shape == (4, 2, 3)


# --------------------------------------------------------------------- optimizers


@pytest.mark.parametrize("kind", ["adamw", "adam"])
def test_optimizer_steps_match_optax(kind):
    rng = np.random.default_rng(9)
    shapes = {"w": (4, 3), "b": (3,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    lr = 1e-2
    opt = optax.adamw(lr) if kind == "adamw" else optax.adam(lr)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = opt.init(jp)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    topt = (train_common.optax_adamw if kind == "adamw" else train_common.optax_adam)(tparams.values(), lr)
    for g in grads:
        updates, state = opt.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k in shapes:
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jp[k]), atol=OPT_ATOL, rtol=0)
    # the decay applies to every parameter, at optax's 1e-4
    assert all(group["weight_decay"] == (1e-4 if kind == "adamw" else 0) for group in topt.param_groups)


def test_optimizer_step_reports_the_loss_before_the_update():
    p = torch.nn.Parameter(torch.tensor([2.0]))
    opt = train_common.optax_adam([p], 0.1)
    loss = train_common.optimizer_step(opt, lambda: (p**2).sum())
    assert float(loss) == 4.0 and float(p.detach()) < 2.0 and not loss.requires_grad
