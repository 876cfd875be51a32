"""Port parity: SRNet, the diffusion denoiser block by block, DDIM sampling,
the bilinear base, window blending and the SR stage against the JAX
package, on the CPU.

Inputs come from a numpy seed; weights are the JAX package's init carried
over through ``models/convert_jax.py``. The denoiser's final conv is zero
at init (the reference's ``kernel_init=zeros``), which makes its v
prediction exactly 0 (DDIM then only rescales its noise), so every denoiser
and sampling check draws it non-zero first. The DDIM checks pass the JAX
noise draw in (torch cannot reproduce threefry).

Tolerances (bf16 paths: within ``BF16_SHARE`` of the output's largest
magnitude; the share measured on these inputs beside each):
- ``ResBlock`` and ``_FiLMResBlock`` 2e-2 (measured 0: the same bits);
  ``_TemporalAttention`` (fp32) 1e-5 absolute; ``DenoiserUNet`` 2e-2
  (measured up to 6.7e-3); ``ddim_sample`` 2e-2 (5.9e-3);
  ``SRNet(float_out=True)`` 2e-2 (1.2e-7: its seeded residual is small
  against the base);
- uint8 outputs within 2 levels (``UINT8_LEVELS``), a diffusion window's
  within the bf16 share of the full scale (5 levels; measured 4);
- the bilinear base within 1e-6 (measured 1.2e-7);
- ``blend_windows`` and ``overlapping_windows``: exactly equal.
"""

from __future__ import annotations

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_curate_tpu.data import model as jdata
from cosmos_curate_tpu.models import diffusion_sr as jd
from cosmos_curate_tpu.models import registry as jregistry
from cosmos_curate_tpu.models import super_resolution as js
from cosmos_curate_tpu.pipelines.video.stages import super_resolution as jstage
from cosmos_curate_tpu.video import windowing as jwin
from cosmos_curate_tpu.video.encode import encode_frames
from cosmos_curate_tpu_torch.data import model as tdata
from cosmos_curate_tpu_torch.models import diffusion_sr as td
from cosmos_curate_tpu_torch.models import super_resolution as ts
from cosmos_curate_tpu_torch.models.convert_jax import flax_to_state_dict
from cosmos_curate_tpu_torch.pipelines.video.stages import super_resolution as tstage
from cosmos_curate_tpu_torch.video import windowing as twin
from tests.test_torch_split import _frames

BF16_SHARE = 2e-2
UINT8_LEVELS = 2
BASE_TOL = 1e-6
# the timestep embedding's sines run at up to e^6 = 403 rad, where one ulp
# of the angle is 3e-5 and XLA's exp and sin round other ulps than torch's
EMBED_TOL = 1e-5


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).detach().numpy()


def _assert_share(got: np.ndarray, want: np.ndarray, share: float = BF16_SHARE) -> None:
    scale = float(np.abs(want).max())
    assert scale > 0
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= share * scale, f"max error {err} above {share} x {scale}"


def _nonzero_final_conv(params, rng):
    """The param tree with the UNet's last conv (the highest ``Conv_i``)
    drawn non-zero."""
    p = flax.core.unfreeze(params) if isinstance(params, flax.core.FrozenDict) else dict(params)
    p = jax.tree_util.tree_map(np.asarray, p)
    convs = [k for k in p["params"] if k.startswith("Conv_")]
    last = max(convs, key=lambda k: int(k.split("_")[1]))
    kernel = p["params"][last]["kernel"]
    p["params"][last]["kernel"] = (rng.standard_normal(kernel.shape) * 0.1).astype(np.float32)
    p["params"][last]["bias"] = (rng.standard_normal(kernel.shape[-1]) * 0.05).astype(np.float32)
    return p


# -- resize, windows, blending ------------------------------------------------


@pytest.mark.parametrize("t,h,w", [(1, 1, 1), (2, 5, 7), (3, 12, 16), (1, 36, 64)])
def test_bilinear_base_matches_jax(t, h, w):
    f = np.random.default_rng(h * w).integers(0, 256, (t, h, w, 3), dtype=np.uint8)
    want = np.asarray(jax.image.resize(f.astype(np.float32) / 255.0, (t, 2 * h, 2 * w, 3), "bilinear"))
    got = _nhwc(ts.bilinear_up(torch.from_numpy(f), 2))
    np.testing.assert_allclose(got, want, atol=BASE_TOL, rtol=0)


@pytest.mark.parametrize("n,window,overlap", [(0, 128, 64), (10, 128, 64), (128, 128, 64), (300, 128, 64),
                                              (7, 3, 1), (24, 8, 4), (5, 5, 4)])
def test_overlapping_windows_match_jax(n, window, overlap):
    kw = dict(window_len=window, overlap=overlap)
    assert twin.overlapping_windows(n, **kw) == jwin.overlapping_windows(n, **kw)


def test_overlapping_windows_refuse_overlap_past_the_window():
    with pytest.raises(ValueError):
        twin.overlapping_windows(10, window_len=4, overlap=4)


@pytest.mark.parametrize("total,window,overlap", [(10, 4, 2), (9, 9, 3), (30, 8, 3), (5, 2, 1)])
def test_blend_windows_matches_jax(total, window, overlap):
    rng = np.random.default_rng(total)
    spans = jwin.overlapping_windows(total, window_len=window, overlap=overlap)
    windows = [(a, b, rng.integers(0, 256, (b - a, 6, 8, 3), dtype=np.uint8)) for a, b in spans]
    np.testing.assert_array_equal(tstage.blend_windows(windows, total), jstage.blend_windows(windows, total))


# -- SRNet --------------------------------------------------------------------


@pytest.fixture(scope="module", params=["tiny", "wider"])
def srnet_pair(request):
    cfg = {"tiny": (js.SR_TINY_TEST, ts.SR_TINY_TEST), "wider": (js.SRConfig(channels=16, blocks=2),
                                                               ts.SRConfig(channels=16, blocks=2))}[request.param]
    f = np.zeros((1, 16, 16, 3), np.uint8)
    jnet = js.SRNet(cfg[0])
    params = jnet.init(jax.random.PRNGKey(1), f)
    tnet = ts.SRNet(cfg[1])
    tnet.load_state_dict(flax_to_state_dict(params))
    return jnet, params, tnet


def test_res_block_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 10, 12, 16)).astype(np.float32)
    block = js.ResBlock(16)
    params = block.init(jax.random.PRNGKey(2), x)
    want = np.asarray(block.apply(params, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    tblock = ts.ResBlock(16)
    tblock.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        got = _nhwc(tblock(_nchw(x).to(torch.bfloat16)).float())
    _assert_share(got, want)


@pytest.mark.parametrize("shape", [(3, 12, 16, 3), (2, 9, 7, 3)])
def test_srnet_matches_jax(srnet_pair, shape):
    jnet, params, tnet = srnet_pair
    f = np.random.default_rng(shape[1]).integers(0, 256, shape, dtype=np.uint8)
    with torch.no_grad():
        got = tnet(torch.from_numpy(f), float_out=True).numpy()
        got_u8 = tnet(torch.from_numpy(f)).numpy()
    _assert_share(got, np.asarray(jnet.apply(params, f, float_out=True)))
    want_u8 = np.asarray(jnet.apply(params, f))
    assert got_u8.dtype == np.uint8 and got_u8.shape == want_u8.shape == (shape[0], 2 * shape[1], 2 * shape[2], 3)
    assert np.abs(got_u8.astype(int) - want_u8).max() <= UINT8_LEVELS


def test_srnet_residual_matches_jax(srnet_pair):
    """The net's residual where the JAX image does not clip (there it is
    the image less the bilinear base), within the bf16 share of the
    residual's largest magnitude: the clipped image hides most of it."""
    jnet, params, tnet = srnet_pair
    f = np.random.default_rng(7).integers(0, 256, (2, 10, 12, 3), dtype=np.uint8)
    image = np.asarray(jnet.apply(params, f, float_out=True))
    inside = (image > 0) & (image < 1)
    assert inside.mean() > 0.05
    want = image - _nhwc(ts.bilinear_up(torch.from_numpy(f), 2))
    with torch.no_grad():
        got = _nhwc(tnet.residual(torch.from_numpy(f)).float())
    assert np.abs(got - want)[inside].max() <= BF16_SHARE * np.abs(got).max()


def test_srnet_uint8_truncates():
    """``out * 255`` truncated, not rounded: a model whose residual is zero
    gives the truncated bilinear base."""
    net = ts.SRNet(ts.SR_TINY_TEST)
    with torch.no_grad():
        for p in net.parameters():
            p.zero_()
        f = np.random.default_rng(0).integers(0, 256, (2, 6, 8, 3), dtype=np.uint8)
        want = np.clip(_nhwc(ts.bilinear_up(torch.from_numpy(f), 2)), 0, 1) * 255.0
        np.testing.assert_array_equal(net(torch.from_numpy(f)).numpy(), want.astype(np.uint8))


def test_super_resolution_model_matches_jax(monkeypatch, tmp_path):
    """The model entry points on a staged JAX checkpoint: one window."""
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(tmp_path))
    jm = js.SuperResolutionModel(js.SR_TINY_TEST)
    jm.setup()
    jregistry.save_params(js.SuperResolutionModel.MODEL_ID, jm._params)
    tm = ts.SuperResolutionModel(ts.SR_TINY_TEST, device="cpu")
    tm.setup()
    f = np.random.default_rng(3).integers(0, 256, (5, 10, 14, 3), dtype=np.uint8)
    got, want = tm.upscale_window(f), np.asarray(jm.upscale_window(f))
    assert got.shape == want.shape == (5, 20, 28, 3)
    assert np.abs(got.astype(int) - want).max() <= UINT8_LEVELS


# -- the diffusion denoiser ---------------------------------------------------


@pytest.mark.parametrize("in_ch,ch", [(16, 8), (8, 8)], ids=["shortcut", "same-width"])
def test_film_res_block_matches_jax(in_ch, ch):
    rng = np.random.default_rng(in_ch)
    x = rng.standard_normal((2, 8, 10, in_ch)).astype(np.float32)
    temb = rng.standard_normal((2, 32)).astype(np.float32)
    temb[1] = temb[0]  # one t for every frame, as the UNet gives it
    block = jd._FiLMResBlock(ch)
    params = block.init(jax.random.PRNGKey(4), jnp.asarray(x, jnp.bfloat16), temb)
    want = np.asarray(block.apply(params, jnp.asarray(x, jnp.bfloat16), temb).astype(jnp.float32))
    tblock = td._FiLMResBlock(in_ch, ch, 32)
    tblock.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        got = _nhwc(tblock(_nchw(x).to(torch.bfloat16), torch.from_numpy(temb[:1]), torch.bfloat16).float())
    _assert_share(got, want)


@pytest.mark.parametrize("chunks", [1, 2])
def test_temporal_attention_matches_jax(chunks):
    rng = np.random.default_rng(chunks)
    x = rng.standard_normal((chunks * 4, 5, 6, 16)).astype(np.float32)
    attn = jd._TemporalAttention(4)
    params = attn.init(jax.random.PRNGKey(5), x[:4])
    want = np.concatenate([np.asarray(attn.apply(params, x[i * 4 : (i + 1) * 4])) for i in range(chunks)])
    tattn = td._TemporalAttention(16, 4)
    tattn.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        got = _nhwc(tattn(_nchw(x), chunks))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def unet_pair():
    cfg = jd.DIFF_SR_TINY_TEST
    z = np.zeros((cfg.window, 16, 16, 3), np.float32)
    net = jd.DenoiserUNet(cfg)
    params = _nonzero_final_conv(net.init(jax.random.PRNGKey(2), z, z, jnp.float32(0.5)), np.random.default_rng(9))
    tnet = td.DenoiserUNet(td.DIFF_SR_TINY_TEST)
    tnet.load_state_dict(flax_to_state_dict(params))
    return net, params, tnet


def test_unet_names_follow_flax():
    """Every flax parameter has its module, by name and shape, at two
    configurations (the 1x1 shortcuts and level counts shift the names)."""
    for jcfg, tcfg in ((jd.DIFF_SR_TINY_TEST, td.DIFF_SR_TINY_TEST),
                       (jd.DiffusionSRConfig(channels=8, levels=2, blocks=2, temporal_heads=2, window=2),
                        td.DiffusionSRConfig(channels=8, levels=2, blocks=2, temporal_heads=2, window=2))):
        z = jnp.zeros((jcfg.window, 16, 16, 3))
        params = jd.DenoiserUNet(jcfg).init(jax.random.PRNGKey(0), z, z, jnp.float32(0.5))
        want = {k: tuple(v.shape) for k, v in flax_to_state_dict(params).items()}
        assert {k: tuple(v.shape) for k, v in td.DenoiserUNet(tcfg).state_dict().items()} == want


@pytest.mark.parametrize("t", [1.0, 0.5, 0.125])
def test_denoiser_unet_matches_jax(unet_pair, t):
    net, params, tnet = unet_pair
    rng = np.random.default_rng(int(t * 8))
    z = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    cond = rng.random((2, 16, 16, 3)).astype(np.float32)
    want = np.asarray(net.apply(params, z, cond, jnp.float32(t)))
    with torch.no_grad():
        got = _nhwc(tnet(_nchw(z), _nchw(cond), t))
    _assert_share(got, want)


def test_denoiser_unet_runs_chunks_independently(unet_pair):
    """Two chunks at once give what each gives alone."""
    _, _, tnet = unet_pair
    rng = np.random.default_rng(11)
    z, cond = _nchw(rng.standard_normal((4, 8, 8, 3)).astype(np.float32)), _nchw(rng.random((4, 8, 8, 3)).astype(
        np.float32))
    with torch.no_grad():
        both = tnet(z, cond, 0.5, chunks=2)
        alone = torch.cat([tnet(z[:2], cond[:2], 0.5), tnet(z[2:], cond[2:], 0.5)])
    torch.testing.assert_close(both, alone, atol=1e-2, rtol=0)


def _forward_with_one_t(net, z, cond, t: float, chunks: int = 1):
    """``DenoiserUNet.forward`` as it was before it took a timestep a chunk:
    one float ``t``, embedded once as a ``[1]`` tensor for every frame."""
    import torch.nn.functional as F

    dtype, m = net.compute_dtype, net._modules
    temb = td._timestep_embedding(torch.full((1,), t, dtype=torch.float32, device=z.device), 4 * net.cfg.channels)
    temb = F.silu(m["Dense_0"](temb))
    x = td.conv_as(m[net.conv_in], torch.cat([z, cond], dim=1), dtype)
    skips = []
    for blocks, down in net.down:
        for name in blocks:
            x = m[name](x, temb, dtype)
        skips.append(x)
        x = td.conv_as(m[down], x, dtype)
    for name in net.mid_a:
        x = m[name](x, temb, dtype)
    x = m[net.attn](x.to(torch.float32), chunks).to(dtype)
    for name in net.mid_b:
        x = m[name](x, temb, dtype)
    for (up, blocks), skip in zip(net.up, reversed(skips)):
        x = td.depth_to_space(td.conv_as(m[up], x, dtype), 2)
        x = torch.cat([x, skip.to(dtype)], dim=1)
        for name in blocks:
            x = m[name](x, temb, dtype)
    x = F.silu(td._group_norm(m[net.norm_out], x), inplace=True)
    return td.conv_as(m[net.conv_out], x, torch.float32)


@pytest.mark.parametrize("t", [1.0, 0.5, 0.125])
def test_denoiser_unet_float_timestep_is_bit_equal_to_one_t_forward(unet_pair, t):
    """Inference passes a float: the same bits as the forward before the
    per-chunk timestep existed."""
    _, _, tnet = unet_pair
    rng = np.random.default_rng(12)
    z, cond = _nchw(rng.standard_normal((4, 8, 8, 3)).astype(np.float32)), _nchw(rng.random((4, 8, 8, 3)).astype(
        np.float32))
    with torch.no_grad():
        assert torch.equal(tnet(z, cond, t, chunks=2), _forward_with_one_t(tnet, z, cond, t, chunks=2))


def test_denoiser_unet_timestep_per_chunk_equals_per_chunk_forwards(unet_pair):
    """A ``[chunks]`` timestep tensor (the trainer's) gives what each chunk
    gives alone with its own float t, within the chunking bound of
    ``test_denoiser_unet_runs_chunks_independently`` (atol 1e-2: bf16 convs
    over another batch round otherwise); and the JAX model on each chunk."""
    net, params, tnet = unet_pair
    rng = np.random.default_rng(13)
    w = td.DIFF_SR_TINY_TEST.window
    ts = [0.9, 0.3, 0.05]
    z = rng.standard_normal((w * len(ts), 8, 8, 3)).astype(np.float32)
    cond = rng.random((w * len(ts), 8, 8, 3)).astype(np.float32)
    with torch.no_grad():
        together = tnet(_nchw(z), _nchw(cond), torch.tensor(ts), chunks=len(ts))
        alone = torch.cat([tnet(_nchw(z[i * w:(i + 1) * w]), _nchw(cond[i * w:(i + 1) * w]), t)
                           for i, t in enumerate(ts)])
    torch.testing.assert_close(together, alone, atol=1e-2, rtol=0)
    for i, t in enumerate(ts):
        want = np.asarray(net.apply(params, z[i * w:(i + 1) * w], cond[i * w:(i + 1) * w], jnp.float32(t)))
        _assert_share(_nhwc(together[i * w:(i + 1) * w]), want)


def test_cosine_alpha_sigma_tensor_matches_the_float_form():
    ts = np.float32([0.0, 1e-3, 0.25, 0.5, 0.875, 1.0])
    a, s = td.cosine_alpha_sigma_tensor(torch.from_numpy(ts))
    for i, t in enumerate(ts):
        ja, js_ = jd.cosine_alpha_sigma(jnp.float32(t))
        assert (float(a[i]), float(s[i])) == td.cosine_alpha_sigma(float(t))
        np.testing.assert_allclose([float(a[i]), float(s[i])], [float(ja), float(js_)], atol=1e-7, rtol=0)


@pytest.mark.parametrize("t", [0.0, 0.25, 0.875, 1.0])
def test_schedule_and_timestep_embedding_match_jax(t):
    a, s = jd.cosine_alpha_sigma(jnp.float32(t))
    np.testing.assert_allclose(td.cosine_alpha_sigma(t), (float(a), float(s)), atol=1e-7, rtol=0)
    want = np.asarray(jd._timestep_embedding(jnp.full((2,), t, jnp.float32), 192))
    got = td._timestep_embedding(torch.full((2,), t), 192).numpy()
    np.testing.assert_allclose(got, want, atol=EMBED_TOL, rtol=0)


@pytest.mark.parametrize("start,stop,num", [(0.0, 6.0, 16), (0.0, 6.0, 96), (1.0, 0.0, 9), (1.0, 0.0, 3)])
def test_linspace_is_bit_equal(start, stop, num):
    np.testing.assert_array_equal(td.linspace32(start, stop, num), np.asarray(jnp.linspace(start, stop, num)))


def test_ddim_sample_matches_jax(unet_pair):
    net, params, tnet = unet_pair
    cfg = jd.DIFF_SR_TINY_TEST
    cond = np.random.default_rng(2).random((cfg.window, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(key, cond.shape, jnp.float32))
    want = np.asarray(jd.ddim_sample(net, params, jnp.asarray(cond), cfg, key))
    with torch.no_grad():
        got = _nhwc(td.ddim_sample(tnet, _nchw(cond), _nchw(noise), td.DIFF_SR_TINY_TEST))
    _assert_share(got, want)


@pytest.fixture()
def staged_diffusion(unet_pair, monkeypatch, tmp_path):
    """The JAX model on the non-trivial params, and the same params staged
    as a checkpoint for the port."""
    _, params, _ = unet_pair
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(tmp_path))
    jregistry.save_params(jd.DiffusionSRModel.MODEL_ID, params)
    jm = jd.DiffusionSRModel(jd.DIFF_SR_TINY_TEST)
    jm.setup()
    return jm, params


def _jax_noise(seed: int, shape: tuple) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32)))


@pytest.mark.parametrize("t,group", [(5, None), (4, 1), (6, 2)])
def test_diffusion_window_matches_jax(staged_diffusion, monkeypatch, t, group):
    """A window through both models with each chunk's JAX noise passed in:
    uint8 within the bf16 share of the full scale (measured 4 levels); the
    chunk grouping changes nothing but rounding."""
    jm, _ = staged_diffusion
    f = np.random.default_rng(t).integers(0, 256, (t, 8, 8, 3), dtype=np.uint8)
    want = np.asarray(jm.upscale_window(f))
    monkeypatch.setattr(td, "chunk_noise", _jax_noise)
    tm = td.DiffusionSRModel(td.DIFF_SR_TINY_TEST, device="cpu")
    tm.setup()
    if group is not None:
        monkeypatch.setattr(tm, "group_size", lambda n_chunk, h, w: group)
    got = tm.upscale_window(f)
    n_chunk = -(-t // td.DIFF_SR_TINY_TEST.window)
    assert got.shape == want.shape == (t, 16, 16, 3)
    assert np.abs(got.astype(int) - want).max() <= round(BF16_SHARE * 255)
    assert tm.last_group == (n_chunk if group is None else group)


def test_diffusion_window_is_reproducible(staged_diffusion):
    """The port's own noise (a seeded CPU generator per chunk): the same
    input gives the same output, by any chunk grouping (up to rounding)."""
    f = np.random.default_rng(1).integers(0, 256, (6, 8, 8, 3), dtype=np.uint8)
    outs = []
    for group in (None, 1, None):
        tm = td.DiffusionSRModel(td.DIFF_SR_TINY_TEST, device="cpu")
        tm.setup()
        if group is not None:
            tm.group_size = lambda n_chunk, h, w, g=group: g
        outs.append(tm.upscale_window(f))
    assert outs[0].shape == (6, 16, 16, 3)
    np.testing.assert_array_equal(outs[0], outs[2])
    assert np.abs(outs[0].astype(int) - outs[1]).max() <= UINT8_LEVELS


@pytest.mark.parametrize("noise", ["jax", "port"])
def test_seeded_diffusion_adds_scaled_noise(monkeypatch, tmp_path, noise):
    """No checkpoint: the seeded init's final conv is zero, so v = 0 and each
    DDIM step only rescales z by cos of the step's angle: the output is the
    bilinear base plus prod(cos) x the chunk's noise (0.5 at the tiny
    config's 2 steps, 0.86 at the base's 8), clipped and truncated. With the
    JAX draw passed in, the port gives the JAX output (within a level)."""
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(tmp_path))
    cfg = td.DIFF_SR_TINY_TEST
    f = np.random.default_rng(4).integers(0, 256, (4, 6, 10, 3), dtype=np.uint8)
    draw = _jax_noise if noise == "jax" else td.chunk_noise
    monkeypatch.setattr(td, "chunk_noise", draw)
    tm = td.DiffusionSRModel(cfg, device="cpu")
    tm.setup()
    got = tm.upscale_window(f)
    angles = (np.pi / 2) * td.linspace32(1.0, 0.0, cfg.sample_steps + 1).astype(np.float64)
    gain = float(np.prod(np.cos(angles[:-1] - angles[1:])))
    z = np.concatenate([draw(i, (cfg.window, 12, 20, 3)).numpy() for i in range(2)])
    want = np.clip(_nhwc(ts.bilinear_up(torch.from_numpy(f), 2)) + gain * z, 0, 1) * 255.0
    assert np.abs(got.astype(int) - want.astype(np.uint8)).max() <= 1
    if noise == "jax":
        jm = jd.DiffusionSRModel(jd.DIFF_SR_TINY_TEST)
        jm.setup()
        assert np.abs(got.astype(int) - np.asarray(jm.upscale_window(f))).max() <= 1


# -- the stage ----------------------------------------------------------------


def _sr_tasks(data, payloads):
    clips = [data.Clip(source_video="v.mp4", span=(float(i), i + 1.0), encoded_data=p) for i, p in enumerate(payloads)]
    return [data.SplitPipeTask(video=data.Video(path="v.mp4", clips=clips))]


@pytest.mark.parametrize("variant", ["srnet", "diffusion"])
def test_super_resolution_stage_matches_jax(variant, monkeypatch, tmp_path):
    """Clips through both stages in overlapping windows (seeded weights;
    the diffusion model on the JAX noise): the blended frames each stage
    encodes, at twice the size, within 2 levels of the JAX stage's; a clip
    that does not decode keeps its bytes with the error recorded."""
    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(tmp_path))
    monkeypatch.setattr(td, "chunk_noise", _jax_noise)
    encoded = {"jax": [], "port": []}
    for name, module in (("jax", jstage), ("port", tstage)):
        real = module.encode_frames
        monkeypatch.setattr(module, "encode_frames",
                            lambda frames, fps, _real=real, _out=encoded[name]: _out.append(frames) or _real(frames, fps))
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (n, 24, 32, 3), dtype=np.uint8) for n in (7, 12)]
    payloads = [encode_frames(f, 24.0) for f in frames] + [b"not an mp4"]
    kw = dict(window_len=5, overlap=2, variant=variant)
    if variant == "srnet":
        jm = js.SuperResolutionModel(js.SR_TINY_TEST)
        jm.setup()
        jregistry.save_params(js.SuperResolutionModel.MODEL_ID, jm._params)
        j_stage = jstage.SuperResolutionStage(cfg=js.SR_TINY_TEST, **kw)
        t_stage = tstage.SuperResolutionStage(cfg=ts.SR_TINY_TEST, device="cpu", **kw)
    else:
        j_stage = jstage.SuperResolutionStage(diffusion_cfg=jd.DIFF_SR_TINY_TEST, **kw)
        t_stage = tstage.SuperResolutionStage(diffusion_cfg=td.DIFF_SR_TINY_TEST, device="cpu", **kw)
    j_stage.model.setup()
    t_stage.model.setup()
    j_tasks = j_stage.process_data(_sr_tasks(jdata, payloads))
    t_tasks = t_stage.process_data(_sr_tasks(tdata, payloads))
    assert len(encoded["port"]) == len(encoded["jax"]) == len(frames)
    for f, got, want in zip(frames, encoded["port"], encoded["jax"]):
        assert got.shape == want.shape == (f.shape[0], 48, 64, 3)
        assert np.abs(got.astype(int) - want).max() <= UINT8_LEVELS
    for t_clip, j_clip in zip(t_tasks[0].video.clips[:2], j_tasks[0].video.clips[:2]):
        assert _frames(t_clip.encoded_data).shape == _frames(j_clip.encoded_data).shape
        assert not t_clip.errors and not j_clip.errors
    bad, j_bad = t_tasks[0].video.clips[-1], j_tasks[0].video.clips[-1]
    assert set(bad.errors) == set(j_bad.errors) == {"super_resolution"} and bad.encoded_data == b"not an mp4"


def test_super_resolution_stage_lets_a_device_fault_through(monkeypatch, tmp_path):
    from cosmos_curate_tpu_torch.ops._build import KernelLaunchError

    monkeypatch.setenv(jregistry.WEIGHTS_DIR_ENV, str(tmp_path))
    stage = tstage.SuperResolutionStage(cfg=ts.SR_TINY_TEST, device="cpu")
    stage.model.setup()

    def fault(frames):
        raise KernelLaunchError("launch failed")

    monkeypatch.setattr(stage.model, "submit_window", fault)
    with pytest.raises(KernelLaunchError):
        stage.process_data(_sr_tasks(tdata, [encode_frames(np.zeros((3, 8, 8, 3), np.uint8), 24.0)]))


@pytest.mark.parametrize("variant", ["diffusion", "srnet"])
def test_sequence_parallel_sr_raises(variant):
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 7"):
        tstage.SuperResolutionStage(variant=variant, sp_size=2, device="cpu")


def test_stage_variant_selection_matches_jax():
    for kw in (dict(), dict(variant="srnet"), dict(cfg=js.SR_TINY_TEST)):
        t_kw = {k: (ts.SR_TINY_TEST if k == "cfg" else v) for k, v in kw.items()}
        assert type(tstage.SuperResolutionStage(device="cpu", **t_kw).model).__name__ == \
            type(jstage.SuperResolutionStage(**kw).model).__name__
    with pytest.raises(ValueError, match="unknown SR variant"):
        tstage.SuperResolutionStage(variant="seedvr", device="cpu")
    with pytest.raises(ValueError, match="not both"):
        tstage.SuperResolutionStage(cfg=ts.SR_TINY_TEST, diffusion_cfg=td.DIFF_SR_TINY_TEST, device="cpu")
    assert tstage.SuperResolutionStage(device="cpu").resources.entire_gpu_host is False


@pytest.mark.parametrize("name", ["SR_BASE", "SR_TINY_TEST", "DIFF_SR_BASE", "DIFF_SR_TINY_TEST"])
def test_sr_configs_mirror_the_reference_field_for_field(name):
    import dataclasses

    port, ref = (getattr(td, name), getattr(jd, name)) if name.startswith("DIFF") else (getattr(ts, name),
                                                                                       getattr(js, name))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
