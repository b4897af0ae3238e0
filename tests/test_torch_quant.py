"""The port's UNet weight quantization against the JAX package's, on the CPU.

A flax kernel keeps its output channel last, a torch weight first: the
port takes each scale over every axis but the first, and its int8 values
must equal JAX's after the bridge's transpose.

Tolerances: int8 values and the set of quantized weights exactly; scales
within 1 ulp (both divide the same float32 absmax by 127; measured equal);
e4m3 values exactly (the same float32 quotient, the same rounding);
``fake_quant_act`` exactly on the same input; the w8 cached fast edit of
each package from its own capture within 1e-2, the unquantized edit's own
limit (``tests/test_torch_cached.py``), stream 0 exactly x_0.

w8a8 rounds every Dense input to one of 255 levels of its tensor's absmax:
a float32 summation-order difference (~1e-7) that lands an element on the
other side of a level moves it by absmax/127, and a walk amplifies that
(measured on these weights: x_T 1.9e-2 apart after 4 inversion steps, the
edit 2.1; on one shared capture 0.23; even single controlled forwards on
the same inputs 0.02-0.03 apart at two of four steps, ~1e-6 at the
others). So w8a8 is held in its parts: ``fake_quant_act`` exactly, the
int8 weights exactly, and the seams where it applies by a smooth probe in
their place, x + tanh(x)/4, through both packages' w8 UNets at the
capture's batch and at the cached edit's controlled batch of every step,
within 1e-5; its whole edit by stream 0 and finiteness.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_cached import setup  # noqa: F401
from tests.test_torch_cached import SHAPE, STEPS
from tests.test_torch_parity import np32, t


@pytest.mark.parametrize("shape", [(40, 24), (3, 3, 8, 16), (1, 1, 16, 4)],
                         ids=["dense", "conv", "conv1x1"])
@pytest.mark.parametrize("storage", ["int8", "float8_e4m3fn"])
def test_quantize_weight_matches_jax(shape, storage):
    from videop2p_tpu.models.quant import quantize_weight as jax_quantize

    from videop2p_tpu_torch.models.quant import quantize_weight

    rng = np.random.default_rng(len(shape))
    kernel = (rng.normal(size=shape) * rng.uniform(0.01, 3.0, size=shape[-1])).astype(
        np.float32)
    kernel[..., 0] = 0.0  # an all-zero channel: the scale's 1e-12 floor
    want = jax_quantize(jnp.asarray(kernel), dtype=getattr(jnp, storage))
    # the torch layout: output channel first
    weight = np.moveaxis(kernel, -1, 0)
    if kernel.ndim == 4:
        weight = np.transpose(kernel, (3, 2, 0, 1))
    got = quantize_weight(t(weight), dtype=getattr(torch, storage))
    wq, ws = np.asarray(want.qvalue), np.asarray(want.scale)
    gq, gs = got.qvalue, got.scale
    assert gq.dtype == getattr(torch, storage) and gs.dtype == torch.float32
    if kernel.ndim == 4:
        wq = np.transpose(wq, (3, 2, 0, 1))
    else:
        wq = np.moveaxis(wq, -1, 0)
    np.testing.assert_array_equal(gq.float().numpy(), wq.astype(np.float32))
    np.testing.assert_array_equal(gs.reshape(-1).numpy(), ws.reshape(-1))
    deq = got.dequantize(torch.float32)
    assert deq.shape == tuple(weight.shape)
    assert (deq - t(weight)).abs().max() <= gs.max() * (0.5 if storage == "int8" else 32)


def test_fake_quant_act_matches_jax():
    from videop2p_tpu.models.quant import fake_quant_act as jax_fq

    from videop2p_tpu_torch.models.quant import fake_quant_act

    x = np.random.default_rng(2).normal(size=(3, 50, 16)).astype(np.float32) * 4
    np.testing.assert_array_equal(np32(fake_quant_act(t(x))),
                                  np.asarray(jax_fq(jnp.asarray(x))))
    ints = torch.arange(5)
    assert fake_quant_act(ints) is ints
    bf = fake_quant_act(t(x).to(torch.bfloat16))
    assert bf.dtype == torch.bfloat16


def test_quant_mode_names_match_jax():
    from videop2p_tpu.models import quant as jq

    from videop2p_tpu_torch.models import quant

    assert quant.QUANT_MODES == jq.QUANT_MODES and quant.SKIP_MODULES == jq.SKIP_MODULES
    for mode in (None, "off", "w8", "w8a8"):
        assert quant.validate_quant_mode(mode) == jq.validate_quant_mode(mode)
    with pytest.raises(ValueError, match="quant_mode"):
        quant.validate_quant_mode("w4")
    assert quant.quant_weight_dtype() == torch.int8
    assert quant.quant_weight_dtype("fp8") == torch.float8_e4m3fn


def test_quantize_unet_params_quantizes_what_jax_does(setup):
    """The set of quantized weights, their int8 values and their scales,
    through the bridge's name map and transposes."""
    from videop2p_tpu.models.convert import quantize_unet_params as jax_qparams
    from videop2p_tpu.models.quant import QuantizedTensor

    from videop2p_tpu_torch.models.convert import quantize_unet_params, unet_state_dict_from_jax
    from videop2p_tpu_torch.models.quant import QuantizedWeight

    s = setup
    jq = jax_qparams(s["params"], mode="w8")
    is_q = lambda x: isinstance(x, QuantizedTensor)  # noqa: E731
    marks = jax.tree.map(lambda x: np.full(np.shape(x), float(is_q(x)), np.float32),
                         jq["params"], is_leaf=is_q)
    want_set = {k for k, v in unet_state_dict_from_jax(marks).items()
                if v.reshape(-1)[0] == 1.0}
    qvalues = unet_state_dict_from_jax(jax.tree.map(
        lambda x: np.asarray(x.qvalue if is_q(x) else x, np.float32), jq["params"],
        is_leaf=is_q))
    model = quantize_unet_params(copy.deepcopy(s["pmodel"]), "w8")
    got = {f"{name}.weight": m.weight for name, m in model.named_modules()
           if isinstance(getattr(m, "weight", None), QuantizedWeight)}
    assert sorted(got) == sorted(want_set) and got
    assert not any(k.startswith(("conv_in.", "conv_out.", "time_embedding."))
                   for k in got)
    for name, qw in got.items():
        np.testing.assert_array_equal(qw.qvalue.float().numpy(), qvalues[name].numpy(),
                                      err_msg=name)
    # weights quantized, biases and norms untouched; the off mode is a no-op
    assert all(p.dim() < 2 or n.startswith(("conv_in", "conv_out", "time_embedding"))
               for n, p in model.named_parameters())
    plain = copy.deepcopy(s["pmodel"])
    assert quantize_unet_params(plain, "off") is plain
    assert all(isinstance(p, torch.nn.Parameter) for _, p in plain.named_parameters())


def _jax_quantized(s, mode, act_quant_fn=None):
    from videop2p_tpu.models.convert import quantize_unet_params as jax_qparams
    from videop2p_tpu.models.quant import fake_quant_act as jax_fq
    from videop2p_tpu.pipelines import make_unet_fn as jax_unet_fn

    from tests.test_torch_parity import tiny_unet_pair

    jmodel = tiny_unet_pair(seed=4, frames=SHAPE[1])[0]
    if mode == "w8a8" or act_quant_fn is not None:
        jmodel = jmodel.clone(act_quant_fn=act_quant_fn or jax_fq)
    return jax_unet_fn(jmodel), jax_qparams(s["params"], mode=mode)


def test_w8a8_seams_match_jax(setup):
    """The activation seams of both packages, a smooth probe in
    ``fake_quant_act``'s place on the w8 UNets, on the same inputs: the
    capture's batch (the source stream) and the cached edit's batch (uncond
    + edit stream, the refine controller on JAX's captured maps) at each
    step's timestep."""
    from videop2p_tpu.models.attention import AttnControl as JaxControl

    from tests.test_torch_cached import _jax_capture, _port_cached

    from videop2p_tpu_torch.models.attention import AttnControl
    from videop2p_tpu_torch.models.convert import quantize_unet_params
    from videop2p_tpu_torch.models.quant import set_act_quant
    from videop2p_tpu_torch.pipelines import make_unet_fn

    s = setup
    jfn, jparams = _jax_quantized(s, "w8", lambda x: x + 0.25 * jnp.tanh(x))
    model = quantize_unet_params(copy.deepcopy(s["pmodel"]), "w8")
    fn = make_unet_fn(set_act_quant(model, lambda x: x + 0.25 * torch.tanh(x)))
    w8_fn = make_unet_fn(quantize_unet_params(copy.deepcopy(s["pmodel"]), "w8"))
    moved = False
    jtraj, jcached = _jax_capture(s)
    cached = _port_cached(jcached)
    text = np.concatenate([s["uncond"][None], s["cond"][1:]])
    src_fwd = jax.jit(lambda p, a, ts: jfn(p, a, ts, s["cond"][:1], None)[0])
    edit_fwd = jax.jit(lambda p, a, ts, i: jfn(p, a, ts, text, JaxControl(
        ctx=s["jctx"], step_index=i, num_uncond=1, cached_base=jcached.base_tree_at(i),
        cached_source=True))[0])
    for i, ts in enumerate(s["psched"].timesteps(STEPS)):
        ts = int(ts)
        x = np.concatenate([jtraj[STEPS - i]] * 2)
        with jax.default_matmul_precision("highest"):
            want_src = src_fwd(jparams, jtraj[STEPS - i], ts)
            want = edit_fwd(jparams, x, ts, jnp.asarray(i))
        with torch.no_grad():
            got_src, _ = fn(t(jtraj[STEPS - i]), ts, t(s["cond"][:1]), None, store=False)
            got, _ = fn(t(x), ts, t(text), AttnControl(
                s["pctx"], i, 1, cached_base=cached.base_tree_at(i), cached_source=True),
                store=False)
        np.testing.assert_allclose(np32(got_src), np.asarray(want_src), atol=1e-5)
        np.testing.assert_allclose(np32(got), np.asarray(want), atol=1e-5)
        with torch.no_grad():
            w8, _ = w8_fn(t(jtraj[STEPS - i]), ts, t(s["cond"][:1]), None, store=False)
        moved = moved or (w8 - got_src).abs().max().item() > 1e-3
    assert moved  # the probe reached the seams


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantized_cached_fast_edit_matches_jax(setup, mode):
    from videop2p_tpu.pipelines.fast import cached_fast_edit as jax_cached_edit

    from videop2p_tpu_torch.models.convert import quantize_unet_params
    from videop2p_tpu_torch.pipelines import cached_fast_edit, make_unet_fn
    from videop2p_tpu_torch.pipelines.cached import capture_windows

    s = setup
    jfn, jparams = _jax_quantized(s, mode)
    cross_len, self_window = capture_windows(s["pctx"], STEPS)
    kw = dict(num_inference_steps=STEPS, guidance_scale=7.5, cross_len=cross_len,
              self_window=self_window)
    with jax.default_matmul_precision("highest"):
        _, want = jax.jit(lambda p, x: jax_cached_edit(
            jfn, p, s["jsched"], x, s["cond"][:1], s["cond"], s["uncond"], s["jctx"],
            **kw))(jparams, s["x0"])
    qmodel = quantize_unet_params(copy.deepcopy(s["pmodel"]), mode)
    _, got = cached_fast_edit(make_unet_fn(qmodel), s["psched"], t(s["x0"]),
                              t(s["cond"][:1]), t(s["cond"]), t(s["uncond"]), s["pctx"], **kw)
    if mode == "w8":
        np.testing.assert_allclose(np32(got), np32(want), atol=1e-2)
    assert torch.isfinite(got).all() and np.isfinite(np32(want)).all()
    assert np.abs(np32(got[0]) - s["x0"][0]).max() == 0.0
    _, plain = cached_fast_edit(s["pfn"], s["psched"], t(s["x0"]), t(s["cond"][:1]),
                                t(s["cond"]), t(s["uncond"]), s["pctx"], **kw)
    assert np.abs(np32(got[1]) - np32(plain[1])).max() > 0
