"""The port's Stage-1 tuning pieces against the JAX package's, on the CPU in
float32: the trainable subset and the parameter counts, the lr schedules,
the clipped AdamW and its gradient accumulation against optax; and, port
against port on tiny-UNet weights, gradient checkpointing and the bf16
mixed-precision step. One train step against JAX's is
``tests/test_torch_train_step.py``.

Tolerances: the mask and the parameter counts exactly; lr 1e-7 (float64
closed forms against optax's float32); the optimizer 1e-6 (float32 on both
sides, the same formulas); checkpointing's gradients 1e-6·max|ref|;
mixed precision bit for bit where it claims bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_parity import np32, t, tiny_unet_pair

SHAPE = (1, 4, 8, 8, 4)  # (B, F, h, w, C)
SAMPLER = dict(num_frames=4, decay_rate=0.3, window_size=2, ar_sample=True, ar_coeff=0.1)
LR = 3e-5


def _jax_mask_as_port(params, patterns=None):
    """JAX's trainable mask, carried to port parameter names by the port's
    own weight bridge (``unet_state_dict_from_jax``)."""
    from videop2p_tpu.train import trainable_mask as jax_mask

    from videop2p_tpu_torch.models.convert import unet_state_dict_from_jax

    mask = jax_mask(params) if patterns is None else jax_mask(params, patterns)
    marked = jax.tree.map(lambda p, m: np.full(np.shape(p), float(m), np.float32),
                          params, mask)
    return {k: bool(v.reshape(-1)[0]) for k, v in unet_state_dict_from_jax(marked).items()}


# the patterns where a torch-name suffix rule and JAX's token rule disagree
# (ROADMAP Queue 3 fault 6), with JAX's count of trainable tensors on the
# tiny UNet
TOKEN_RULE_PATTERNS = {
    "1.to_q": 0, "q": 0, "to_out.0": 0, "attentions.0": 0,
    "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q": 0,
    "norm": 8, "proj_in": 8,
}


@pytest.mark.parametrize(
    "patterns", [None, ("attn2.to_q",), ("attn_temp", "ff")]
    + [(p,) for p in TOKEN_RULE_PATTERNS],
    ids=["default", "cross_q", "temporal_ff"] + list(TOKEN_RULE_PATTERNS))
def test_trainable_set_maps_one_to_one_onto_jax(patterns):
    from videop2p_tpu.models import UNet3DConditionModel, UNet3DConfig

    from videop2p_tpu_torch.models.unet import UNet3DConditionModel as PortUNet
    from videop2p_tpu_torch.models.unet import UNet3DConfig as PortConfig
    from videop2p_tpu_torch.train import partition_params, trainable_mask

    jmodel = UNet3DConditionModel(config=UNet3DConfig.tiny())
    params = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros(SHAPE), jnp.asarray(0),
                            jnp.zeros((1, 77, 16)))["params"]
    want = _jax_mask_as_port(params, patterns)
    with torch.device("meta"):
        pmodel = PortUNet(PortConfig.tiny())
    got = trainable_mask(pmodel) if patterns is None else trainable_mask(pmodel, patterns)
    assert got == want
    if patterns is not None and patterns[0] in TOKEN_RULE_PATTERNS:
        assert sum(got.values()) == TOKEN_RULE_PATTERNS[patterns[0]]
    else:
        assert 0 < sum(got.values()) < len(got)
    trainable, frozen = partition_params(pmodel, *(() if patterns is None else (patterns,)))
    assert sorted(trainable) == sorted(k for k, m in got.items() if m)
    assert all(p.requires_grad for p in trainable.values())
    assert not any(p.requires_grad for p in frozen.values())


@pytest.mark.parametrize("preset", ["tiny", "sd15"])
def test_count_params_matches_jax(preset):
    """JAX through ``jax.eval_shape``, the port on the meta device: nothing
    is allocated on either side."""
    from videop2p_tpu.models import UNet3DConditionModel, UNet3DConfig
    from videop2p_tpu.train import count_params as jax_count
    from videop2p_tpu.train import trainable_mask as jax_mask

    from videop2p_tpu_torch.models.unet import UNet3DConditionModel as PortUNet
    from videop2p_tpu_torch.models.unet import UNet3DConfig as PortConfig
    from videop2p_tpu_torch.train import count_params, trainable_mask

    jcfg = getattr(UNet3DConfig, preset)()
    ctx_dim = jcfg.cross_attention_dim
    params = jax.eval_shape(UNet3DConditionModel(config=jcfg).init, jax.random.key(0),
                            jnp.zeros((1, 2, 8, 8, 4)), jnp.asarray(0),
                            jnp.zeros((1, 77, ctx_dim)))["params"]
    with torch.device("meta"):
        pmodel = PortUNet(getattr(PortConfig, preset)())
    assert count_params(pmodel) == jax_count(params)
    assert (count_params(pmodel, trainable_mask(pmodel))
            == jax_count(params, jax_mask(params)))


@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("name", ["constant", "constant_with_warmup", "linear", "cosine"])
def test_lr_schedules_match_optax(name, warmup):
    from videop2p_tpu.train import TuneConfig as JaxCfg
    from videop2p_tpu.train import make_lr_schedule as jax_schedule

    from videop2p_tpu_torch.train import TuneConfig, make_lr_schedule

    kw = dict(learning_rate=1e-3, lr_scheduler=name, lr_warmup_steps=warmup,
              max_train_steps=8)
    want, got = jax_schedule(JaxCfg(**kw)), make_lr_schedule(TuneConfig(**kw))
    for step in range(kw["max_train_steps"] + 3):
        assert abs(got(step) - float(want(step))) <= 1e-7, (step, got(step), want(step))
    scaled = TuneConfig(**kw, scale_lr=True, gradient_accumulation_steps=2, train_batch_size=3)
    assert abs(make_lr_schedule(scaled)(7) - float(jax_schedule(JaxCfg(
        **kw, scale_lr=True, gradient_accumulation_steps=2, train_batch_size=3))(7))) <= 1e-7
    with pytest.raises(ValueError, match="lr_scheduler"):
        make_lr_schedule(TuneConfig(lr_scheduler="step"))


def _grads(rng, shapes, steps, scales):
    return [[(rng.normal(size=s) * sc).astype(np.float32) for s in shapes]
            for _, sc in zip(range(steps), scales)]


@pytest.mark.parametrize("accumulate", [1, 2])
def test_clipped_adamw_matches_optax(accumulate):
    """The written-out optimizer against JAX's ``make_optimizer`` (optax
    clip + adamw, in ``MultiSteps`` when accumulating) on random tensors, a
    linear schedule with warmup, gradients above and below the clip norm."""
    from videop2p_tpu.train import TuneConfig as JaxCfg
    from videop2p_tpu.train import make_optimizer as jax_optimizer

    from videop2p_tpu_torch.train import TuneConfig, make_optimizer

    kw = dict(learning_rate=1e-2, lr_scheduler="linear", lr_warmup_steps=1,
              max_train_steps=4, max_grad_norm=1.0, gradient_accumulation_steps=accumulate)
    rng = np.random.default_rng(3)
    shapes = [(4, 5), (7,)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    steps = 3 * accumulate
    grads = _grads(rng, shapes, steps, [3.0, 0.05, 1.5, 0.1, 2.0, 0.2])
    jtx = jax_optimizer(JaxCfg(**kw))
    jp = {f"p{i}": jnp.asarray(p) for i, p in enumerate(p0)}
    jstate = jtx.init(jp)
    tx = make_optimizer(TuneConfig(**kw))
    tp = [t(p) for p in p0]
    state = tx.init(tp)
    for k, g in enumerate(grads):
        updates, jstate = jtx.update({f"p{i}": jnp.asarray(x) for i, x in enumerate(g)},
                                     jstate, jp)
        jp = optax.apply_updates(jp, updates)
        moved = tx.update_(tp, [t(x) for x in g], state)
        assert moved == ((k + 1) % accumulate == 0)
        for i, p in enumerate(tp):
            np.testing.assert_allclose(np32(p), np.asarray(jp[f"p{i}"]), rtol=0, atol=1e-6,
                                       err_msg=f"step {k} p{i}")
    assert state["count"] == steps // accumulate


@pytest.fixture(scope="module")
def pair():
    jmodel, variables, pmodel = tiny_unet_pair(seed=6, frames=SHAPE[1])
    rng = np.random.default_rng(5)
    return dict(jmodel=jmodel, variables=variables, pmodel=pmodel,
                latents=(0.5 * rng.normal(size=SHAPE)).astype(np.float32),
                text=rng.normal(size=(1, 77, 16)).astype(np.float32))


def test_gradient_checkpointing_gives_the_same_gradients_and_saves_less(pair):
    """One loss and its trainable gradients with the blocks recomputed
    against the same without; the tensors autograd keeps outside the
    recomputed blocks are a fraction of those it keeps without."""
    import copy
    import dataclasses

    from videop2p_tpu_torch.train import partition_params

    out = {}
    for remat in (False, True):
        model = copy.deepcopy(pair["pmodel"])
        model.config = dataclasses.replace(model.config, gradient_checkpointing=remat)
        trainable, _ = partition_params(model)
        saved = []

        def pack(x):
            saved.append(x.numel() * x.element_size())
            return x

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            eps = model(t(pair["latents"]), torch.tensor([321]), t(pair["text"]))
        loss = (eps ** 2).mean()
        grads = torch.autograd.grad(loss, list(trainable.values()))
        out[remat] = (loss.item(), grads, sum(saved))
    assert out[True][0] == out[False][0]
    for a, b in zip(out[True][1], out[False][1]):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max()
    assert 0 < out[True][2] < out[False][2] / 4, (out[True][2], out[False][2])


def _old_layer_forwards(monkeypatch):
    """The layers' forwards as they were before weights could differ in
    dtype from the activations: torch's own, and the weights as stored."""
    import torch.nn.functional as F
    from torch import nn

    from videop2p_tpu_torch.models import attention, layers
    from videop2p_tpu_torch.ops.groupnorm import fused_group_norm

    def conv(self, x):
        b, f, h, w, c = x.shape
        y = nn.Conv2d.forward(self, x.reshape(b * f, h, w, c).permute(0, 3, 1, 2))
        y = y.permute(0, 2, 3, 1)
        return y.reshape(b, f, *y.shape[1:])

    def gn(self, x):
        n, c = x.shape[0], x.shape[-1]
        return fused_group_norm(x.reshape(n, -1, c).contiguous(), self.weight, self.bias,
                                num_groups=self.num_groups, eps=self.eps,
                                act=self.act).reshape(x.shape)

    monkeypatch.setattr(layers.Linear, "forward", nn.Linear.forward)
    monkeypatch.setattr(layers.LayerNorm, "forward", nn.LayerNorm.forward)
    monkeypatch.setattr(layers.InflatedConv, "forward", conv)
    monkeypatch.setattr(layers.TpuGroupNorm, "forward", gn)
    monkeypatch.setattr(attention.Conv1x1, "forward",
                        lambda self, x: F.linear(x, self.weight[:, :, 0, 0], self.bias))


def test_bf16_mixed_precision_step(pair, tmp_path, monkeypatch):
    """float32 weights, a bfloat16 UNet forward: one step at lr 3e-5 moves
    every trainable tensor (bf16 storage would not: its spacing near 0.05 is
    2.4e-4), leaves every frozen one bit for bit, exports float32 tensors
    equal to those in memory; and that forward is the Stage-2 bf16 forward
    (the module cast to bf16) bit for bit, whose layers give the same bits
    as torch's own layers did."""
    import copy

    from videop2p_tpu_torch.core import DDPMScheduler
    from videop2p_tpu_torch.models import convert
    from videop2p_tpu_torch.models.pipeline_io import save_pipeline
    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.train import TrainState, TuneConfig, make_optimizer, train_step

    model = copy.deepcopy(pair["pmodel"])
    model.compute_dtype = torch.bfloat16
    loaded = {k: v.clone() for k, v in model.state_dict().items()}
    x, text = t(pair["latents"]), t(pair["text"])
    with torch.no_grad():
        eps_mixed = model(x, 500, text)
        stage2 = copy.deepcopy(pair["pmodel"]).to(torch.bfloat16)
        eps_stage2 = stage2(x, 500, text)
        with monkeypatch.context() as m:
            _old_layer_forwards(m)
            eps_before = stage2(x, 500, text)
    assert eps_mixed.dtype == torch.bfloat16
    assert torch.equal(eps_mixed, eps_stage2)
    assert torch.equal(eps_stage2, eps_before)

    tx = make_optimizer(TuneConfig(learning_rate=LR))
    state = TrainState.create(model, tx)
    gen = torch.Generator().manual_seed(0)
    _, loss = train_step(make_unet_fn(model), tx, state, DDPMScheduler.create_sd(), x, text, gen)
    assert torch.isfinite(loss)
    for name, p in state.trainable.items():
        assert p.dtype == torch.float32
        assert not torch.equal(p, loaded[name]), name
    for name, p in state.frozen.items():
        assert torch.equal(p, loaded[name]), name
    save_pipeline(str(tmp_path), model.config, model.state_dict())
    exported = convert.load_state_dict(str(tmp_path / "unet"
                                           / "diffusion_pytorch_model.safetensors"))
    assert sorted(exported) == sorted(loaded)
    for name, p in model.state_dict().items():
        assert exported[name].dtype == torch.float32
        assert torch.equal(exported[name], p), name
