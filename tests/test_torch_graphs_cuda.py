"""CUDA graphs on an NVIDIA card (``utils/cuda_graphs.py``): every
hand-written kernel launched under stream capture and replayed, and the
graphed step loops against their eager loops at tiny width — the same bits
and the same kernel launches; on 2 or 4 cards (one NCCL rank each) the
loops of ``tests/graphs_mesh.py`` on a mesh and a served mesh, their NCCL
collectives captured with them, against the same mesh's eager loops.
Every test carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false (a mesh case, where the cards are
fewer than its ranks).

This file imports neither JAX nor the JAX package: ``python -m pytest
--noconftest tests/test_torch_graphs_cuda.py -m cuda -q`` on the machine
with the card.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

# the helpers by their own names (pytest puts tests/ on the path): on the
# card's machine another installed package may be called "tests"
from graphs_mesh import (
    CASES,
    _check_served,
    _inputs,
    _nccl_worker,
    _served_worker,
    _weights,
)
from torch_dist import run_ranks

# one intra-op thread a test process, as tests/test_torch_parity.py sets it
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs run only there)")
    return torch.device("cuda")


def _launches():
    from videop2p_tpu_torch.ops import attention as fa
    from videop2p_tpu_torch.ops import groupnorm as gn

    return dict(fused=fa.launch_count(), flash=fa.flash_launch_count(),
                **{f"bwd_{k}": v for k, v in fa.flash_bwd_launch_counts().items()},
                gn=gn.launch_count())


def _delta(before):
    now = _launches()
    return {k: now[k] - before[k] for k in now}


def _graphed(fn, *args, replays=2):
    """``fn(*args)`` eagerly, then through a StepGraphs runner (warm-up,
    capture, replays): the eager output, each graphed output, and the
    launches of one eager call and of the graphed calls."""
    from videop2p_tpu_torch.utils.cuda_graphs import StepGraphs

    before = _launches()
    eager = fn(*args)
    torch.cuda.synchronize()
    eager_launches = _delta(before)
    outs = []
    before = _launches()
    with StepGraphs(args[0].device, enabled=True, name="test") as graphs:
        for _ in range(2 + replays):
            outs.append(graphs.kept(graphs.run("k", fn, *args)))
        torch.cuda.synchronize()
        assert graphs.replays == 1 + replays
    return eager, outs, eager_launches, _delta(before)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wrapper", ["fused_frame_attention", "flash_rect_frame_attention"])
def test_cuda_attention_kernels_replay_in_a_graph(cuda, dtype, wrapper):
    """A frame-attention kernel captured in a graph (its TMA maps and
    scratch baked at capture) replays the eager bits on static inputs,
    and each replay counts one launch."""
    from videop2p_tpu_torch.ops import attention as fa

    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(1, 8, 8, 4096, 40, generator=gen, device=cuda).to(dtype)
    k = torch.randn(1, 8, 4096, 40, generator=gen, device=cuda).to(dtype)
    v = torch.randn(1, 8, 4096, 40, generator=gen, device=cuda).to(dtype)
    eager, outs, one, total = _graphed(getattr(fa, wrapper), q, k, v)
    for out in outs:
        assert torch.equal(out, eager)
    assert {k: v * len(outs) for k, v in one.items()} == total


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_group_norm_cooperative_launch_replays_in_a_graph(cuda, dtype):
    """GroupNorm's cooperative persistent launch under stream capture: the
    replays give the eager bits (its grid barrier's counter lives in the
    side stream's scratch)."""
    from videop2p_tpu_torch.ops.groupnorm import fused_group_norm

    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 8 * 4096, 320, generator=gen, device=cuda).to(dtype)
    scale = torch.randn(320, generator=gen, device=cuda)
    bias = torch.randn(320, generator=gen, device=cuda)
    eager, outs, one, total = _graphed(
        lambda x: fused_group_norm(x, scale, bias, num_groups=32, eps=1e-5, act="silu"), x)
    for out in outs:
        assert torch.equal(out, eager)
    assert one["gn"] == 1 and total["gn"] == len(outs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_backward_replays_in_a_graph(cuda, dtype):
    """The flash forward and its dQ and dK/dV kernels through
    ``autograd.grad`` inside a capture (null-text's inner step)."""
    from videop2p_tpu_torch.ops import attention as fa

    gen = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(1, 8, 8, 1024, 80, generator=gen, device=cuda).to(dtype)
    k = torch.randn(1, 8, 1024, 80, generator=gen, device=cuda).to(dtype)
    v = torch.randn(1, 8, 1024, 80, generator=gen, device=cuda).to(dtype)

    def step(q):
        with torch.enable_grad():
            leaf = q.detach().requires_grad_(True)
            out = fa.flash_rect_frame_attention(leaf, k, v)
            (grad,) = torch.autograd.grad(out.float().square().mean(), leaf)
        return grad

    eager, outs, one, total = _graphed(step, q)
    for out in outs:
        assert torch.equal(out, eager)
    assert one["bwd_dq"] == one["bwd_dkv"] == 1
    assert {k: v * len(outs) for k, v in one.items()} == total


@pytest.fixture
def tiny(cuda):
    from videop2p_tpu_torch.control import make_controller
    from videop2p_tpu_torch.core import DDIMScheduler
    from videop2p_tpu_torch.core.ddpm import DDPMScheduler
    from videop2p_tpu_torch.models.unet import UNet3DConditionModel, UNet3DConfig
    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.utils.tokenizers import WordTokenizer

    torch.manual_seed(0)
    model = UNet3DConditionModel(UNet3DConfig.tiny()).to(cuda).eval()
    gen = torch.Generator(device=cuda).manual_seed(0)
    prompts = ["a rabbit is jumping on the grass", "a origami rabbit is jumping on the grass"]
    ctx = make_controller(prompts, WordTokenizer(), 8, is_replace_controller=False,
                          cross_replace_steps=0.5, self_replace_steps=0.75,
                          blend_words=(("rabbit",), ("rabbit",)), start_blend=0.375,
                          equalizer_params={"words": ["origami"], "values": [2]}, device=cuda)
    return dict(model=model, fn=make_unet_fn(model), sched=DDIMScheduler.create_sd(),
                ddpm=DDPMScheduler.create_sd(), ctx=ctx,
                x0=torch.randn(1, 2, 8, 8, 4, generator=gen, device=cuda),
                cond=torch.randn(2, 77, 16, generator=gen, device=cuda),
                uncond=torch.randn(77, 16, generator=gen, device=cuda))


def _both(fn):
    """``fn(cuda_graphs)`` graphed and eager: outputs and launch counts."""
    out = {}
    for flag in (True, False):
        before = _launches()
        res = fn(flag)
        torch.cuda.synchronize()
        out[flag] = (res, _delta(before))
    return out


def _assert_same(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


@pytest.mark.cuda
@pytest.mark.parametrize("reuse", [None, "uniform:2"])
def test_cuda_graphed_cached_fast_edit_is_the_eager_one(tiny, reuse):
    """The cached fast edit at 8 steps with LocalBlend (and a reuse
    schedule): trajectory, captured maps and edit equal bit for bit, the
    same launches."""
    from videop2p_tpu_torch.pipelines import cached_fast_edit
    from videop2p_tpu_torch.pipelines.cached import capture_windows

    cross_len, window = capture_windows(tiny["ctx"], 8)
    runs = _both(lambda flag: cached_fast_edit(
        tiny["fn"], tiny["sched"], tiny["x0"], tiny["cond"][:1], tiny["cond"], tiny["uncond"],
        tiny["ctx"], num_inference_steps=8, cross_len=cross_len, self_window=window,
        reuse_schedule=reuse, telemetry=True, cuda_graphs=flag))
    _assert_same(runs[True][0], runs[False][0])
    assert runs[True][1] == runs[False][1]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["optimize", "amortized"])
def test_cuda_graphed_null_text_is_the_eager_one(tiny, mode):
    """Null-text at 3 outer steps, 3 inner steps with early stop, dependent
    noise: embeddings, losses and inner steps equal bit for bit."""
    from videop2p_tpu_torch.core.noise import DependentNoiseSampler
    from videop2p_tpu_torch.pipelines import ddim_inversion, null_text_optimization

    traj = ddim_inversion(tiny["fn"], tiny["sched"], tiny["x0"], tiny["cond"][:1],
                          num_inference_steps=3)
    sampler = DependentNoiseSampler.create(num_frames=2, decay_rate=0.3, window_size=1,
                                           device=traj.device)
    runs = _both(lambda flag: null_text_optimization(
        tiny["fn"], tiny["sched"], traj, tiny["cond"][:1], tiny["uncond"][None],
        num_inference_steps=3, num_inner_steps=3, epsilon=1e-3, null_text_mode=mode,
        return_losses=True, return_inner_steps=True, dependent_weight=0.2,
        dependent_sampler=sampler,
        generator=torch.Generator(device=traj.device).manual_seed(1), cuda_graphs=flag))
    _assert_same(runs[True][0], runs[False][0])
    assert runs[True][1] == runs[False][1]


@pytest.mark.cuda
@pytest.mark.parametrize("accumulate", [1, 2])
def test_cuda_graphed_train_steps_are_the_eager_ones(tiny, accumulate):
    """Stage 1 at 4 steps with checkpointed blocks: losses, parameters and
    Adam moments equal bit for bit."""
    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.train.tuner import TrainState, TuneConfig, make_optimizer, train_steps

    def run(flag):
        model = copy.deepcopy(tiny["model"])
        model.config = dataclasses.replace(model.config, gradient_checkpointing=True)
        tx = make_optimizer(TuneConfig(learning_rate=3e-3, lr_scheduler="linear",
                                       lr_warmup_steps=2, max_train_steps=4,
                                       gradient_accumulation_steps=accumulate))
        state = TrainState.create(model, tx)
        _, losses = train_steps(make_unet_fn(model), tx, state, tiny["ddpm"],
                                0.5 * tiny["x0"], tiny["cond"][:1], 7, num_steps=4,
                                cuda_graphs=flag)
        return losses, dict(state.trainable), state.opt_state["mu"], state.opt_state["nu"]

    runs = _both(run)
    _assert_same(runs[True][0], runs[False][0])
    assert runs[True][1] == runs[False][1]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["blend_null_text_dependent_eta", "uncontrolled"])
def test_cuda_graphed_live_edit_is_the_eager_one(tiny, kind):
    """The live edit at 8 steps: the official full-CFG layout with
    LocalBlend, null-text embeddings and η 0.3 on dependent noise (drawn
    outside the bodies), and ``ProgramSet.sample``'s uncontrolled CFG:
    latents and records equal bit for bit, the same launches."""
    from videop2p_tpu_torch.core.noise import DependentNoiseSampler
    from videop2p_tpu_torch.pipelines import edit_sample

    gen = torch.Generator(device="cuda").manual_seed(3)
    null = torch.randn(8, 77, 16, generator=gen, device="cuda")
    sampler = DependentNoiseSampler.create(num_frames=2, decay_rate=0.3, window_size=1,
                                           device=null.device)
    blend = kind != "uncontrolled"
    runs = _both(lambda flag: edit_sample(
        tiny["fn"], tiny["sched"], tiny["x0"], tiny["cond"], tiny["uncond"],
        num_inference_steps=8, ctx=tiny["ctx"] if blend else None,
        null_uncond_embeddings=null if blend else None, eta=0.3 if blend else 0.0,
        dependent_sampler=sampler if blend else None,
        generator=torch.Generator(device="cuda").manual_seed(4), telemetry=True,
        attn_maps=True, cuda_graphs=flag))
    _assert_same(runs[True][0], runs[False][0])
    assert runs[True][1] == runs[False][1]


@pytest.mark.cuda
def test_cuda_graphed_ddim_inversion_is_the_eager_one(tiny):
    """The plain DDIM inversion at 6 steps with dependent noise: the
    trajectory equal bit for bit, the same launches."""
    from videop2p_tpu_torch.core.noise import DependentNoiseSampler
    from videop2p_tpu_torch.pipelines import ddim_inversion

    sampler = DependentNoiseSampler.create(num_frames=2, decay_rate=0.3, window_size=1,
                                           device=tiny["x0"].device)
    runs = _both(lambda flag: ddim_inversion(
        tiny["fn"], tiny["sched"], tiny["x0"], tiny["cond"][:1], num_inference_steps=6,
        dependent_weight=0.2, dependent_sampler=sampler,
        generator=torch.Generator(device="cuda").manual_seed(2), cuda_graphs=flag))
    _assert_same(runs[True][0], runs[False][0])
    assert runs[True][1] == runs[False][1]


@pytest.mark.cuda
def test_cuda_graphed_hybrid_null_text_is_the_eager_one(tiny):
    """"hybrid" null-text at 3 outer × 3 inner steps with dependent noise:
    embeddings and losses equal bit for bit, the same launches."""
    from videop2p_tpu_torch.core.noise import DependentNoiseSampler
    from videop2p_tpu_torch.pipelines import ddim_inversion, null_text_optimization

    traj = ddim_inversion(tiny["fn"], tiny["sched"], tiny["x0"], tiny["cond"][:1],
                          num_inference_steps=3, cuda_graphs=False)
    sampler = DependentNoiseSampler.create(num_frames=2, decay_rate=0.3, window_size=1,
                                           device=traj.device)
    runs = _both(lambda flag: null_text_optimization(
        tiny["fn"], tiny["sched"], traj, tiny["cond"][:1], tiny["uncond"][None],
        num_inference_steps=3, null_text_mode="hybrid", hybrid_inner_steps=3,
        return_losses=True, dependent_weight=0.2, dependent_sampler=sampler,
        generator=torch.Generator(device=traj.device).manual_seed(1), cuda_graphs=flag))
    _assert_same(runs[True][0], runs[False][0])
    assert runs[True][1] == runs[False][1]


@pytest.mark.cuda
def test_cuda_graphed_distill_steps_are_the_eager_ones(tiny):
    """Distillation at 4 steps: losses, the student, the head, the EMA
    target and Adam moments equal bit for bit."""
    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.train import (
        DistillConfig,
        DistillState,
        distill_steps,
        init_time_head,
        make_distill_optimizer,
    )

    def run(flag):
        model = copy.deepcopy(tiny["model"])
        cfg = DistillConfig(learning_rate=1e-3, distill_grid=4, boundary_weight=1.5)
        tx = make_distill_optimizer(cfg)
        head = init_time_head(torch.Generator(device="cuda").manual_seed(2), model.config)
        state = DistillState.create(model, head, tx)
        _, losses = distill_steps(make_unet_fn(model), tx, state, tiny["sched"],
                                  0.5 * tiny["x0"], tiny["cond"][:1], 13, num_steps=4, cfg=cfg,
                                  cuda_graphs=flag)
        return (losses, dict(state.trainable), dict(state.head), dict(state.ema_trainable),
                dict(state.ema_head), state.opt_state["mu"], state.opt_state["nu"])

    runs = _both(run)
    _assert_same(runs[True][0], runs[False][0])
    assert runs[True][1] == runs[False][1]


@pytest.fixture
def tiny_sets(cuda):
    """A tiny program set on kept runners and one with graphs off, on the
    same models."""
    from videop2p_tpu_torch.serve import ProgramSet, ProgramSpec

    spec = ProgramSpec(tiny=True, width=16, video_len=2, steps=4)
    kept = ProgramSet(spec, device="cuda")
    off = ProgramSet(spec, bundle=kept.bundle, device="cuda", graphs="off")
    yield kept, off
    kept.close()


def _serve_request(ps, prompts, eq_value, seed):
    import numpy as np

    frames = np.random.default_rng(seed).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    ctx = ps.controller(prompts, blend_word=["rabbit", "rabbit"],
                        eq_params={"words": ["origami"], "values": [eq_value]})
    latents = ps.encode(ps.frames_to_video(frames))
    _, cached = ps.invert_capture(latents, ps.encode_prompts(prompts[:1]), ctx)
    args = (cached, ps.encode_prompts(prompts), ps.encode_prompts([""])[0], ctx, latents)
    videos, src_err = ps.edit_decode(*args)
    torch.cuda.synchronize()
    return videos, float(src_err), args


@pytest.mark.cuda
def test_cuda_a_warm_program_set_serves_without_capturing(tiny_sets):
    """After ``warm()`` two compatible requests (other prompts, equalizer
    and clip) capture no graph and run no step eagerly; their videos and
    src_err (0.0) are a graphs-off set's bit for bit."""
    kept, off = tiny_sets
    prompts = ("a rabbit is jumping", "a origami rabbit is jumping")
    ctrl = {"blend_word": ["rabbit", "rabbit"], "eq_params": {"words": ["origami"],
                                                              "values": [2]}}
    warm = kept.warm(prompts, controller_kwargs=ctrl)
    assert warm["runners"]["runners"] == 2 and warm["runners"]["graphs"] > 0
    assert warm["runners"]["pool_bytes"] > 0
    for req in ((prompts, 3, 1), (("a rabbit is sitting", "a origami rabbit is sitting"), 5, 2)):
        before = kept.runner_stats()
        got = _serve_request(kept, *req)
        after = kept.runner_stats()
        assert (after["eager_steps"], after["graphs"], after["made"]) == (
            before["eager_steps"], before["graphs"], before["made"]), (before, after)
        assert after["replays"] > before["replays"]
        want = _serve_request(off, *req)
        assert got[1] == want[1] == 0.0
        assert torch.equal(got[0], want[0])


@pytest.mark.cuda
def test_cuda_two_threads_on_one_set_get_two_runners(tiny_sets):
    """While one thread holds the warm edit runner, another thread's
    compatible request gets a runner of its own (captured for itself), and
    both threads' results are the graphs-off set's bits."""
    import threading

    kept, off = tiny_sets
    prompts = ("a rabbit is jumping", "a origami rabbit is jumping")
    kept.warm(prompts, controller_kwargs={"blend_word": ["rabbit", "rabbit"],
                                          "eq_params": {"words": ["origami"], "values": [2]}})
    edit = next(r for r in kept._runners.runners() if r.name == "cached_edit")
    want = _serve_request(off, prompts, 4, 3)
    made = kept.runner_stats()["made"]
    out = {}

    def other():
        out["videos"], out["err"], _ = _serve_request(kept, prompts, 4, 3)

    with kept._runners.checkout(edit.key, edit.name) as held:
        assert held is edit
        thread = threading.Thread(target=other)
        thread.start()
        thread.join(timeout=300)
        # this thread's call takes the other thread's runner, returned by now
        mine = kept.edit_decode(*want[2])
    assert kept.runner_stats()["made"] == made + 1
    assert out["err"] == 0.0 and torch.equal(out["videos"], want[0])
    assert torch.equal(mine[0], want[0])


# ---- a mesh: CUDA graphs over NCCL, one card a rank --------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("spec", ("1,2,1", "1,1,2"))
def test_a_served_nccl_mesh_keeps_its_runners_on_every_rank(spec):
    """The served mesh's check on 2 cards with real kept runners: CUDA
    graphs whose NCCL collectives were captured on every rank."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 NVIDIA cards (CUDA graphs over NCCL run only there)")
    r0, r1 = run_ranks(_served_worker, 2, spec, "cuda", timeout=600.0, backend="nccl")
    print(r0["runners"])
    _check_served(r0, r1)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ("1,2,1", "1,1,2", "1,4,1"))
def test_nccl_graphs_on_a_mesh_give_the_eager_bits(spec):
    """On the cards, one rank each: every loop replayed as CUDA graphs with
    its NCCL collectives captured gives the eager loop's bits on the same
    mesh, with the same kernel launches."""
    n = int(np.prod([int(s) for s in spec.split(",")]))
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} NVIDIA cards (CUDA graphs over NCCL run only there)")
    ranks = run_ranks(_nccl_worker, n, _weights(), _inputs(), spec, list(CASES),
                      timeout=900.0, backend="nccl")
    for rank, r in enumerate(ranks):
        for case, got in r.items():
            print(rank, case, got["stats"])
            assert got["mismatches"] == [], (rank, case, got["mismatches"][:5])
            assert got["replays"] > 0 and got["same_launches"], (rank, case, got)
