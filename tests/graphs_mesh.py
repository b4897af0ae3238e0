"""Shared helper (no tests of its own) of the port's graphed-loop tests on
a mesh: the tiny UNet's seeded weights and inputs, the loops each run
eagerly and graphed (``CASES``), and the functions the ranks run
(``tests/torch_dist.py:run_ranks``). It imports no JAX, so that a spawned
rank loads torch and the port alone: ``tests/test_torch_graphs_mesh.py``
runs these on gloo ranks with the emulated runner of
``tests/graphs_emulation.py``, ``tests/test_torch_graphs_cuda.py`` on NCCL
ranks with real CUDA graphs.
"""

from __future__ import annotations

import copy
import os
import tempfile
from types import SimpleNamespace

import numpy as np
import torch

F = 4
SAMPLE = (1, F, 8, 8, 4)
PROMPTS = ["a rabbit is jumping on the grass", "a origami rabbit is jumping on the grass"]
# at 4 steps: LocalBlend from step 1, the cross window 2 steps, the
# temporal window [0, 3): every loop has a variant that repeats
CTRL = dict(is_replace_controller=False, cross_replace_steps=0.5, self_replace_steps=0.75,
            blend_words=(("rabbit",), ("rabbit",)), start_blend=0.25,
            equalizer_params={"words": ["origami"], "values": [2]})
STEPS = 4
INNER = 3
# null-text's early stop at this ε (dependent noise, w 0.2): outer step 0
# stops after 1 inner step, the others run all 3
NT_EPSILON = 7.0
# the JAX case: tests/test_torch_parallel.py's null-text (3 steps of 4
# inner steps; outer step 0 stops after 2, the others run all 4)
JAX_NT = dict(steps=3, inner=4, epsilon=4.2)
DEPENDENT = dict(num_frames=F, decay_rate=0.3, window_size=2, ar_sample=True, ar_coeff=0.1)
SPECS = ("1,2,1", "1,1,2")


def _weights(seed: int = 4) -> dict:
    """A seeded tiny UNet's state dict, every tensor moved off its init
    (zero-initialized projections included)."""
    from videop2p_tpu_torch.models.unet import UNet3DConditionModel, UNet3DConfig

    torch.manual_seed(seed)
    model = UNet3DConditionModel(UNet3DConfig.tiny())
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _inputs(seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    return dict(x=rng.normal(size=SAMPLE).astype(np.float32),
                text=rng.normal(size=(1, 77, 16)).astype(np.float32),
                cond=rng.normal(size=(2, 77, 16)).astype(np.float32),
                uncond=rng.normal(size=(77, 16)).astype(np.float32))


def _models(sd, inp, spec, device="cpu"):
    """The rank's sharded UNet and the loops' inputs (its frames of x)."""
    from videop2p_tpu_torch.cli.common import setup_mesh
    from videop2p_tpu_torch.control import make_controller
    from videop2p_tpu_torch.core import DDIMScheduler
    from videop2p_tpu_torch.core.ddpm import DDPMScheduler
    from videop2p_tpu_torch.core.noise import DependentNoiseSampler
    from videop2p_tpu_torch.models.unet import UNet3DConditionModel, UNet3DConfig
    from videop2p_tpu_torch.parallel.mesh import frames_slice
    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.utils.tokenizers import WordTokenizer

    device = torch.device(device)
    unet = UNet3DConditionModel(UNet3DConfig.tiny())
    unet.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    unet = unet.eval().to(device)
    bundle = SimpleNamespace(unet=unet)
    mesh = setup_mesh(bundle, spec, F, device=device)
    dev = {k: torch.from_numpy(v).to(device) for k, v in inp.items()}
    return dict(unet=unet, fn=make_unet_fn(unet), mesh=mesh, sched=DDIMScheduler.create_sd(),
                ddpm=DDPMScheduler.create_sd(),
                ctx=make_controller(PROMPTS, WordTokenizer(), STEPS, device=device, **CTRL),
                sampler=DependentNoiseSampler.create(device=device, **DEPENDENT),
                x=frames_slice(dev["x"], mesh).contiguous(), text=dev["text"],
                cond=dev["cond"], uncond=dev["uncond"], device=device)


def _gen(m, seed):
    return torch.Generator(m["device"]).manual_seed(seed)


def _flat(tree, name="") -> dict:
    if isinstance(tree, torch.Tensor):
        return {name: tree.detach()}
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{name}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{name}/{i}").items()}
    if hasattr(tree, "__dataclass_fields__"):
        return _flat({f: getattr(tree, f) for f in tree.__dataclass_fields__}, name)
    return {}


# ---- the loops, each ``case(m, graphs)`` → {name: tensor} -------------------

def _cached_fast_edit(m, graphs, records=False):
    from videop2p_tpu_torch.obs.comm import make_device_probe
    from videop2p_tpu_torch.pipelines import cached_fast_edit
    from videop2p_tpu_torch.pipelines.cached import capture_windows

    cross_len, window = capture_windows(m["ctx"], STEPS)
    kw = dict(telemetry=True, attn_maps=True,
              device_probe=make_device_probe(m["mesh"])) if records else {}
    out = cached_fast_edit(m["fn"], m["sched"], m["x"], m["cond"][:1], m["cond"], m["uncond"],
                           m["ctx"], num_inference_steps=STEPS, cross_len=cross_len,
                           self_window=window, cuda_graphs=graphs, **kw)
    return _flat(out)


def _live_edit(m, graphs):
    from videop2p_tpu_torch.pipelines import edit_sample

    return _flat(edit_sample(m["fn"], m["sched"], m["x"].expand(2, *m["x"].shape[1:]),
                             m["cond"], m["uncond"], num_inference_steps=STEPS, ctx=m["ctx"],
                             eta=0.1, generator=_gen(m, 3), dependent_sampler=m["sampler"],
                             cuda_graphs=graphs))


def _inversion(m, graphs):
    from videop2p_tpu_torch.pipelines import ddim_inversion

    return _flat(ddim_inversion(m["fn"], m["sched"], m["x"], m["cond"][:1],
                                num_inference_steps=STEPS, dependent_weight=0.2,
                                dependent_sampler=m["sampler"], generator=_gen(m, 5),
                                cuda_graphs=graphs))


def _null_text(m, graphs, mode="optimize"):
    from videop2p_tpu_torch.pipelines import ddim_inversion, null_text_optimization

    traj = ddim_inversion(m["fn"], m["sched"], m["x"], m["cond"][:1],
                          num_inference_steps=STEPS, cuda_graphs=False)
    emb, losses, inner = null_text_optimization(
        m["fn"], m["sched"], traj, m["cond"][:1], m["uncond"][None], num_inference_steps=STEPS,
        num_inner_steps=INNER, epsilon=NT_EPSILON, null_text_mode=mode, hybrid_inner_steps=INNER,
        return_losses=True, return_inner_steps=True, dependent_weight=0.2,
        dependent_sampler=m["sampler"], generator=_gen(m, 7), cuda_graphs=graphs)
    return {"embeddings": emb, "losses": losses, "inner_steps": inner}


def _stage1(m, graphs):
    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.train import TrainState, TuneConfig, make_optimizer, train_steps

    unet = copy.deepcopy(m["unet"]).train()
    tx = make_optimizer(TuneConfig(learning_rate=1e-3, max_grad_norm=0.05))
    state = TrainState.create(unet, tx)
    _, losses = train_steps(make_unet_fn(unet), tx, state, m["ddpm"], 0.5 * m["x"], m["text"],
                            11, num_steps=3, dependent_sampler=m["sampler"], cuda_graphs=graphs)
    out = {"losses": losses}
    out.update({f"param/{k}": v.detach() for k, v in state.trainable.items()})
    out.update({f"mu/{i}": v for i, v in enumerate(state.opt_state["mu"])})
    out.update({f"nu/{i}": v for i, v in enumerate(state.opt_state["nu"])})
    return out


CASES = {
    "cached_fast_edit": _cached_fast_edit,
    "fast_edit_records": lambda m, graphs: _cached_fast_edit(m, graphs, records=True),
    "live_edit": _live_edit,
    "ddim_inversion": _inversion,
    "null_text_optimize": _null_text,
    "null_text_hybrid": lambda m, graphs: _null_text(m, graphs, mode="hybrid"),
    "stage1": _stage1,
}


class _factory:
    """Routes every loop's runner to ``make(device, name)`` inside the
    block (the spawned rank has no pytest monkeypatch)."""

    def __init__(self, make):
        self.make = make

    def __enter__(self):
        from videop2p_tpu_torch.utils import cuda_graphs

        self.saved = cuda_graphs.step_graphs
        cuda_graphs.step_graphs = lambda flag, device, name: self.make(device, name)

    def __exit__(self, *exc):
        from videop2p_tpu_torch.utils import cuda_graphs

        cuda_graphs.step_graphs = self.saved


def _mismatches(a: dict, b: dict) -> list:
    return sorted(set(a) ^ set(b)) + [k for k in sorted(set(a) & set(b))
                                      if not torch.equal(a[k], b[k])]


def _comm_analysis(run, analysed: bool, path: str) -> tuple:
    """The ``comm_analysis`` of an instrumented program's first call of
    ``run`` (None when it wrote none), the program analysis on or off, and
    the reasons of its ``program_analysis_skipped`` events."""
    from videop2p_tpu_torch.obs import RunLedger, read_ledger
    from videop2p_tpu_torch.obs.ledger import instrumented_program

    saved = os.environ.pop("VIDEOP2P_OBS_NO_ANALYSIS", None)
    if not analysed:
        os.environ["VIDEOP2P_OBS_NO_ANALYSIS"] = "1"
    try:
        led = RunLedger(path, meta={}).activate()
        try:
            instrumented_program(run, program="cached_invert_edit")()
        finally:
            led.close()
    finally:
        os.environ.pop("VIDEOP2P_OBS_NO_ANALYSIS", None)
        if saved is not None:
            os.environ["VIDEOP2P_OBS_NO_ANALYSIS"] = saved
    events = read_ledger(path)
    recs = [{k: v for k, v in e.items() if k != "t"} for e in events
            if e["event"] == "comm_analysis"]
    assert len(recs) <= 1, recs
    return (recs[0] if recs else None,
            [e["reason"] for e in events if e["event"] == "program_analysis_skipped"])


def _loops_worker(rank, world, sd, inp, spec, cases):
    """Each case eagerly, then under the emulated runner, on this rank:
    the names whose bits differ, the replays, the forbidden ops, the
    variant keys, and whether the collectives matched; then the first
    call's ``comm_analysis`` both ways."""
    from tests.graphs_emulation import emulated_runner_class
    from videop2p_tpu_torch.obs.introspect import analysis_active
    from videop2p_tpu_torch.parallel.mesh import CommRecorder, set_active_mesh
    from videop2p_tpu_torch.utils.cuda_graphs import StepGraphs

    m = _models(sd, inp, spec)
    emulated = emulated_runner_class()
    out = {}
    for case in cases:
        with CommRecorder() as eager_comm, \
                _factory(lambda device, name: StepGraphs(device, enabled=False, name=name)):
            eager = CASES[case](m, False)
        emulated.log = []
        with CommRecorder() as graphed_comm, _factory(emulated):
            graphed = CASES[case](m, True)
        runners = list(emulated.log)
        out[case] = dict(
            mismatches=_mismatches(eager, graphed), names=len(eager),
            replays=sum(r.replays for r in runners),
            forbidden=[f for r in runners for f in r.forbidden],
            keys=[[repr(k) for k in r.keys] for r in runners],
            comm=eager_comm.sequence == graphed_comm.sequence and bool(eager_comm.sequence),
            inner_steps=([int(i) for i in eager["inner_steps"]]
                         if "inner_steps" in eager else None))
    tmp = tempfile.mkdtemp(prefix="graphs_mesh_")

    def edit():
        return _cached_fast_edit(m, None)

    # where graphs are the default, an analysed call's loops run eagerly
    # (utils/cuda_graphs.py:step_graphs)
    def graphed_default(device, name):
        if analysis_active():
            return StepGraphs(device, enabled=False, name=name)
        return emulated(device, name)

    with _factory(graphed_default):
        graphed, _ = _comm_analysis(edit, True, os.path.join(tmp, f"g{rank}.jsonl"))
        emulated.log = []
        unanalysed, skipped = _comm_analysis(edit, False, os.path.join(tmp, f"u{rank}.jsonl"))
        unanalysed_replays = sum(r.replays for r in emulated.log)
    with _factory(lambda device, name: StepGraphs(device, enabled=False, name=name)):
        eager, _ = _comm_analysis(edit, True, os.path.join(tmp, f"e{rank}.jsonl"))
    out["comm_analysis"] = dict(graphed=graphed, eager=eager, unanalysed=unanalysed,
                                unanalysed_replays=unanalysed_replays, skipped=skipped)
    out["guards"] = _guards(m["mesh"], rank)
    set_active_mesh(None)
    return out


# ---- a served mesh on kept runners -----------------------------------------

SET_KW = dict(tiny=True, width=16, video_len=F, steps=STEPS)
REQUESTS = ((("a rabbit is jumping", "a origami rabbit is jumping"), 2, 1),
            (("a cat rabbit is sitting", "a origami rabbit is sitting"), 3, 2))


def _ask(ps, prompts, eq_value, seed):
    """One request through the set (rank 0's leader): encode, invert and
    capture, edit and decode."""
    frames = np.random.default_rng(seed).integers(0, 256, (F, 16, 16, 3), dtype=np.uint8)
    ctx = ps.controller(list(prompts), blend_word=["rabbit", "rabbit"],
                        eq_params={"words": ["origami"], "values": [eq_value]})
    latents = ps.encode(ps.frames_to_video(frames))
    _, cached = ps.invert_capture(latents, ps.encode_prompts(list(prompts[:1])), ctx)
    videos, src_err = ps.edit_decode(cached, ps.encode_prompts(list(prompts)),
                                     ps.encode_uncond(), ctx, latents)
    return videos.cpu().numpy(), float(src_err)


def _served_worker(rank, world, spec, device="cpu"):
    """Rank 0 leads a set on kept runners (emulated on the CPU):
    warm, then A, B, A; then the same set with graphs "off" answers A and
    B. Rank 1 follows both. Every rank returns its runners' keys in the
    order made and each one's captures, eager steps and replays."""
    from videop2p_tpu_torch.serve import ProgramSet, ProgramSpec
    from videop2p_tpu_torch.serve import programs as programs_mod
    from videop2p_tpu_torch.utils.cuda_graphs import RunnerCache

    if device != "cpu":
        device = f"cuda:{rank}"
    ps = ProgramSet(ProgramSpec(**SET_KW, mesh=spec), device=device)
    if device == "cpu":
        from tests.graphs_emulation import emulated_kept_class

        cls = emulated_kept_class()
        ps._runners = RunnerCache("cpu", max_runners=programs_mod._RUNNERS_MAX,
                                  make=lambda key, name: cls(key=key, name=name))
        ps.keeps_graphs = lambda: True
    assert ps.keeps_graphs()
    made = []
    make = ps._runners._make

    def made_by(key, name):
        runner = make(key, name)
        made.append(runner)
        return runner

    ps._runners._make = made_by
    out = {}
    if rank == 0:
        lead = ps.leader()
        warm = lead.warm(SET_PROMPTS, controller_kwargs=SET_CTRL)
        out["warm_runners"] = warm["runners"]
        out["kept"] = []
        for which in (0, 1, 0):
            before = ps.runner_stats()
            videos, err = _ask(lead, *REQUESTS[which])
            after = ps.runner_stats()
            out["kept"].append(dict(videos=videos, src_err=err, before=before, after=after))
        lead.close()
    else:
        out["follow_kept"] = ps.follow()
    # each runner's program statics (its key's compat part names the
    # rank's device), captures, eager steps and replays
    out["runners"] = [(repr(r.key[0]), r.name, r.totals["graphs"], r.totals["eager_steps"],
                       r.totals["replays"]) for r in made]
    out["forbidden"] = [f for r in made for f in getattr(r, "forbidden", [])]
    out["closed"] = ps.runner_stats()["runners"]
    ps.graphs = "off"
    ps.keeps_graphs = lambda: False
    if rank == 0:
        lead = ps.leader()
        lead.warm(SET_PROMPTS, controller_kwargs=SET_CTRL)
        out["off"] = [_ask(lead, *REQUESTS[which]) for which in (0, 1)]
        lead.close()
    else:
        out["follow_off"] = ps.follow()
    return out


def _failed_capture_worker(rank, world, spec):
    """Rank 0 leads a set on emulated kept runners whose every capture
    fails on rank 0 alone; its warm-up, then a later call. Every rank
    returns what it saw: rank 0 the two calls' errors, rank 1 its follow
    loop's end, and each its runners' graphs kept and replays."""
    from tests.graphs_emulation import emulated_kept_class
    from videop2p_tpu_torch.parallel.distributed import agree_on_capture
    from videop2p_tpu_torch.serve import ProgramSet, ProgramSpec
    from videop2p_tpu_torch.serve import programs as programs_mod
    from videop2p_tpu_torch.utils.cuda_graphs import RunnerCache

    base = emulated_kept_class()

    class FailsOnRank0(base):
        def _capture(self, body, args):
            if rank == 0:
                raise RuntimeError("emulated capture failure")
            return super()._capture(body, args)

    ps = ProgramSet(ProgramSpec(**SET_KW, mesh=spec), device="cpu")
    made = []

    def make(key, name):
        made.append(FailsOnRank0(key=key, name=name, agree=agree_on_capture))
        return made[-1]

    ps._runners = RunnerCache("cpu", max_runners=programs_mod._RUNNERS_MAX, make=make)
    ps.keeps_graphs = lambda: True
    out = {}
    if rank == 0:
        lead = ps.leader()
        for name, call in (("warm", lambda: lead.warm(SET_PROMPTS, controller_kwargs=SET_CTRL)),
                           ("after", lambda: lead.encode_uncond())):
            try:
                call()
                out[name] = None
            except RuntimeError as e:
                out[name] = f"{type(e).__name__}: {e}"
        lead.close()
    else:
        out["follow"] = ps.follow()
    out["graphs"] = sum(len(r._graphs) for r in made)
    out["replays"] = sum(r.replays for r in made)
    return out


SET_PROMPTS = ("a rabbit is jumping", "a origami rabbit is jumping")
SET_CTRL = {"blend_word": ["rabbit", "rabbit"], "eq_params": {"words": ["origami"],
                                                              "values": [2]}}


def _check_served(r0, r1):
    assert r0["warm_runners"]["graphs"] > 0
    for i, call in enumerate(r0["kept"]):
        before, after = call["before"], call["after"]
        assert after["eager_steps"] == before["eager_steps"], (i, before, after)
        assert after["graphs"] == before["graphs"] and after["made"] == before["made"]
        assert after["replays"] > before["replays"]
        want_videos, want_err = r0["off"][(0, 1, 0)[i]]
        assert call["src_err"] == want_err == 0.0
        np.testing.assert_array_equal(call["videos"], want_videos)
    assert r0["runners"] and r0["runners"] == r1["runners"]
    assert r0["forbidden"] == [] and r1["forbidden"] == []
    assert r0["closed"] == r1["closed"] == 0
    assert r1["follow_kept"]["calls"] > 0 and r1["follow_off"]["calls"] > 0


def _guards(mesh, rank) -> dict:
    """Under a (faked) capture on this gloo mesh: what a collective, the
    control channel and a frames draw raise (None: nothing), none of them
    having reached the other rank (a barrier after still pairs)."""
    import torch.distributed as dist

    from videop2p_tpu_torch.parallel.distributed import ControlChannel
    from videop2p_tpu_torch.parallel.mesh import AXIS_FRAMES, AXIS_TENSOR, all_reduce, frames_draw
    from videop2p_tpu_torch.utils import cuda_graphs

    group = mesh.group(AXIS_FRAMES if mesh.shape[AXIS_FRAMES] > 1 else AXIS_TENSOR)
    channel = ControlChannel()
    raised = {}
    saved = cuda_graphs.capturing
    cuda_graphs.capturing = lambda: True
    try:
        for name, fn in (("all_reduce", lambda: all_reduce(torch.ones(2), group)),
                         ("channel", lambda: channel.lead((), lambda d: (lambda: None))
                          if rank == 0 else channel.follow(lambda d: (lambda: None))),
                         ("draw", lambda: frames_draw(lambda s: torch.zeros(s), (1, 2, 1)))):
            try:
                fn()
                raised[name] = None
            except RuntimeError as e:
                raised[name] = str(e)
    finally:
        cuda_graphs.capturing = saved
    dist.barrier()
    return raised


def _null_text_worker(rank, world, sd, inp, steps, inner, epsilon):
    from tests.graphs_emulation import emulated_runner_class
    from videop2p_tpu_torch.parallel.mesh import gather_frames, set_active_mesh
    from videop2p_tpu_torch.pipelines import ddim_inversion, null_text_optimization

    m = _models(sd, inp, "1,2,1")
    emulated = emulated_runner_class()
    emulated.log = []
    with torch.no_grad():
        traj = ddim_inversion(m["fn"], m["sched"], m["x"], m["cond"][:1],
                              num_inference_steps=steps, cuda_graphs=False)
    with _factory(emulated):
        emb, losses, taken = null_text_optimization(
            m["fn"], m["sched"], traj, m["cond"][:1], m["uncond"][None],
            num_inference_steps=steps, num_inner_steps=inner, epsilon=epsilon,
            return_losses=True, return_inner_steps=True, cuda_graphs=True)
    out = dict(emb=emb.numpy(), losses=losses.numpy(), inner=np.asarray(taken),
               replays=sum(r.replays for r in emulated.log),
               traj=gather_frames(traj, m["mesh"], dim=2).numpy())
    set_active_mesh(None)
    return out


def _nccl_worker(rank, world, sd, inp, spec, cases):
    """Each case with ``cuda_graphs=False`` then by default (CUDA graphs on
    an NCCL mesh), in turns: the names whose bits differ, the kernel
    launches of each, the graph stats."""
    from videop2p_tpu_torch.ops import attention as fa
    from videop2p_tpu_torch.ops import groupnorm as gn
    from videop2p_tpu_torch.parallel.mesh import set_active_mesh
    from videop2p_tpu_torch.utils.cuda_graphs import collect_graph_stats

    def launches():
        return (fa.launch_count(), fa.flash_launch_count(),
                tuple(sorted(fa.flash_bwd_launch_counts().items())), gn.launch_count())

    m = _models(sd, inp, spec, device=f"cuda:{rank}")
    out = {}
    for case in cases:
        runs = {}
        for graphs in (False, None, None, False):
            before = launches()
            with collect_graph_stats() as stats:
                got = CASES[case](m, graphs)
            torch.cuda.synchronize()
            after = launches()
            runs.setdefault(graphs, []).append(
                ({k: v.cpu() for k, v in got.items()}, (before, after), stats))
        eager, graphed = runs[False][0][0], runs[None][0][0]
        count = lambda run: [(a - b) if isinstance(a, int) else a  # noqa: E731
                             for b, a in zip(*run[1])]
        out[case] = dict(
            mismatches=_mismatches(eager, graphed) + _mismatches(graphed, runs[None][1][0]),
            same_launches=count(runs[False][0]) == count(runs[None][0]),
            replays=sum(s["replays"] for s in runs[None][1][2]),
            stats=runs[None][1][2])
    set_active_mesh(None)
    return out
