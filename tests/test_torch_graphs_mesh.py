"""The port's graphed step loops on a mesh (``utils/cuda_graphs.py`` with
``parallel/mesh.py``), on the CPU: 2 gloo ranks (``tests/torch_dist.py``)
at (1,2,1) and (1,1,2), the tiny UNet, float32.

A CUDA graph captures a step body's NCCL collectives with its kernels and
replays them in the captured order. Here the emulated runner of
``tests/graphs_emulation.py`` keeps ``StepGraphs``' policy (a variant's
first step eager, its second "captured" with that step's Python values,
later ones "replayed" by running the captured body again on the current
buffers), so a replay issues the body's gloo collectives again, as a graph
replays its NCCL ones. Checked:

  * the cached fast edit, the live edit (η noise), ``ddim_inversion``
    (dependent noise), null-text "optimize" (early stop) and "hybrid", and
    3 Stage-1 steps: the emulated graphs give the same mesh's eager bits,
    bit for bit, with replays, the same collectives in the same order, and
    no op in a replayed body that reads a value to the host;
  * the device probe's and ``attn_maps``' per-step records the same bits;
  * an instrumented first call's ``comm_analysis`` where graphs are the
    default (the analysed call runs the eager loops) equal to a
    ``cuda_graphs=False`` call's; with the analysis off the call replays
    and writes no ``comm_analysis`` (the JAX package's rule);
  * a served 2-rank mesh on emulated kept runners answering A, B, A with
    the bits of a set whose graphs are "off", both ranks making the same
    runners and capturing, warming and replaying the same steps; a capture
    that fails on one rank failing the call on both, neither replaying;
  * ``graphs_default`` on a CUDA mesh; a capture reaching a gloo group, the
    control channel or a draw raising; a replay adding the collectives its
    capture recorded;
  * the graphed null-text of 2 ranks against the JAX package's
    single-process ``null_text_optimization``.

The workers and the loops live in ``tests/graphs_mesh.py``, whose cases
``tests/test_torch_graphs_cuda.py`` also runs with real CUDA graphs over
NCCL on the cards.

Run alone: ``python -m pytest tests/test_torch_graphs_mesh.py -q``.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.graphs_mesh import (
    CASES,
    INNER,
    JAX_NT,
    SPECS,
    _check_served,
    _failed_capture_worker,
    _inputs,
    _loops_worker,
    _null_text_worker,
    _served_worker,
    _weights,
)
from tests.test_torch_parity import TEST_THREADS  # noqa: F401 — one thread a process
from tests.torch_dist import run_ranks

# test_torch_parallel.py's tolerance of the eager mesh's null-text
NT_EMB_TOL = 1e-3
F = 4

_RUNS: dict = {}


def _loops(spec):
    if spec not in _RUNS:
        _RUNS[spec] = run_ranks(_loops_worker, 2, _weights(), _inputs(), spec, list(CASES),
                                timeout=300.0)
    return _RUNS[spec]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("spec", SPECS)
def test_graphed_mesh_loops_give_the_eager_bits(spec, case):
    """On each rank the emulated graphs give the same mesh's eager loop
    bit for bit, with replays and the same collectives in the same order;
    both ranks run the same variant keys."""
    ranks = _loops(spec)
    for rank, r in enumerate(ranks):
        got = r[case]
        assert got["names"] and got["mismatches"] == [], (rank, got["mismatches"][:5])
        assert got["replays"] > 0 and got["comm"], (rank, got["replays"], got["comm"])
    assert ranks[0][case]["keys"] == ranks[1][case]["keys"]
    if case == "null_text_optimize":
        inner = ranks[0][case]["inner_steps"]
        assert inner == ranks[1][case]["inner_steps"]
        assert min(inner) < INNER and max(inner) > 1, inner  # early stop at some steps


@pytest.mark.parametrize("spec", SPECS)
def test_mesh_step_bodies_make_no_host_values(spec):
    """No captured or replayed body on a mesh ran an op that reads a
    value to the host or makes a tensor from one (the collectives'
    included)."""
    for r in _loops(spec):
        for case in CASES:
            assert r[case]["forbidden"] == [], (case, r[case]["forbidden"][:5])


@pytest.mark.parametrize("spec", SPECS)
def test_a_graphed_first_call_keeps_its_comm_analysis(spec):
    """The ``comm_analysis`` of an instrumented cached fast edit's analysed
    first call where graphs are the default (the analysis runs the eager
    loops) equals a ``cuda_graphs=False`` program's: counts, bytes and the
    fingerprint of the ordered collectives. With the analysis off the
    first call replays graphs and, as in the JAX package, writes
    ``program_analysis_skipped`` and no ``comm_analysis``."""
    for r in _loops(spec):
        rec = r["comm_analysis"]
        assert rec["graphed"] == rec["eager"]
        assert rec["eager"]["collective_count"] > 0 and rec["eager"]["num_partitions"] == 2
        assert rec["unanalysed"] is None and rec["unanalysed_replays"] > 0
        assert rec["skipped"] == ["disabled"]


def test_a_served_mesh_keeps_its_runners_on_every_rank():
    """A (1,2,1) set served from rank 0 on emulated kept runners: after
    warm, A, B and A again run no step eagerly and capture nothing on rank
    0, and their videos and src_err (0.0) are the graphs-off set's bit for
    bit; both ranks made the same runners in the same order and captured,
    warmed up and replayed the same steps; closing the leader frees every
    rank's runners."""
    r0, r1 = run_ranks(_served_worker, 2, "1,2,1", timeout=300.0)
    _check_served(r0, r1)


def test_a_failed_capture_fails_every_rank_of_a_served_mesh():
    """A (1,2,1) set served from rank 0 whose captures fail on rank 0
    alone: the warm-up fails on every rank at its first capture (rank 1,
    whose own capture succeeded, raises too and never replays it), the
    channel is broken for later calls, and closing the leader releases
    rank 1: no rank hangs."""
    r0, r1 = run_ranks(_failed_capture_worker, 2, "1,2,1", timeout=240.0)
    assert "emulated capture failure" in r0["warm"] and "rank(s) [0]" in r0["warm"], r0
    assert "broken" in r0["after"], r0
    assert r1["follow"]["calls"] > 0
    assert r0["graphs"] == r1["graphs"] == 0 and r0["replays"] == r1["replays"] == 0


# ---- the defaults and the guards --------------------------------------------

def test_graphs_default_on_a_cuda_mesh(monkeypatch):
    """On a CUDA device graphs are the default on one card, on a mesh of
    NCCL groups and under an NCCL world without a mesh; a gloo group, the
    CPU, or ``VIDEOP2P_CUDA_GRAPHS=0`` keeps the eager loops; a served set
    keeps runners wherever the default holds (a leader's too)."""
    import torch.distributed as dist

    from videop2p_tpu_torch.parallel import mesh as mesh_mod
    from videop2p_tpu_torch.serve.programs import ProgramSet
    from videop2p_tpu_torch.utils import cuda_graphs

    monkeypatch.delenv("VIDEOP2P_CUDA_GRAPHS", raising=False)
    groups = {"data": None, "frames": "g_frames", "tensor": "g_tensor"}
    fake = SimpleNamespace(groups=groups)
    backends = {"g_frames": "nccl", "g_tensor": "nccl", None: "nccl"}
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda g=None: backends[g])
    monkeypatch.setattr(mesh_mod, "_ACTIVE", [fake])
    assert cuda_graphs.graphs_default("cuda") is True
    assert cuda_graphs.resolve_graphs(None, "cuda") is True
    assert cuda_graphs.graphs_default("cpu") is False
    backends["g_tensor"] = "gloo"
    assert cuda_graphs.graphs_default("cuda") is False
    monkeypatch.setattr(mesh_mod, "_ACTIVE", [])
    assert cuda_graphs.graphs_default("cuda") is True
    backends[None] = "gloo"
    assert cuda_graphs.graphs_default("cuda") is False
    backends[None] = "nccl"
    monkeypatch.setenv("VIDEOP2P_CUDA_GRAPHS", "0")
    assert cuda_graphs.graphs_default("cuda") is False
    monkeypatch.delenv("VIDEOP2P_CUDA_GRAPHS")
    ps = SimpleNamespace(graphs="kept", needs_leader=True, device=torch.device("cuda", 0))
    assert ProgramSet.keeps_graphs(ps) is True
    ps.graphs = "off"
    assert ProgramSet.keeps_graphs(ps) is False


@pytest.mark.parametrize("spec", SPECS)
def test_a_capture_reaching_gloo_raises(spec):
    """A capture that reaches a gloo collective, the gloo control channel,
    or a random draw raises on each rank, naming what it reached."""
    for r in _loops(spec):
        raised = r["guards"]
        assert "gloo group" in raised["all_reduce"], raised
        assert "control channel" in raised["channel"], raised
        assert "frames_draw" in raised["draw"], raised


def test_a_replay_adds_the_collectives_its_capture_recorded(monkeypatch):
    """During a capture a collective's count is recorded, not counted; each
    replay of the graph adds it to the recorders active then, as the kernel
    wrappers' launches are."""
    import torch.distributed as dist

    from videop2p_tpu_torch.parallel.mesh import CommRecorder, note_collective
    from videop2p_tpu_torch.utils import cuda_graphs

    recording = []
    monkeypatch.setattr(dist, "get_backend", lambda g=None: "nccl")
    monkeypatch.setattr(cuda_graphs, "_recording", recording)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with CommRecorder() as during:
        note_collective("all-reduce", 64, "g")
        note_collective("collective-permute", 32, "g")
    assert during.count() == 0 and len(recording) == 2
    monkeypatch.setattr(cuda_graphs, "_recording", None)
    with CommRecorder() as replays:
        for _ in range(3):
            for add, n in recording:
                add(n)
    assert replays.per_kind == {"all-reduce": {"count": 3, "bytes": 192},
                                "collective-permute": {"count": 3, "bytes": 96}}
    assert replays.sequence[:2] == [("all-reduce", 64), ("collective-permute", 32)]


# ---- against the JAX package ------------------------------------------------

def test_graphed_null_text_on_a_mesh_matches_jax():
    """Null-text "optimize" with frames over 2 ranks on emulated graphs
    against the JAX package's single-process ``null_text_optimization`` on
    the same weights and trajectory: the same inner steps, the losses
    within 1e-4 relative and the embeddings within 1e-3
    (``tests/test_torch_parallel.py``'s bounds for the eager mesh)."""
    import jax
    import jax.numpy as jnp

    from tests.test_torch_parity import tiny_unet_pair
    from videop2p_tpu.core import DDIMScheduler
    from videop2p_tpu.pipelines import make_unet_fn
    from videop2p_tpu.pipelines.inversion import null_text_optimization as jax_null_text

    jmodel, variables, pmodel = tiny_unet_pair(seed=4, frames=F)
    sd = {k: v.numpy() for k, v in pmodel.state_dict().items()}
    inp = _inputs(1)
    r0, r1 = run_ranks(_null_text_worker, 2, sd, inp, *JAX_NT.values(), timeout=240.0)
    for key in ("emb", "losses", "inner"):
        np.testing.assert_array_equal(r0[key], r1[key])
    assert r0["replays"] > 0
    with jax.default_matmul_precision("highest"):
        emb, losses, inner = jax_null_text(
            make_unet_fn(jmodel), variables, DDIMScheduler.create_sd(), jnp.asarray(r0["traj"]),
            jnp.asarray(inp["cond"][:1]), jnp.asarray(inp["uncond"][None]),
            num_inference_steps=JAX_NT["steps"], num_inner_steps=JAX_NT["inner"],
            epsilon=JAX_NT["epsilon"], return_losses=True, return_inner_steps=True)
    np.testing.assert_array_equal(r0["inner"], np.asarray(inner))
    assert 0 < r0["inner"].min() < JAX_NT["inner"] == r0["inner"].max(), r0["inner"]
    np.testing.assert_allclose(r0["losses"], np.asarray(losses), rtol=1e-4)
    np.testing.assert_allclose(r0["emb"], np.asarray(emb), atol=NT_EMB_TOL)

