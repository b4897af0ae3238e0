"""The port's distributed observability (``videop2p_tpu_torch/obs/comm.py``,
the ledger's ``comm_analysis`` / ``device_telemetry`` / ``divergence`` /
``host_phase`` events, ``parallel/distributed.py``'s phase records)
against the JAX package's, with a 4-rank gloo group
(``tests/torch_dist.py``) on a (1, 2, 2) mesh for the collective parts.

Differences from JAX, each held here: counts and bytes are per executed
first call on a rank (JAX's are static per compiled module: a scan body
once); ``host_phase`` events appear in a run of more than one process
(one process per GPU), where JAX's single process on a multi-chip host has
none.
"""

import os

import numpy as np
import pytest
import torch

from tests.torch_dist import run_ranks

torch.set_num_threads(1)


def test_schema_constants_match_jax():
    import videop2p_tpu.obs.comm as jax_comm

    from videop2p_tpu_torch.obs import comm

    assert comm.COLLECTIVE_KINDS == jax_comm.COLLECTIVE_KINDS
    assert comm.COMM_ANALYSIS_FIELDS == jax_comm.COMM_ANALYSIS_FIELDS
    assert comm.DEVICE_TELEMETRY_FIELDS == jax_comm.DEVICE_TELEMETRY_FIELDS


@pytest.mark.parametrize("steps,devices", [(3, 4), (1, 2), (0, 2)])
def test_device_stats_decoders_match_jax(steps, devices):
    """``split_device_stats`` / ``summarize_device_stats`` on the same
    channels give JAX's records (a killed run's empty channels included)."""
    from videop2p_tpu.obs.comm import split_device_stats as jax_split
    from videop2p_tpu.obs.comm import summarize_device_stats as jax_summary

    from videop2p_tpu_torch.obs.comm import split_device_stats, summarize_device_stats

    rng = np.random.default_rng(steps)
    stats = {"abs_max": rng.random(steps).astype(np.float32),
             "device_abs_max": rng.random((steps, devices)).astype(np.float32),
             "device_mean": rng.normal(size=(steps, devices)).astype(np.float32),
             "device_nan_count": rng.integers(0, 3, (steps, devices)).astype(np.int32),
             "device_inf_count": np.zeros((steps, devices), np.int32),
             "divergence": rng.random(steps).astype(np.float32) * 1e-3}
    rest, dev = split_device_stats({k: torch.from_numpy(v) for k, v in stats.items()})
    jrest, jdev = jax_split(stats)
    assert set(rest) == set(jrest) and set(dev) == set(jdev)
    ids = list(range(devices))
    assert summarize_device_stats(dev, ids) == jax_summary(jdev, ids)


def test_phase_records_match_jax():
    from videop2p_tpu.parallel import host_phase_record as jax_record
    from videop2p_tpu.parallel import phase_skew as jax_skew

    from videop2p_tpu_torch.parallel import host_phase_record, phase_skew

    assert host_phase_record("edit", 1.234567) == jax_record("edit", 1.234567)
    events = [
        {"event": "host_phase", "name": "edit", "seconds": 1.0, "process_index": 0},
        {"event": "host_phase", "name": "edit", "seconds": 1.5, "process_index": 0},
        {"event": "host_phase", "name": "edit", "seconds": 4.0, "process_index": 1},
        {"event": "phase", "name": "edit", "seconds": 99.0},
        {"event": "host_phase", "seconds": 1.0},
    ]
    assert phase_skew(events) == jax_skew(events)


# --------------------------------------------------------- on 4 ranks --


def _comm_worker(rank, world, tmp):
    from videop2p_tpu_torch.obs.comm import (
        make_device_probe,
        replica_divergence,
        tree_replica_divergence,
    )
    from videop2p_tpu_torch.obs.ledger import RunLedger, instrumented_program
    from videop2p_tpu_torch.parallel import make_mesh, make_ring_temporal_fn, set_active_mesh
    from videop2p_tpu_torch.parallel.distributed import gather_host_phases
    from videop2p_tpu_torch.parallel.mesh import AXIS_FRAMES, AXIS_TENSOR
    from videop2p_tpu_torch.utils.profiling import phase_timer

    # JAX's CLI, run earlier in the parent's process by another test file,
    # may have left the analysis' kill switch set there
    os.environ.pop("VIDEOP2P_OBS_NO_ANALYSIS", None)
    mesh = make_mesh((1, 2, 2))
    out = {"coords": mesh.coords}
    torch.manual_seed(0)
    x = torch.randn(1, 2, 4, 4, 4) + mesh.coords[AXIS_FRAMES]  # this rank's frames
    probe = make_device_probe(mesh)
    ch = probe(x)
    out["probe_axes"] = probe.divergence_axes
    out["probe"] = {k: v.numpy() for k, v in ch.items()}
    # one tensor rank's copy moves: the replicas over "tensor" diverge
    bad = x + (1e-3 if mesh.coords[AXIS_TENSOR] == 1 and mesh.coords[AXIS_FRAMES] == 0 else 0.0)
    out["probe_bad"] = float(probe(bad)["divergence"])
    w = torch.randn(5, 3)
    out["rep"] = float(replica_divergence(w, mesh, axes=(AXIS_FRAMES, AXIS_TENSOR)))
    w_bad = w + (2e-3 if rank == 3 else 0.0)
    out["rep_bad"] = float(replica_divergence(w_bad, mesh, axes=(AXIS_FRAMES, AXIS_TENSOR)))
    out["tree"] = float(tree_replica_divergence({"a": w, "b": [w * 2]}, mesh,
                                                axes=(AXIS_FRAMES,)))
    # a program's first call under a ledger on the active mesh: its
    # program_analysis and the collectives it issued
    set_active_mesh(mesh)
    path = os.path.join(tmp, "ledger.jsonl" if rank == 0 else f"ledger.rank{rank}.jsonl")
    ring = make_ring_temporal_fn(mesh, variant="overlap")
    q = torch.randn(8, 2, 3, 4)
    with RunLedger(path, meta={"cli": "test"}) as led:
        prog = instrumented_program(lambda a: ring(a, a, a), program="ring_pass")
        with phase_timer("ring_phase"):
            prog(q)
            prog(q)
        gather_host_phases(led)
    set_active_mesh(None)
    out["ledger"] = path
    return out


@pytest.fixture(scope="module")
def comm_run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("comm"))
    return tmp, run_ranks(_comm_worker, 4, tmp)


def test_device_probe_and_divergence(comm_run):
    """The probe's channels are every rank's local statistics in rank
    order; the latents (split over frames) must be replicated over
    ``tensor``: divergence 0.0, and a perturbation on one tensor rank shows
    on every rank. ``replica_divergence`` detects an injected perturbation
    of one replica (and reads 0.0 without it)."""
    _, ranks = comm_run
    for r in ranks:
        assert r["probe_axes"] == ("tensor",)
        p = r["probe"]
        assert p["device_abs_max"].shape == (4,) and float(p["divergence"]) == 0.0
        # frames-rank 1's latents are offset by one: their mean shows it
        means = p["device_mean"]
        assert means[2] - means[0] == pytest.approx(1.0, abs=1e-5)
        assert means[0] == means[1] and means[2] == means[3]
        assert r["probe_bad"] == pytest.approx(1e-3, rel=1e-3)
        assert r["rep"] == 0.0 and r["tree"] == 0.0
        assert r["rep_bad"] == pytest.approx(2e-3, rel=1e-3)


def test_comm_analysis_event_counts_the_first_call(comm_run):
    """The first call of an instrumented program on a mesh writes a
    ``program_analysis`` (the counting mode sees through the collectives)
    and a ``comm_analysis`` with JAX's fields: here one overlap ring pass
    over 2 frame ranks, 2 sends of a (8, 2, 3, 4) float32 block."""
    from videop2p_tpu_torch.obs.comm import COMM_ANALYSIS_FIELDS
    from videop2p_tpu_torch.obs.ledger import read_ledger

    _, ranks = comm_run
    for r in ranks:
        events = read_ledger(r["ledger"])
        kinds = [e["event"] for e in events]
        assert kinds.count("program_analysis") == 1 and "program_analysis_skipped" not in kinds
        (rec,) = [e for e in events if e["event"] == "comm_analysis"]
        assert set(COMM_ANALYSIS_FIELDS) <= set(rec)
        assert rec["program"] == "ring_pass" and rec["num_partitions"] == 4
        assert rec["per_kind"] == {"collective-permute": {"count": 2, "bytes": 2 * 8 * 2 * 3 * 4 * 4}}
        assert rec["collective_permute_count"] == 2 and rec["mesh"] == "1,2,2"


def test_host_phases_gathered_on_rank0(comm_run):
    """With 4 processes every ``phase`` is also a ``host_phase``;
    ``gather_host_phases`` brings every rank's into rank 0's ledger, where
    ``phase_skew`` sees 4 hosts (JAX's single process would write none)."""
    from videop2p_tpu_torch.obs.ledger import read_ledger
    from videop2p_tpu_torch.parallel import phase_skew

    _, ranks = comm_run
    events = read_ledger(ranks[0]["ledger"])
    hp = [e for e in events if e["event"] == "host_phase"]
    assert sorted(e["process_index"] for e in hp) == [0, 1, 2, 3]
    assert all(e["process_count"] == 4 for e in hp)
    assert phase_skew(events)["ring_phase"]["hosts"] == 4
    other = [e for e in read_ledger(ranks[1]["ledger"]) if e["event"] == "host_phase"]
    assert [e["process_index"] for e in other] == [1]


def test_jax_tools_render_the_port_comm_ledger(comm_run, capsys):
    """JAX's ``tools/ledger_summary.py`` and report render the port's
    ledger's comm sections."""
    import importlib.util

    from videop2p_tpu.obs.report import render_report

    from videop2p_tpu_torch.obs.ledger import read_ledger
    from videop2p_tpu_torch.obs.report import render_report as port_render

    _, ranks = comm_run
    path = ranks[0]["ledger"]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "ledger_summary_under_torch_comm", os.path.join(repo, "tools", "ledger_summary.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["ledger_summary.py", path]) == 0
    out = capsys.readouterr().out
    assert "collective-permute×2" in out and "per-host phase skew" in out
    events = read_ledger(path)
    for render in (render_report, port_render):
        html = render(events, {})
        assert "Distributed / communication" in html and "collective-permute" in html
