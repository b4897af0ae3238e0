"""Serving over several devices on the CPU, at the tiny spec
(``tiny=True, width=16, steps=2``): the data mesh's ``vmap`` dispatch over
dp = 2 CPU replicas of one process, and the engine over a model-parallel
mesh of 2 gloo ranks (``tests/torch_dist.py:run_ranks``), rank 0 driving
rank 1 through the host control channel.

Covered: ``vmap`` against the singletons (bit for bit, each member on its
replica) and against the JAX package's ``vmap`` on the same weights and
captures; a data mesh wider than the devices raising; the engine on
(1,2,1) and (1,1,2) — a fresh request, a store hit, a batch of 2 and a
disk hit rehydrated by a second engine — against the one-process engine,
every rank releasing its objects with rank 0's; the disk entry written at
sp = 2 against sp = 1's; a failure in rank 1's host step surfacing on
rank 0 at once while the engine serves on; a failure in rank 1's device
work, and a dispatch the watchdog abandons, breaking the channel loudly;
the engine's ``close()`` releasing the follower.

Tolerances (float32): the mesh engines' videos 2e-3, the tolerance of
``tests/test_torch_parallel.py::test_programset_on_mesh_matches_one_process``
(a sharded forward sums in another order); the persisted trajectory 1e-4,
``tests/test_torch_serve_jax.py``'s; the port's ``vmap`` against JAX's
1e-5 on JAX's captures, the tolerance JAX holds its ``vmap`` to its
singletons with (``tests/test_serve.py``).

The functions the ranks run live here, so this module imports JAX inside
its tests only.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from tests.test_torch_parity import TEST_THREADS  # noqa: F401 — one thread a process
from tests.torch_dist import run_ranks

PROMPTS = ("a rabbit is jumping", "a origami rabbit is jumping")
MESH_TOL = 2e-3
TRAJ_TOL = 1e-4
JAX_TOL = 1e-5
F = 4


def _kw(video_len=F):
    return dict(tiny=True, width=16, video_len=video_len, steps=2)


def _request(**overrides):
    from videop2p_tpu_torch.serve import EditRequest

    kw = dict(image_path="data/rabbit", prompt=PROMPTS[0], prompts=list(PROMPTS),
              save_name="origami")
    kw.update(overrides)
    return EditRequest(**kw)


def _clip(phase: float, frames: int = 2) -> np.ndarray:
    grid = np.arange(frames * 16 * 16 * 3, dtype=np.float64).reshape(frames, 16, 16, 3)
    return (np.abs(np.sin(grid * phase)) * 255).astype(np.uint8)


# ------------------------------------------------------------ data mesh --


def _members(ps, edits):
    members = []
    for phase, edit in edits:
        prompts = [PROMPTS[0], edit]
        ctx = ps.controller(prompts)
        latents = ps.encode(ps.frames_to_video(_clip(phase)))
        _, cached = ps.invert_capture(latents, ps.encode_prompts(prompts[:1]), ctx)
        members.append((cached, ps.encode_prompts(prompts), ps.encode_uncond(), ctx, latents))
    return members


def test_vmap_on_a_data_mesh_gives_its_singletons_bits():
    """dp = 2 CPU replicas (replica 1's weights copied from replica 0): a
    batch of 2 splits one member per replica, each result its singleton's
    bits, no program built after warm; a batch of 3 (dp does not divide
    it) runs on replica 0 alone."""
    from videop2p_tpu_torch.serve import ProgramSet, ProgramSpec

    ps = ProgramSet(ProgramSpec(**_kw(2), mesh="2,1,1"), device="cpu")
    assert len(ps.replicas) == 2 and ps.mesh is None
    rep = ps.replicas[1]
    for name, p in ps.bundle.unet.state_dict().items():
        assert torch.equal(rep.bundle.unet.state_dict()[name], p), name
    warm = ps.warm(PROMPTS)
    assert warm["replicas"] == 2 and warm["src_err"] == 0.0
    members = _members(ps, ((0.1, PROMPTS[1]), (0.37, "a lego rabbit is jumping")))
    ran = {0: 0, 1: 0}
    for i, r in enumerate(ps.replicas):
        inner = r.edit_decode

        def counted(*a, _i=i, _inner=inner, **k):
            ran[_i] += 1
            return _inner(*a, **k)

        r.edit_decode = counted
    misses = ps.cache_misses
    videos, errs = ps.edit_decode_batch(members, dispatch="vmap")
    assert ran == {0: 1, 1: 1} and ps.cache_misses == misses
    assert videos.device == ps.device
    for i, args in enumerate(members):
        single, err = ps.edit_decode(*args)
        assert torch.equal(videos[i], single) and float(errs[i]) == float(err) == 0.0
    assert not torch.equal(videos[0], videos[1])
    ran.update({0: 0, 1: 0})
    ps.edit_decode_batch(members + members[:1], dispatch="vmap")
    assert ran == {0: 3, 1: 0}
    with pytest.raises(ValueError, match="dispatch must be"):
        ps.edit_decode_batch(members, dispatch="pmap")


def test_a_data_mesh_wider_than_the_devices_raises(monkeypatch):
    from videop2p_tpu_torch.serve import ProgramSet, ProgramSpec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="dp=2 replicas needs 2 devices, this process sees 1"):
        ProgramSet(ProgramSpec(**_kw(2), mesh="2,1,1"), device="cuda")


def test_vmap_matches_jax_vmap_on_the_same_captures():
    """The port's and JAX's ``vmap`` over a data mesh of 2 (CPU replicas /
    two of the 8 host devices) on the same weights and JAX's captures of
    two clips: each video within 1e-5, src_err 0.0 on both sides."""
    import jax

    from videop2p_tpu.serve import ProgramSet as JaxProgramSet
    from videop2p_tpu.serve import ProgramSpec as JaxSpec
    from videop2p_tpu.serve.batching import stack_items as jax_stack

    from tests.test_torch_cached import _port_cached
    from tests.test_torch_parity import np32
    from tests.test_torch_serve_jax import paired_bundles
    from videop2p_tpu_torch.serve import ProgramSet, ProgramSpec

    jax_bundle, port_bundle = paired_bundles()
    jps = JaxProgramSet(JaxSpec(**_kw(2), mesh="2,1,1"), bundle=jax_bundle)
    pps = ProgramSet(ProgramSpec(**_kw(2), mesh="2,1,1"), bundle=port_bundle, device="cpu")
    jargs, pargs = [], []
    for phase, edit in ((0.1, PROMPTS[1]), (0.37, "a lego rabbit is jumping")):
        prompts = [PROMPTS[0], edit]
        jlat = jps.encode(jps.frames_to_video(_clip(phase)), jax.random.key(0))
        jctx = jps.controller(prompts)
        _, jcached = jps.invert_capture(jlat, jps.encode_prompts(prompts[:1]), jctx,
                                        jax.random.key(0))[:2]
        jargs.append((jcached, jps.encode_prompts(prompts), jps.encode_prompts([""])[0], jctx,
                      jlat))
        pargs.append((_port_cached(jcached), pps.encode_prompts(prompts), pps.encode_uncond(),
                      pps.controller(prompts), torch.from_numpy(np.array(jlat))))
    jvid, jerr = jps.edit_decode_batch(jax_stack(jargs, 2), 2, dispatch="vmap")
    pvid, perr = pps.edit_decode_batch(pargs, dispatch="vmap")
    assert np.asarray(jerr).tolist() == [0.0, 0.0] and perr.tolist() == [0.0, 0.0]
    np.testing.assert_allclose(np32(pvid), np.asarray(jvid), atol=JAX_TOL, rtol=0)


# ------------------------------------------------- model-parallel mesh --


def _entry(root: str) -> dict:
    """The one disk entry under ``root``: its files' bytes."""
    (d,) = [dirpath for dirpath, _, files in os.walk(root) if files]
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


def _serve_flow(ps, root: str) -> dict:
    """A fresh request, a store hit (another edit of the clip) and a batch
    of 2 through one engine, then the fresh request again through a second
    engine over the same set and disk root (a rehydrated hit)."""
    from videop2p_tpu_torch.serve import EditEngine

    out = {}
    store = os.path.join(root, "inv_store")
    eng = EditEngine(ps.spec, out_dir=os.path.join(root, "a"), programs=ps, persist_dir=store,
                     keep_videos=True, max_wait_s=0.5, max_batch=2)
    try:
        eng.warm(PROMPTS)
        runs = [("fresh", [_request()]),
                ("hit", [_request(prompts=[PROMPTS[0], "a lego rabbit is jumping"],
                                  save_name="lego")]),
                ("batch", [_request(), _request(save_name="again")])]
        for name, reqs in runs:
            rids = [eng.submit(r) for r in reqs]
            for i, rid in enumerate(rids):
                rec = eng.result(rid, wait_s=120.0)
                out[name if len(rids) == 1 else f"{name}_{i}"] = (
                    {k: rec.get(k) for k in ("status", "error", "store_source", "src_err",
                                             "batch_size")}, eng.videos(rid))
    finally:
        eng.close()
    eng = EditEngine(ps.spec, out_dir=os.path.join(root, "b"), programs=ps, persist_dir=store,
                     keep_videos=True)
    try:
        rid = eng.submit(_request())
        rec = eng.result(rid, wait_s=120.0)
        out["disk"] = ({k: rec.get(k) for k in ("status", "error", "store_source", "src_err",
                                                 "batch_size")}, eng.videos(rid))
    finally:
        eng.close()
    from videop2p_tpu_torch.obs import read_ledger

    phases = [e for e in read_ledger(eng.ledger.path) if e["event"] == "host_phase"]
    out["host_phases"] = sorted({(e["process_index"], e["name"]) for e in phases})
    out["entry"] = _entry(store)
    return out


def _mesh_worker(rank, world, mesh, root):
    """Rank 0 serves ``_serve_flow`` (two engines over one set, each
    leading the mesh until it closes); rank 1 follows each in turn."""
    from videop2p_tpu_torch.serve import ProgramSet, ProgramSpec

    ps = ProgramSet(ProgramSpec(**_kw(), mesh=mesh), device="cpu")
    if rank > 0:
        return [ps.follow(), ps.follow()]
    return _serve_flow(ps, root)


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    from videop2p_tpu_torch.serve import ProgramSet, ProgramSpec

    return _serve_flow(ProgramSet(ProgramSpec(**_kw()), device="cpu"),
                       str(tmp_path_factory.mktemp("one")))


@pytest.mark.parametrize("mesh", ["1,2,1", "1,1,2"])
def test_engine_on_a_mesh_matches_one_process(mesh, one_process, tmp_path):
    """Rank 0's engines over the mesh's set (each leads it), rank 1
    following: each request's videos within 2e-3 of the one-process
    engine's, src_err 0.0, the same store sources and batch; the disk
    entry the mesh wrote is the one-process entry (meta.json byte for
    byte, the trajectory's .npy header byte for byte and its values within
    1e-4); both ranks' ``host_phase`` records of the served programs are
    in rank 0's ledger; each engine's close releases rank 1, which then
    holds exactly the objects rank 0 holds."""
    r0, r1 = run_ranks(_mesh_worker, 2, mesh, str(tmp_path), timeout=240.0)
    for stats in r1:
        assert stats["calls"] > 0 and stats["live"] == stats["leader_live"], stats
    for name in ("fresh", "hit", "batch_0", "batch_1", "disk"):
        (rec, videos), (got, got_videos) = one_process[name], r0[name]
        assert got == rec, (name, got, rec)
        assert rec["status"] == "done" and rec["src_err"] == 0.0
        np.testing.assert_allclose(got_videos, videos, atol=MESH_TOL, rtol=0, err_msg=name)
    assert [r0[n][0]["store_source"] for n in ("fresh", "hit", "batch_0", "disk")] == [
        "fresh", "memory", "memory", "disk"]
    assert r0["batch_0"][0]["batch_size"] == 2
    # every rank's seconds in the served programs reach rank 0's ledger
    assert one_process["host_phases"] == []
    assert {(r, "serve_edit_decode") for r in (0, 1)} <= set(r0["host_phases"])
    assert {r for r, _ in r0["host_phases"]} == {0, 1}
    mine, ref = r0["entry"], one_process["entry"]
    assert sorted(mine) == sorted(ref) == ["meta.json", "trajectory.npy"]
    assert json.loads(mine["meta.json"]) == json.loads(ref["meta.json"])
    assert mine["meta.json"] == ref["meta.json"]
    header = ref["trajectory.npy"].index(b"\n") + 1
    assert mine["trajectory.npy"][:header] == ref["trajectory.npy"][:header]
    np.testing.assert_allclose(np.frombuffer(mine["trajectory.npy"][header:], np.float32),
                               np.frombuffer(ref["trajectory.npy"][header:], np.float32),
                               atol=TRAJ_TOL, rtol=0)


def _failure_worker(rank, world, root):
    """Rank 1's host step fails once (its first ``edit_decode``); later,
    a hang injected on rank 0's third dispatch outlasts the watchdog."""
    from videop2p_tpu_torch.serve import EditEngine, FaultPlan, ProgramSet, ProgramSpec

    ps = ProgramSet(ProgramSpec(**_kw(), mesh="1,2,1"), device="cpu")
    if rank > 0:
        inner, failed = ps._prepare_call, []

        def prepare(objects, desc):
            if desc[0] == "edit_decode" and not failed:
                failed.append(desc[0])
                raise RuntimeError("injected on rank 1")
            return inner(objects, desc)

        ps._prepare_call = prepare
        return ps.follow()
    eng = EditEngine(ps.spec, out_dir=root, programs=ps, dispatch_timeout_s=10.0,
                     faults=FaultPlan.parse("hang@3:15"), keep_videos=True)
    out = {}
    try:
        eng.warm(PROMPTS)
        for name in ("rank1_fails", "serves_on", "abandoned", "after"):
            t0 = time.perf_counter()
            rec = eng.result(eng.submit(_request()), wait_s=120.0)
            out[name] = (rec["status"], rec.get("error", ""), time.perf_counter() - t0)
    finally:
        t0 = time.perf_counter()
        eng.close()
        out["close_s"] = time.perf_counter() - t0
    return out


def test_rank_failures_surface_on_rank_0_and_close_releases_the_follower(tmp_path):
    """A failure in rank 1's host step reaches rank 0 as the request's
    error, naming rank 1, in seconds (well before the 60 s group timeout),
    and the ranks stay in step: the next request is done. A dispatch the
    watchdog abandons breaks the channel: that request is
    ``deadline_exceeded`` and the next fails naming the broken channel.
    ``close()`` (the engine made the leader) then releases rank 1."""
    r0, r1 = run_ranks(_failure_worker, 2, str(tmp_path), timeout=240.0)
    status, error, secs = r0["rank1_fails"]
    assert status == "error" and "rank(s) [1]" in error and "injected on rank 1" in error
    assert secs < 20.0
    assert r0["serves_on"][0] == "done", r0["serves_on"]
    assert r0["abandoned"][0] == "deadline_exceeded", r0["abandoned"]
    assert r0["after"][0] == "error" and "broken" in r0["after"][1], r0["after"]
    assert r1["calls"] > 0 and "live" in r1


def _device_failure_worker(rank, world, root):
    """Rank 1's first ``edit_decode`` raises after its device work (the
    clip gathered over the frames with rank 0): every collective of the
    call matched, the error reaching rank 0 in the call's last exchange."""
    from videop2p_tpu_torch.serve import EditEngine, ProgramSet, ProgramSpec

    ps = ProgramSet(ProgramSpec(**_kw(), mesh="1,2,1"), device="cpu")
    if rank > 0:
        inner, failed = ps._prepare_call, []

        def prepare(objects, desc):
            work = inner(objects, desc)
            if desc[0] != "edit_decode" or failed:
                return work

            def fail_after():
                work()
                failed.append(desc[0])
                raise RuntimeError("injected after rank 1's device work")

            return fail_after

        ps._prepare_call = prepare
        return ps.follow()
    eng = EditEngine(ps.spec, out_dir=root, programs=ps, keep_videos=True)
    out = {}
    try:
        eng.warm(PROMPTS)
        for name in ("run_fails", "after"):
            t0 = time.perf_counter()
            rec = eng.result(eng.submit(_request(save_name=name)), wait_s=120.0)
            out[name] = (rec["status"], rec.get("error", ""), time.perf_counter() - t0)
    finally:
        eng.close()
    return out


def test_a_failure_in_a_ranks_device_work_breaks_the_channel(tmp_path):
    """A failure in rank 1's device work reaches rank 0 as the request's
    error (naming rank 1 and the run step) and breaks the channel: on NCCL
    such a rank may have left the others' collectives unmatched. The next
    request fails at once naming the broken channel (no call reaches the
    ranks), and the engine's ``close()`` still releases rank 1."""
    r0, r1 = run_ranks(_device_failure_worker, 2, str(tmp_path), timeout=240.0)
    status, error, _ = r0["run_fails"]
    assert status == "error" and "failed in run on rank(s) [1]" in error, error
    assert "injected after rank 1's device work" in error
    status, error, secs = r0["after"]
    assert status == "error" and "broken" in error and "restart the mesh" in error, error
    assert secs < 5.0
    assert r1["calls"] > 0 and "live" in r1
