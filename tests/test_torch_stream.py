"""The port's streaming tier on the CPU (the counterparts of
``tests/test_stream.py``), at the JAX serving tests' tiny spec
(``tiny=True, width=16, video_len=2, steps=2``): the window plan and the
crossfade, the atomic resumable job manifest (a torn file recovered from the
sidecars, a bad sidecar, the ``corrupt:manifest`` directive), and the
driver — a full-skip resume, a lost sidecar rehydrated from the disk store
with no program-cache miss, a ``fail@`` retried, poisoned windows degraded
to passthrough, checkpoint-then-exit, validation, memory flat per window —
and SIGKILL then resume through ``cli/stream.py --device cpu``, bit for bit.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tests.test_torch_parity import TEST_THREADS  # noqa: F401 — one thread a process
from videop2p_tpu_torch.stream.manifest import JobManifest
from videop2p_tpu_torch.stream.windows import (
    Window,
    assemble_video,
    blend_weights,
    plan_windows,
    seam_spans,
    synthetic_clip,
    window_key,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------- windows ---


def test_plan_windows_geometry_and_validation():
    plan = plan_windows(14, 4, 1)
    assert [(w.start, w.stop) for w in plan] == \
        [(0, 4), (3, 7), (6, 10), (9, 13), (10, 14)]
    assert [w.index for w in plan] == [0, 1, 2, 3, 4]
    assert all(w.frames == 4 for w in plan)
    assert len(plan_windows(128, 8, 2)) == 21
    assert len(plan_windows(480, 8, 2)) == 80
    assert [(w.start, w.stop) for w in plan_windows(20, 8, 2)] == [(0, 8), (6, 14), (12, 20)]
    assert plan_windows(8, 8, 2) == [Window(0, 0, 8)]
    with pytest.raises(ValueError, match="shorter than one window"):
        plan_windows(6, 8, 2)
    with pytest.raises(ValueError, match="overlap"):
        plan_windows(16, 4, 4)
    with pytest.raises(ValueError, match="window"):
        plan_windows(16, 1, 0)


def test_blend_weights_and_assembly_crossfade():
    w = blend_weights(3)
    assert np.allclose(w, [0.25, 0.5, 0.75])
    assert blend_weights(0).shape == (0,)
    plan = plan_windows(6, 4, 2)  # [0,4) + [2,6), overlap [2,4)
    a = np.zeros((4, 2, 2, 3), np.float32)
    b = np.ones((4, 2, 2, 3), np.float32)
    out = assemble_video(plan, {0: a, 1: b}, 6)
    assert np.all(out[:2] == 0.0) and np.all(out[4:] == 1.0)
    assert np.allclose(out[2], 1.0 / 3.0) and np.allclose(out[3], 2.0 / 3.0)
    with pytest.raises(ValueError, match="missing window outputs"):
        assemble_video(plan, {0: a}, 6)
    assert seam_spans(plan) == [{"left": 0, "right": 1, "start": 2, "stop": 4}]


def test_synthetic_clip_deterministic_across_calls():
    a = synthetic_clip(10, 8, seed=3)
    assert a.shape == (10, 8, 8, 3) and a.dtype == np.uint8
    assert np.array_equal(a, synthetic_clip(10, 8, seed=3))
    assert not np.array_equal(a, synthetic_clip(10, 8, seed=4))


def test_window_key_content_addressed():
    frames = synthetic_clip(4, 8, seed=0)
    k = window_key("specfp", frames, ["a", "b"], seed=0)
    assert k == window_key("specfp", frames.copy(), ["a", "b"], seed=0)
    assert k != window_key("specfp2", frames, ["a", "b"], seed=0)
    assert k != window_key("specfp", frames[::-1], ["a", "b"], seed=0)
    assert k != window_key("specfp", frames, ["a", "c"], seed=0)
    assert k != window_key("specfp", frames, ["a", "b"], seed=1)
    assert k != window_key("specfp", frames, ["a", "b"], seed=0,
                           extra={"blend_word": ["a", "b"]})


# ------------------------------------------------------------ manifest ---


def _identity(**over):
    base = {"spec_fingerprint": "fp", "clip_sha": "c", "prompts": ["a", "b"],
            "seed": 0, "request": {}, "total_frames": 6, "window": 4, "overlap": 2}
    base.update(over)
    return base


def test_manifest_roundtrip_atomic_and_identity_guard(tmp_path):
    m = JobManifest(str(tmp_path / "job"), _identity())
    frames = np.random.RandomState(0).rand(4, 2, 2, 3).astype(np.float32)
    m.complete_window(0, "k0", frames, status="done", src_err=0.0, store_source="fresh")
    m2 = JobManifest(str(tmp_path / "job"), _identity())
    assert m2.load() and list(m2.entries) == [0]
    out = m2.valid_output(0)
    assert out is not None and np.array_equal(out, frames)
    assert [f for f in os.listdir(str(tmp_path / "job")) if ".tmp" in f] == []
    # another identity never resumes into this job
    m3 = JobManifest(str(tmp_path / "job"), _identity(seed=1))
    assert not m3.load()
    assert m3.corrupt_detected == 1 and m3.entries == {}
    with pytest.raises(ValueError, match="terminal"):
        m.complete_window(1, "k1", frames, status="pending")


def test_manifest_torn_file_recovers_from_sidecars(tmp_path):
    job = str(tmp_path / "job")
    m = JobManifest(job, _identity())
    frames = np.random.RandomState(1).rand(4, 2, 2, 3).astype(np.float32)
    m.complete_window(0, "k0", frames, status="done", src_err=0.0)
    m.complete_window(1, "k1", frames + 1, status="passthrough", attempts=3)
    with open(m.path) as f:
        doc = f.read()
    with open(m.path, "w") as f:
        f.write(doc[: len(doc) // 2])
    m2 = JobManifest(job, _identity())
    assert m2.load()
    assert m2.corrupt_detected == 1 and m2.recovered_entries == 2
    assert m2.entries[0]["status"] == "done"
    assert m2.entries[1]["status"] == "passthrough"
    assert np.array_equal(m2.valid_output(0), frames)
    m3 = JobManifest(job, _identity())
    assert m3.load() and m3.corrupt_detected == 0


def test_manifest_bad_sidecar_forces_recompute(tmp_path):
    job = str(tmp_path / "job")
    m = JobManifest(job, _identity())
    frames = np.random.RandomState(2).rand(4, 2, 2, 3).astype(np.float32)
    entry = m.complete_window(0, "k0", frames, status="done")
    with open(os.path.join(job, entry["output"]), "r+b") as f:
        f.seek(200)
        f.write(b"\xff" * 32)
    m2 = JobManifest(job, _identity())
    assert m2.load()
    assert m2.valid_output(0) is None and 0 not in m2.entries
    entry = m.complete_window(1, "k1", frames, status="done")
    os.remove(os.path.join(job, entry["output"]))
    m3 = JobManifest(job, _identity())
    m3.load()
    assert m3.valid_output(1) is None


def test_manifest_corrupt_directive_tears_every_save(tmp_path):
    from videop2p_tpu_torch.serve.faults import FaultPlan

    plan = FaultPlan.parse("corrupt:manifest")
    m = JobManifest(str(tmp_path / "job"), _identity(), faults=plan)
    m.complete_window(0, "k0", np.zeros((4, 2, 2, 3), np.float32), status="done")
    with pytest.raises(ValueError):
        with open(m.path) as f:
            json.load(f)
    assert any(i["kind"] == "store_corrupt" for i in plan.injected)
    m2 = JobManifest(str(tmp_path / "job"), _identity())
    assert m2.load()
    assert m2.corrupt_detected == 1 and m2.recovered_entries == 1


# ----------------------------------------------------- streaming driver --

SPEC_KW = dict(tiny=True, width=16, video_len=2, steps=2)
PROMPTS = ["a rabbit is jumping", "a origami rabbit is jumping"]


def _make_engine(root, name, programs=None, **over):
    from videop2p_tpu_torch.serve import EditEngine, ProgramSpec

    kw = dict(out_dir=os.path.join(str(root), f"{name}_out"),
              persist_dir=os.path.join(str(root), "inv_store"),
              ledger_path=os.path.join(str(root), f"{name}_ledger.jsonl"),
              keep_videos=True, max_batch=2, max_wait_s=0.05, programs=programs,
              device="cpu")
    kw.update(over)
    eng = EditEngine(ProgramSpec(**SPEC_KW), **kw)
    if programs is None:
        eng.warm(tuple(PROMPTS))
    return eng


@pytest.fixture(scope="module")
def stream_root(tmp_path_factory):
    return tmp_path_factory.mktemp("stream")


@pytest.fixture(scope="module")
def engine(stream_root):
    eng = _make_engine(stream_root, "main")
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def clip():
    return synthetic_clip(5, 16, seed=1)  # 4 windows at window=2, overlap=1


def test_stream_job_end_to_end_ledger_and_full_skip_resume(engine, clip, stream_root):
    """A 4-window job completes with every window edited (src_err == 0.0),
    per-window / per-seam / job-level events land in the ledger, memory is
    flat (every harvested window popped off the engine), and a rerun over
    the same job dir SKIPS every window — no request, no inversion, the same
    final frames bit for bit."""
    from videop2p_tpu_torch.obs import read_ledger
    from videop2p_tpu_torch.stream import STREAM_HEALTH_FIELDS, run_stream_job

    job = str(stream_root / "job_e2e")
    res = run_stream_job(engine, clip, PROMPTS, job_dir=job, overlap=1, max_inflight=2)
    h = res.health
    assert set(h) == set(STREAM_HEALTH_FIELDS)
    assert res.complete and res.video.shape == (5, 16, 16, 3)
    assert h["windows_total"] == 4 and h["windows_done"] == 4
    assert h["windows_passthrough"] == 0 and h["windows_failed"] == 0
    assert h["src_err_max"] == 0.0 and h["fresh_inversions"] == 4
    assert h["seams"] == 3 and np.isfinite(h["seam_min_psnr"])
    assert os.path.isfile(os.path.join(job, "final.npy"))
    assert os.path.isfile(os.path.join(job, "stream.gif"))
    assert engine._videos == {}  # each window's videos left the engine
    events = read_ledger(engine.ledger.path)
    by_kind = {}
    for e in events:
        by_kind.setdefault(e.get("event"), []).append(e)
    assert len(by_kind["stream_window"]) >= 4
    assert len(by_kind["stream_seam"]) >= 3
    assert by_kind["stream_health"][-1]["windows_done"] == 4

    before = len(engine._requests)
    res2 = run_stream_job(engine, clip, PROMPTS, job_dir=job, overlap=1)
    assert res2.health["windows_skipped"] == 4 and res2.health["windows_done"] == 0
    assert res2.health["fresh_inversions"] == 0
    assert len(engine._requests) == before
    assert np.array_equal(res.video, res2.video)


def test_stream_resume_missing_sidecar_rehydrates_no_program_miss(engine, clip, stream_root):
    """Lose one window's sidecar and resume on a FRESH engine sharing the
    disk store (and the warm programs): the window recomputes from the
    persisted trajectory (``store_source == "disk"``) with no inversion from
    frames, no program-cache miss, and the same final video bit for bit."""
    from videop2p_tpu_torch.stream import run_stream_job

    job = str(stream_root / "job_rehydrate")
    res = run_stream_job(engine, clip, PROMPTS, job_dir=job, overlap=1)
    assert res.complete
    os.remove(os.path.join(job, "windows", "w0001.npz"))
    eng2 = _make_engine(stream_root, "rehydrate", programs=engine.programs)
    try:
        misses = eng2.programs.cache_misses
        compiles = len(eng2.ledger.compile_seconds)
        res2 = run_stream_job(eng2, clip, PROMPTS, job_dir=job, overlap=1)
        h = res2.health
        assert h["windows_skipped"] == 3 and h["windows_done"] == 1
        assert h["store_disk_hits"] == 1 and h["fresh_inversions"] == 0
        assert h["src_err_max"] == 0.0
        assert eng2.programs.cache_misses == misses
        assert len(eng2.ledger.compile_seconds) == compiles
        assert np.array_equal(res.video, res2.video)
    finally:
        eng2.close()


def test_stream_chaos_fail2_engine_retry_completes(engine, clip, stream_root):
    """``fail@2`` injects a transient dispatch failure under window 2: the
    engine's RetryPolicy absorbs it and every window is edited."""
    from videop2p_tpu_torch.serve.faults import FaultPlan
    from videop2p_tpu_torch.stream import run_stream_job

    plan = FaultPlan.parse("fail@2")
    eng = _make_engine(stream_root, "fail2", programs=engine.programs, faults=plan,
                       max_retries=2)
    try:
        res = run_stream_job(eng, clip, PROMPTS, job_dir=str(stream_root / "job_fail2"),
                             overlap=1, max_inflight=1)
        h = res.health
        assert res.complete and h["windows_done"] == 4
        assert h["windows_passthrough"] == 0 and h["src_err_max"] == 0.0
        assert eng.counters["retries"] >= 1
        assert [i["kind"] for i in plan.injected] == ["dispatch_fail"]
    finally:
        eng.close()


def test_stream_poisoned_windows_degrade_to_passthrough(engine, clip, stream_root):
    """A window that keeps failing degrades to a RECORDED passthrough (its
    source frames); ``degrade=False`` makes the same poisoning fatal."""
    from videop2p_tpu_torch.serve.faults import FaultPlan
    from videop2p_tpu_torch.stream import run_stream_job

    eng = _make_engine(stream_root, "poison", programs=engine.programs,
                       faults=FaultPlan.parse("unavail@3-999"), max_retries=0,
                       breaker_threshold=1000)
    try:
        res = run_stream_job(eng, clip, PROMPTS, job_dir=str(stream_root / "job_poison"),
                             overlap=1, max_inflight=1, window_retries=1)
        h = res.health
        assert res.complete
        assert h["windows_done"] == 2 and h["windows_passthrough"] == 2
        assert h["windows_failed"] == 2 and h["retries"] >= 2
        entries = res.manifest.entries
        assert sorted(e["status"] for e in entries.values()) == \
            ["done", "done", "passthrough", "passthrough"]
        pt = [i for i, e in entries.items() if e["status"] == "passthrough"]
        w = [win for win in plan_windows(5, 2, 1) if win.index == pt[0]][0]
        assert np.array_equal(res.manifest.valid_output(pt[0]),
                              clip[w.start:w.stop].astype(np.float32) / 255.0)
        with pytest.raises(RuntimeError, match="poisoned"):
            run_stream_job(eng, clip, PROMPTS, job_dir=str(stream_root / "job_poison_fatal"),
                           overlap=1, max_inflight=1, window_retries=0, degrade=False)
    finally:
        eng.close()


def test_stream_manifest_corrupt_chaos_resume_recovers(engine, clip, stream_root):
    """``corrupt:manifest`` tears EVERY manifest write; the next run detects
    it, rebuilds the entries from the sidecars, skips every window and gives
    the same output bit for bit."""
    from videop2p_tpu_torch.serve.faults import FaultPlan
    from videop2p_tpu_torch.stream import run_stream_job

    job = str(stream_root / "job_corrupt")
    res = run_stream_job(engine, clip, PROMPTS, job_dir=job, overlap=1,
                         faults=FaultPlan.parse("corrupt:manifest"))
    assert res.complete
    with pytest.raises(ValueError):
        with open(os.path.join(job, "manifest.json")) as f:
            json.load(f)
    res2 = run_stream_job(engine, clip, PROMPTS, job_dir=job, overlap=1)
    h = res2.health
    assert h["manifest_corrupt"] == 1 and h["manifest_recovered"] == 4
    assert h["windows_skipped"] == 4 and h["fresh_inversions"] == 0
    assert np.array_equal(res.video, res2.video)


def test_stream_checkpoint_then_exit_and_resume(engine, clip, stream_root):
    """A stop event raised once the first window is harvested stops new
    submissions: the job returns ``interrupted`` with that window persisted,
    and the rerun skips it (no request for it) and gives the uninterrupted
    run's frames bit for bit."""
    from videop2p_tpu_torch.stream import run_stream_job

    ref = run_stream_job(engine, clip, PROMPTS, job_dir=str(stream_root / "job_ref"), overlap=1,
                         max_inflight=1)
    job = str(stream_root / "job_interrupt")
    stop = threading.Event()
    take = engine.take_videos

    def take_then_stop(rid):
        stop.set()
        return take(rid)

    engine.take_videos = take_then_stop
    try:
        res = run_stream_job(engine, clip, PROMPTS, job_dir=job, overlap=1, max_inflight=1,
                             stop_event=stop)
    finally:
        del engine.take_videos
    assert res.health["interrupted"] == 1 and res.video is None
    assert res.health["windows_done"] == 1
    before = len(engine._requests)
    res2 = run_stream_job(engine, clip, PROMPTS, job_dir=job, overlap=1)
    assert res2.complete and res2.health["windows_skipped"] == 1
    assert len(engine._requests) == before + 3
    assert np.array_equal(res2.video, ref.video)


def test_stream_driver_validation(engine, clip, stream_root):
    from videop2p_tpu_torch.stream import run_stream_job

    no_keep = type("E", (), {"keep_videos": False})()
    with pytest.raises(ValueError, match="keep_videos"):
        run_stream_job(no_keep, clip, PROMPTS, job_dir=str(stream_root / "nokeep"))
    with pytest.raises(ValueError, match="frames must be"):
        run_stream_job(engine, clip[..., 0], PROMPTS, job_dir=str(stream_root / "badshape"))


def test_stream_cli_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """Every flag is ported. The multi-GPU flags (item 13): a
    model-parallel ``--mesh`` in a plain process raises naming torchrun,
    the ring and tensor knobs reach the engine's spec; ``--incidents``
    (item 14's rest) reaches the engine as its option."""
    from videop2p_tpu_torch.cli.stream import main

    for argv, item in ((["--mesh", "1,2,1"], "item 13"), (["--ring_variant", "bidir"], "item 13"),
                       (["--tp_collectives", "psum_scatter"], "item 13"),
                       (["--incidents", "dir"], "item 14")):
        cmd = ["--device", "cpu", "--tiny", "--synthetic", "5", "--video_len", "2",
               "--job_dir", str(tmp_path / "job"), *argv]
        if argv[0] == "--mesh":
            with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
                main(cmd)
            continue
        import videop2p_tpu_torch.serve as serve

        seen = {}

        def engine(spec, **kw):
            seen.update(kw, spec=spec)
            raise KeyboardInterrupt  # stop before warming

        with monkeypatch.context() as m:
            m.setattr(serve, "EditEngine", engine)
            with pytest.raises(KeyboardInterrupt):
                main(cmd)
        assert seen["device"] == "cpu" and seen["programs"] is None
        assert seen["incidents"] == ("dir" if item == "item 14" else None)
        assert seen["spec"].ring_variant == (argv[1] if argv[0] == "--ring_variant"
                                             else "overlap")
        assert seen["spec"].tp_collectives == (argv[1] if argv[0] == "--tp_collectives"
                                               else "gspmd")


# ------------------------------------------------ kill-and-resume e2e ----


def _stream_cmd(job_dir, *extra):
    return [sys.executable, "-m", "videop2p_tpu_torch.cli.stream", "--device", "cpu", "--tiny",
            "--synthetic", "7", "--video_len", "2", "--overlap", "1", "--steps", "2",
            "--max_inflight", "1", "--job_dir", job_dir, *extra]


def test_stream_cli_sigkill_resume_bit_identical(tmp_path):
    """SIGKILL ``cli/stream.py`` while its third window's dispatch is held by
    an injected hang (two windows persisted); the rerun skips every persisted
    window and its ``final.npy`` equals an uninterrupted run's bit for bit."""
    kill_job = str(tmp_path / "kill_job")
    proc = subprocess.Popen(_stream_cmd(kill_job, "--faults", "hang@3:30"), cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    manifest = os.path.join(kill_job, "manifest.json")
    deadline = time.perf_counter() + 120.0
    killed = False
    try:
        while time.perf_counter() < deadline and proc.poll() is None:
            try:
                with open(manifest) as f:
                    done = sum(w["status"] == "done" for w in json.load(f)["windows"])
            except (OSError, ValueError):
                done = 0
            if done >= 2:
                proc.send_signal(signal.SIGKILL)
                killed = True
                break
            time.sleep(0.05)
    finally:
        if proc.poll() is None and not killed:
            proc.kill()
        proc.wait(timeout=60)
    assert killed, proc.stdout.read()
    with open(manifest) as f:
        persisted = sum(w["status"] == "done" for w in json.load(f)["windows"])
    assert persisted == 2
    assert not os.path.exists(os.path.join(kill_job, "final.npy"))

    out = subprocess.run(_stream_cmd(kill_job), cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    health = next(json.loads(line)["stream_health"] for line in out.stdout.splitlines()
                  if line.startswith('{"stream_health"'))
    assert health["windows_skipped"] == 2 and health["windows_done"] == 4
    # the window in flight at the kill had written its trajectory through:
    # a disk hit, not a second inversion
    assert health["fresh_inversions"] + health["store_disk_hits"] == 4
    assert health["src_err_max"] == 0.0

    ref_job = str(tmp_path / "ref_job")
    out = subprocess.run(_stream_cmd(ref_job), cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert np.array_equal(np.load(os.path.join(kill_job, "final.npy")),
                          np.load(os.path.join(ref_job, "final.npy")))
