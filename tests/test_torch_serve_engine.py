"""The port's serving engine and its HTTP API on the CPU, at the JAX
serving tests' tiny spec (``tiny=True, width=16, video_len=2, steps=2``):
the store hit of a repeat request (same ``content_sha256``, no program-cache
miss), concurrent compatible requests batched (bit-identical to their
singletons), admission of steps / reuse / quant / student, a bad request,
the cost vector's conservation, the HTTP round trip, 429 on a full queue,
503 with ``Retry-After`` while the breaker is open, an injected hang bounded
by the watchdog, rehydration from disk after a restart and a corrupted entry
detected, a failed artifact write, the options that are not ported, and
the spec-keyed cache of program sets.
"""

import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tests.test_torch_parity import TEST_THREADS  # noqa: F401 — one thread a process

KW = dict(tiny=True, width=16, video_len=2, steps=2)
PROMPTS = ("a rabbit is jumping", "a origami rabbit is jumping")


def _request(**overrides):
    from videop2p_tpu_torch.serve import EditRequest

    kw = dict(image_path="data/rabbit", prompt=PROMPTS[0], prompts=list(PROMPTS),
              save_name="origami")
    kw.update(overrides)
    return EditRequest(**kw)


@pytest.fixture(scope="module")
def programs():
    from videop2p_tpu_torch.serve import ProgramSet, ProgramSpec

    return ProgramSet(ProgramSpec(**KW), device="cpu")


@pytest.fixture(scope="module")
def engine(programs, tmp_path_factory):
    from videop2p_tpu_torch.serve import EditEngine, ProgramSpec

    root = tmp_path_factory.mktemp("serve")
    eng = EditEngine(ProgramSpec(**KW), out_dir=str(root / "out"), store_budget_bytes=64 << 20,
                     persist_dir=str(root / "inv_store"), max_batch=4, max_wait_s=0.3,
                     keep_videos=True, programs=programs)
    eng.warm(PROMPTS, step_buckets=(1,), reuse_schedules=("uniform:2",))
    yield eng
    eng.close()


def _engine(programs, root, **kw):
    from videop2p_tpu_torch.serve import EditEngine, ProgramSpec

    return EditEngine(ProgramSpec(**KW), out_dir=str(root), programs=programs,
                      keep_videos=True, **kw)


def test_second_identical_request_hits_the_store(engine):
    from videop2p_tpu_torch.serve import load_persisted_inversion

    rec1 = engine.result(engine.submit(_request()), wait_s=120.0)
    assert rec1["status"] == "done", rec1.get("error")
    assert rec1["store_hit"] is False and rec1["src_err"] == 0.0
    assert os.path.isfile(rec1["edit_gif"]) and os.path.isfile(rec1["inversion_gif"])
    misses = engine.programs.cache_misses
    rec2 = engine.result(engine.submit(_request()), wait_s=120.0)
    assert rec2["status"] == "done" and rec2["store_hit"] is True
    assert rec2["compile_events"] == 0 and rec2["program_cache_misses"] == 0
    assert engine.programs.cache_misses == misses
    assert rec2["src_err"] == 0.0
    assert np.array_equal(engine.videos(rec1["id"]), engine.videos(rec2["id"]))
    assert rec1["content_sha256"] == rec2["content_sha256"] and len(rec1["content_sha256"]) == 64
    traj, _ = load_persisted_inversion(engine.store.persist_dir, rec2["store_key"])
    assert traj.ndim == 6 and traj.shape[0] == engine.spec.steps + 1


def test_concurrent_compatible_requests_batch(engine):
    """Three compatible requests in one admit window: one scan dispatch of
    the 3, never padded, no program built for it, each video its
    singleton's bit for bit."""
    misses = engine.programs.cache_misses
    reqs = [_request(), _request(seed=7),
            _request(image_path="data/car", prompt="a car is moving",
                     prompts=["a car is moving", "a toy car is moving"])]
    recs = [engine.result(r, wait_s=120.0) for r in [engine.submit(q) for q in reqs]]
    for rec in recs:
        assert rec["status"] == "done", rec.get("error")
        assert rec["src_err"] == 0.0
        assert (rec["batch_size"], rec["padded_size"]) == (3, 3)
        assert rec["batch_occupancy"] == {"real": 3, "padded": 3}
        assert rec["cost"]["padding_share"] == 0.0
    assert engine.programs.cache_misses == misses
    singles = [engine.result(engine.submit(q), wait_s=120.0) for q in reqs]
    for rec, single in zip(recs, singles):
        assert single["batch_size"] == 1
        assert np.array_equal(engine.videos(rec["id"]), engine.videos(single["id"]))
        assert rec["content_sha256"] == single["content_sha256"]


def test_scan_batch_is_bit_identical_to_singletons(programs):
    """``edit_decode_batch`` over two members (different clips and edits)
    against ``edit_decode`` of each: ``torch.equal``."""
    from videop2p_tpu_torch.serve.batching import stack_items

    ps = programs
    members = []
    for phase, edit in ((0.1, "a origami rabbit is jumping"), (0.37, "a lego rabbit is jumping")):
        grid = np.arange(2 * 16 * 16 * 3, dtype=np.float64).reshape(2, 16, 16, 3)
        frames = (np.abs(np.sin(grid * phase)) * 255).astype(np.uint8)
        prompts = [PROMPTS[0], edit]
        ctx = ps.controller(prompts)
        latents = ps.encode(ps.frames_to_video(frames))
        _, cached = ps.invert_capture(latents, ps.encode_prompts(prompts[:1]), ctx)
        members.append((cached, ps.encode_prompts(prompts), ps.encode_prompts([""])[0], ctx,
                        latents))
    videos, errs = ps.edit_decode_batch(stack_items(members))
    for i, args in enumerate(members):
        single, err = ps.edit_decode(*args)
        assert torch.equal(videos[i], single) and float(err) == float(errs[i]) == 0.0
    assert not torch.equal(videos[0], videos[1])
    # "vmap" without a data mesh runs every member on this set: the scan
    vmapped, vmap_errs = ps.edit_decode_batch(stack_items(members), dispatch="vmap")
    assert torch.equal(vmapped, videos) and torch.equal(vmap_errs, errs)


def test_blend_structure_gets_its_own_compat_key(programs):
    from videop2p_tpu_torch.serve.batching import compat_key

    ps = programs
    plain = ps.controller(list(PROMPTS))
    blend = ps.controller(list(PROMPTS), blend_word=["rabbit", "rabbit"])
    other_words = ps.controller(["a rabbit is jumping", "a lego rabbit is jumping"])
    assert compat_key((plain,)) != compat_key((blend,))
    assert compat_key((plain,)) == compat_key((other_words,))


def test_admission_of_steps_reuse_quant_and_student(engine):
    from videop2p_tpu_torch.serve import EditRequest

    with pytest.raises(ValueError, match=r"warmed: \[1, 2\]"):
        engine.submit(_request(steps=3))
    with pytest.raises(ValueError, match="positive int"):
        EditRequest(image_path="x", prompt="a", prompts=["a", "b"], steps=0).validate()
    with pytest.raises(ValueError, match="not a warmed schedule"):
        engine.submit(_request(reuse_schedule="uniform:3"))
    with pytest.raises(ValueError, match="uniform"):
        engine.submit(_request(reuse_schedule="uniform:x"))
    with pytest.raises(ValueError, match="quantized"):
        engine.submit(_request(quant_mode="w8"))
    with pytest.raises(ValueError, match="no student"):
        engine.submit(_request(student=True))
    assert engine.programs.warmed["steps"] == [1, 2]
    assert engine.programs.warmed["reuse"] == ["off", "uniform:2"]
    for extra in ({"steps": 1}, {"reuse_schedule": "uniform:2"}, {"quant_mode": "off"}):
        rec = engine.result(engine.submit(_request(**extra)), wait_s=120.0)
        assert rec["status"] == "done" and rec["src_err"] == 0.0, (extra, rec.get("error"))
        assert rec["program_cache_misses"] == 0


def test_bad_request_fails_cleanly(engine):
    rec = engine.result(engine.submit(_request(image_path="data/does_not_exist")),
                        wait_s=60.0)
    assert rec["status"] == "error" and "resolve failed" in rec["error"]
    assert engine.result(engine.submit(_request()), wait_s=120.0)["status"] == "done"


def test_cost_vector_conservation(engine):
    from videop2p_tpu_torch.obs.cost import (
        CAPACITY_FIELDS,
        COST_ATTRIBUTION_FIELDS,
        REQUEST_COST_FIELDS,
    )

    tiger = dict(image_path="data/tiger", prompt="a tiger is resting",
                 prompts=["a tiger is resting", "a origami tiger is resting"],
                 tenant="chargeback")
    cold = engine.result(engine.submit(_request(**tiger)), wait_s=120.0)
    hit = engine.result(engine.submit(_request(**tiger)), wait_s=120.0)
    assert cold["store_hit"] is False and hit["store_hit"] is True
    for rec in (cold, hit):
        assert set(rec["cost"]) == set(REQUEST_COST_FIELDS)
        assert rec["cost"]["device_seconds"] > 0.0
    assert cold["cost"]["saved_device_seconds"] == 0.0
    assert hit["cost"]["saved_device_seconds"] > 0.0
    assert hit["cost"]["device_seconds"] < cold["cost"]["device_seconds"]
    cap = engine.metrics()["capacity"]
    assert set(cap) == set(CAPACITY_FIELDS)
    assert cap["busy_seconds"] == pytest.approx(cap["attributed_seconds"]
                                                + cap["padding_seconds"], abs=1e-5)
    assert abs(cap["conservation_residual_s"]) < 1e-5 and cap["idle_seconds"] >= 0.0
    rows = engine.cost_records()
    tenants = [r for r in rows if r["scope"] == "tenant"]
    assert all(set(r) == set(COST_ATTRIBUTION_FIELDS) for r in tenants)
    assert "chargeback" in {r["name"] for r in tenants}
    assert sum(r["device_seconds"] for r in tenants) == pytest.approx(
        cap["attributed_seconds"], abs=0.01)
    assert "serve_invert" in {r["name"] for r in rows if r["scope"] == "program"}


def test_http_roundtrip_healthz_and_metrics(engine):
    from videop2p_tpu_torch.obs.prom import parse_prometheus
    from videop2p_tpu_torch.serve.client import EngineClient
    from videop2p_tpu_torch.serve.http import EditServer

    server = EditServer(engine).start()
    try:
        client = EngineClient(server.url)
        health = client.healthz()
        assert health["ok"] and health["status"] == "ok" and health["warm"]["src_err"] == 0.0
        rec = client.wait(client.submit(_request().to_dict()), timeout_s=120.0)
        assert rec["status"] == "done" and rec["store_hit"] is True
        assert rec["compile_events"] == 0 and rec["src_err"] == 0.0
        assert client.result(rec["id"], wait_s=5.0)["id"] == rec["id"]
        metrics = client.metrics()
        assert metrics["request_latency"]["blocked_p99_s"] > 0.0
        assert {"serve_edit", "serve_resolve", "serve_dispatch"} <= set(metrics["programs"])
        text = client.metrics_prometheus()
        names = {s["name"] for s in parse_prometheus(text)["samples"]}
        assert {"videop2p_capacity_busy_seconds", "videop2p_requests_total",
                "videop2p_store_hits"} <= names
        with pytest.raises(RuntimeError, match="404"):
            client.poll("feedfacefeed")
        with pytest.raises(RuntimeError, match="400"):
            client.submit({"prompt": "a", "bogus": True})
        for bad in ({"steps": 37}, {"reuse_schedule": "uniform:5"}, {"quant_mode": "w8"},
                    {"student": True}):
            with pytest.raises(RuntimeError, match="400"):
                client.submit({**_request().to_dict(), **bad})
    finally:
        server.close()
    with pytest.raises(OSError):
        EngineClient(server.url, timeout_s=2.0).healthz()


def test_full_queue_sheds_with_429(programs, tmp_path):
    from videop2p_tpu_torch.serve import FaultPlan, QueueFull
    from videop2p_tpu_torch.serve.http import EditServer

    eng = _engine(programs, tmp_path, max_queue=1, faults=FaultPlan.parse("hang@1:1.0"))
    server = EditServer(eng).start()
    try:
        rid = eng.submit(_request())
        with pytest.raises(QueueFull):
            eng.submit(_request())
        body = json_post(server.url + "/v1/edits", _request().to_dict())
        assert body[0] == 429 and body[1]["queue_depth"] == 1 and body[2] == "1"
        assert eng.result(rid, wait_s=120.0)["status"] == "done"
        assert eng.health_record()["shed"] == 2
    finally:
        server.close()
        eng.close()


def json_post(url, payload):
    """(status, JSON body, Retry-After header) of one POST."""
    import json

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read()), resp.headers.get("Retry-After")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers.get("Retry-After")


def test_open_breaker_fast_fails_503_then_recovers(programs, tmp_path):
    from videop2p_tpu_torch.serve import EngineUnavailable, FaultPlan
    from videop2p_tpu_torch.serve.http import EditServer

    eng = _engine(programs, tmp_path, faults=FaultPlan.parse("unavail@1-1"), max_retries=0,
                  breaker_threshold=1, breaker_open_s=0.6)
    server = EditServer(eng).start()
    try:
        rec = eng.result(eng.submit(_request()), wait_s=120.0)
        assert rec["status"] == "error" and "injected" in rec["error"]
        assert eng.breaker.state == "open"
        with pytest.raises(EngineUnavailable):
            eng.submit(_request())
        status, body, retry_after = json_post(server.url + "/v1/edits", _request().to_dict())
        assert status == 503 and int(retry_after) >= 1 and body["retry_after_s"] > 0
        from videop2p_tpu_torch.serve.client import EngineClient

        assert EngineClient(server.url).healthz()["status"] == "degraded"
        time.sleep(0.7)  # the open window lapses: the next dispatch is the probe
        rec = eng.result(eng.submit(_request()), wait_s=120.0)
        assert rec["status"] == "done" and eng.breaker.state == "closed"
        assert eng.health_record()["breaker_trips"] == 1
    finally:
        server.close()
        eng.close()


def test_injected_hang_is_bounded_by_the_watchdog(programs, tmp_path):
    from videop2p_tpu_torch.serve import FaultPlan

    eng = _engine(programs, tmp_path, faults=FaultPlan.parse("hang@1:3.0"),
                  dispatch_timeout_s=0.5)
    try:
        t0 = time.perf_counter()
        rec = eng.result(eng.submit(_request()), wait_s=60.0)
        assert rec["status"] == "deadline_exceeded" and "watchdog" in rec["error"]
        assert time.perf_counter() - t0 < 3.0
        rec = eng.result(eng.submit(_request()), wait_s=120.0)
        assert rec["status"] == "done"  # the worker kept serving
        kinds = [e["kind"] for e in eng.fault_log if e["event"] == "fault"]
        assert "hang" in kinds and "watchdog_timeout" in kinds
    finally:
        eng.close()


def test_transient_fault_is_retried(programs, tmp_path):
    from videop2p_tpu_torch.serve import FaultPlan

    eng = _engine(programs, tmp_path, faults=FaultPlan.parse("fail@1"))
    try:
        rec = eng.result(eng.submit(_request()), wait_s=120.0)
        assert rec["status"] == "done" and rec["dispatch_attempts"] == 2
        assert eng.health_record()["retries"] == 1
    finally:
        eng.close()


def test_rehydration_after_restart_and_corruption_detected(programs, tmp_path):
    """A restarted engine over the same disk store rebuilds the capture from
    the persisted trajectory (``store_source == "disk"``, the same
    content_sha256); a corrupted entry is detected and re-inverted."""
    from videop2p_tpu_torch.serve import FaultPlan

    persist = str(tmp_path / "inv")
    first = _engine(programs, tmp_path / "a", persist_dir=persist)
    rec1 = first.result(first.submit(_request()), wait_s=120.0)
    first.close()
    assert rec1["store_source"] == "fresh"
    second = _engine(programs, tmp_path / "b", persist_dir=persist)
    rec2 = second.result(second.submit(_request()), wait_s=120.0)
    health = second.health_record()
    second.close()
    assert rec2["status"] == "done" and rec2["store_source"] == "disk"
    assert rec2["content_sha256"] == rec1["content_sha256"] and rec2["src_err"] == 0.0
    assert health["rehydrations"] == 1 and health["fresh_inversions"] == 0
    third = _engine(programs, tmp_path / "c", persist_dir=persist,
                    faults=FaultPlan.parse("corrupt:*"))
    rec3 = third.result(third.submit(_request()), wait_s=120.0)
    health = third.health_record()
    third.close()
    assert rec3["status"] == "done" and rec3["store_source"] == "fresh"
    assert health["store_corrupt"] == 1 and health["faults_injected"] == 1


def test_close_writes_health_and_fails_nothing_in_flight(programs, tmp_path):
    from videop2p_tpu_torch.obs import read_ledger
    from videop2p_tpu_torch.serve import EngineUnavailable

    eng = _engine(programs, tmp_path)
    rid = eng.submit(_request())
    eng.close(drain_s=60.0)
    assert eng.poll(rid)["status"] == "done"
    with pytest.raises(EngineUnavailable):
        eng.submit(_request())
    kinds = [e["event"] for e in read_ledger(eng.ledger.path)]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert kinds.index("serve_health") > kinds.index("serve_request")
    assert "cost_attribution" in kinds and "program_call" in kinds


def test_options_not_ported_raise(programs, tmp_path):
    """Every option is ported. ``slo=`` and ``incidents=`` (item 14's
    rest): the engine takes them. The multi-GPU options (item 13): a
    ``batch_dispatch="vmap"`` engine serves a request as the scan engine
    does (no data mesh: the same bits); the engine's own set takes the
    ring and tensor knobs into its spec; a model-parallel mesh in a plain
    process raises naming torchrun; a data mesh builds its replicas; an
    unknown dispatch raises."""
    from videop2p_tpu_torch.obs import IncidentManager, read_ledger
    from videop2p_tpu_torch.serve import EditEngine, ProgramSet, ProgramSpec

    for kw in (dict(slo=True), dict(incidents=str(tmp_path))):
        eng = _engine(programs, tmp_path / next(iter(kw)), **kw)
        eng.close()
        kinds = [e["event"] for e in read_ledger(eng.ledger.path)]
        if "slo" in kw:
            assert "slo_report" in kinds and eng.incidents is None
        else:
            assert isinstance(eng.incidents, IncidentManager) and "slo_report" not in kinds
            assert eng.incidents.root == str(tmp_path) and eng.ledger.flight is not None
    recs = []
    for dispatch in ("vmap", "scan"):
        eng = _engine(programs, tmp_path / dispatch, batch_dispatch=dispatch)
        try:
            recs.append(eng.result(eng.submit(_request()), wait_s=120.0))
        finally:
            eng.close()
    assert [r["status"] for r in recs] == ["done", "done"]
    assert recs[0]["content_sha256"] == recs[1]["content_sha256"]
    with pytest.raises(ValueError, match="batch_dispatch must be"):
        _engine(programs, tmp_path / "bad", batch_dispatch="pmap")
    for kw in (dict(ring_variant="bidir"), dict(tp_collectives="psum_scatter")):
        eng = EditEngine(ProgramSpec(**KW, **kw), out_dir=str(tmp_path / "knobs"),
                         device="cpu")
        eng.close()
        assert getattr(eng.spec, next(iter(kw))) == next(iter(kw.values()))
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        EditEngine(ProgramSpec(**KW, mesh="1,2,1"), out_dir=str(tmp_path / "mesh"),
                   device="cpu")
    assert len(ProgramSet(ProgramSpec(**KW, mesh="2,1,1"), device="cpu").replicas) == 2
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        ProgramSet(ProgramSpec(**KW, mesh="1,2,1"), device="cpu")


def test_a_failed_artifact_write_fails_only_its_request(programs, tmp_path, monkeypatch):
    """The writer thread finishes each dispatched request off the dispatch
    worker: a GIF that cannot be written fails that request alone, and the
    engine serves on."""
    from videop2p_tpu_torch.utils import video_io

    real = video_io.save_video_gif

    def flaky(video, path, **kw):
        if os.path.basename(path) == "broken.gif":
            raise OSError("disk full")
        return real(video, path, **kw)

    monkeypatch.setattr(video_io, "save_video_gif", flaky)
    eng = _engine(programs, tmp_path)
    try:
        bad = eng.result(eng.submit(_request(save_name="broken")), wait_s=120.0)
        good = eng.result(eng.submit(_request()), wait_s=120.0)
    finally:
        eng.close()
    assert bad["status"] == "error" and "disk full" in bad["error"]
    assert good["status"] == "done" and good["store_hit"] is True
    assert os.path.isfile(good["edit_gif"])


def test_program_cache_keeps_one_set_per_spec():
    from videop2p_tpu_torch.serve import ProgramCache, ProgramSpec

    cache = ProgramCache(max_sets=1, device="cpu")
    first = cache.get(ProgramSpec(**KW))
    assert cache.get(ProgramSpec(**KW)) is first and len(cache) == 1
    other = cache.get(ProgramSpec(**KW, seed=1))
    assert other is not first and other.spec.seed == 1 and len(cache) == 1
    assert cache.get(ProgramSpec(**KW)) is not first  # evicted, then rebuilt
