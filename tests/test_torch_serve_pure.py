"""The serving port's host-side modules against the JAX package's on the same
inputs (batching, scheduling, faults, Prometheus rendering, cost, latency
reservoirs, spans, quality metrics), and the port's own contracts of the
pieces with no JAX counterpart to run (the store over tensors, the run
ledger, ``compat_key`` over the port's argument trees, the CUDA side of
``is_transient``).

Everything but the quality metrics is exact: the same plans, records and
bytes. ``psnr`` / ``ssim`` (float32 on both sides) within 1e-5.
"""

import json
import threading

import numpy as np
import pytest
import torch

from tests.test_torch_parity import np32


class _Item:
    """A resolved request as the planner and the schedulers see it."""

    def __init__(self, compat, tag, *, seq=0, arrival_s=0.0, deadline_at=None,
                 tenant="default"):
        self.compat, self.tag, self.seq = compat, tag, seq
        self.arrival_s, self.deadline_at, self.tenant = arrival_s, deadline_at, tenant


def _items(seed: int, n: int = 23):
    rng = np.random.default_rng(seed)
    return [_Item(str(rng.choice(["a", "b", "c"])), i, seq=i + 1,
                  arrival_s=float(i) * 0.01 + float(rng.random()) * 0.005,
                  deadline_at=(None if rng.random() < 0.5 else float(rng.random())),
                  tenant=str(rng.choice(["A", "B", "probe"])))
            for i in range(n)]


def _plans(batches):
    """(key, member tags) of each plan. The port never pads (its programs
    are eager, with nothing to compile per batch size), so JAX's padded
    size is left out."""
    return [(b.key, [i.tag for i in b.items]) for b in batches]


# ---------------------------------------------------------------- batching --


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("order", ["first_seen", "oldest"])
def test_plan_batches_matches_jax(seed, order):
    from videop2p_tpu.serve.batching import plan_batches as jax_plan

    from videop2p_tpu_torch.serve.batching import plan_batches

    items = _items(seed)
    for max_batch in (1, 2, 3, 4):
        kw = dict(max_batch=max_batch, order=order, arrival_fn=lambda it: it.arrival_s)
        assert _plans(plan_batches(items, **kw)) == _plans(jax_plan(items, pad=False, **kw))


# -------------------------------------------------------------- scheduling --


def _drain(sched, items, chunks):
    """Feed ``items`` in ``chunks`` pieces and take every plan the policy
    forms, in order."""
    out = []
    for part in np.array_split(np.arange(len(items)), chunks):
        sched.add([items[i] for i in part])
        while True:
            plan = sched.next_plan(now=10.0, queue_empty=True)
            if plan is None:
                break
            out.append(_plans([plan])[0])
    return out, sched.snapshot()


@pytest.mark.parametrize("policy", ["drain", "continuous", "fair"])
@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_plans_match_jax(policy, seed):
    from videop2p_tpu.serve.sched import make_scheduler as jax_make
    from videop2p_tpu.serve.sched import parse_tenants as jax_tenants

    from videop2p_tpu_torch.serve.sched import make_scheduler, parse_tenants

    spec = "A:3:1,B:1:0,probe:1:5"
    kw = dict(max_batch=3, max_wait_s=0.05, order="oldest" if seed else "first_seen")
    ours = make_scheduler(policy, tenants=parse_tenants(spec), **kw)
    theirs = jax_make(policy, tenants=jax_tenants(spec), **kw)
    assert ours.preemptive == theirs.preemptive
    items = _items(seed)
    assert _drain(ours, items, 3) == _drain(theirs, items, 3)


@pytest.mark.parametrize("spec", [
    None, "", "A:5,B:1", "A:5:0,B:1:1,C", "gold:4:0, silver:2:1 ,bronze",
    '{"A": {"weight": 5, "deadline_s": 2.0}, "B": {"priority": 2}}',
])
def test_parse_tenants_matches_jax(spec):
    from videop2p_tpu.serve.sched import parse_tenants as jax_tenants

    from videop2p_tpu_torch.serve.sched import parse_tenants

    as_tuples = lambda d: {k: (v.weight, v.priority, v.deadline_s) for k, v in d.items()}  # noqa: E731
    assert as_tuples(parse_tenants(spec)) == as_tuples(jax_tenants(spec))


@pytest.mark.parametrize("spec", ["A:0", "A:x", ":1", "A:1:2:3", '{"A": {"bogus": 1}}'])
def test_parse_tenants_rejects_like_jax(spec):
    from videop2p_tpu.serve.sched import parse_tenants as jax_tenants

    from videop2p_tpu_torch.serve.sched import parse_tenants

    for fn in (parse_tenants, jax_tenants):
        with pytest.raises(ValueError):
            fn(spec)


# ------------------------------------------------------------------ faults --


@pytest.mark.parametrize("spec", [
    "fail@2", "fail@1,fail@3,hang@4:1.5,unavail@5-7,corrupt:*,wrong:ab",
    "hang@2,unavail@3,corrupt:", '{"fail": [2, 3], "hang": {"4": 1.5}, "unavail": [5, 7], '
    '"corrupt": ["*"], "wrong": ["x"]}', None, "",
])
def test_fault_plan_parse_matches_jax(spec):
    from videop2p_tpu.serve.faults import FaultPlan as JaxPlan

    from videop2p_tpu_torch.serve.faults import FaultPlan

    ours, theirs = FaultPlan.parse(spec), JaxPlan.parse(spec)
    if theirs is None:
        assert ours is None
        return
    for attr in ("fail", "hang", "unavail", "corrupt", "wrong", "spec"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr


def test_fault_plan_injections_match_jax():
    """The same plan fires the same faults at the same attempts (hangs
    zero-length), and the same corrupt/wrong keys."""
    from videop2p_tpu.serve.faults import FaultPlan as JaxPlan

    from videop2p_tpu_torch.serve.faults import FaultPlan

    spec = "fail@2,unavail@4-5,hang@6:0,corrupt:k1,wrong:*"

    def fire(plan):
        out = []
        for _ in range(7):
            try:
                out.append(plan.on_dispatch())
            except Exception as e:  # noqa: BLE001 — the fault is the result
                out.append(type(e).__name__)
        out += [plan.corrupts("k1-x"), plan.corrupts("k2"), plan.wrongs("any")]
        return out, plan.injected, plan.attempts

    assert fire(FaultPlan.parse(spec)) == fire(JaxPlan.parse(spec))
    with pytest.raises(ValueError, match="bad fault directive"):
        FaultPlan.parse("explode@1")


def test_retry_policy_and_breaker_match_jax():
    from videop2p_tpu.serve.faults import CircuitBreaker as JaxBreaker
    from videop2p_tpu.serve.faults import RetryPolicy as JaxRetry

    from videop2p_tpu_torch.serve.faults import CircuitBreaker, RetryPolicy

    for kw in ({}, dict(max_retries=5, base_s=0.1, cap_s=0.5), dict(max_retries=-1)):
        assert RetryPolicy(**kw).max_retries == JaxRetry(**kw).max_retries
        assert [RetryPolicy(**kw).delay_s(a) for a in range(8)] == \
            [JaxRetry(**kw).delay_s(a) for a in range(8)]

    def drive(cls, open_s):
        log = []
        br = cls(threshold=2, open_s=open_s,
                 on_transition=lambda a, b, **kw: log.append((a, b, kw["trips"])))
        states = []
        for op in ("f", "s", "f", "f", "a", "f", "s", "f", "f", "a"):
            if op == "f":
                br.record_failure()
            elif op == "s":
                br.record_success()
            else:
                states.append(br.allow())
            states.append(br.state)
        snap = br.snapshot()
        snap.pop("retry_after_s")
        return states, log, snap, br.trips

    for open_s in (0.0, 60.0):
        assert drive(CircuitBreaker, open_s) == drive(JaxBreaker, open_s)


def test_is_transient_sorts_torch_failures():
    """CUDA's out-of-memory is JAX's RESOURCE_EXHAUSTED (transient); a
    sticky CUDA error leaves the context unusable (never transient); the
    injected faults and the runtime's transient messages agree with JAX's
    classification."""
    from videop2p_tpu.serve.faults import is_transient as jax_transient

    from videop2p_tpu_torch.serve.faults import (
        BackendUnavailableError,
        DeadlineExceeded,
        TransientDispatchError,
        is_transient,
    )

    assert is_transient(torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"))
    assert is_transient(RuntimeError("CUDA error: out of memory"))
    for sticky in ("CUDA error: an illegal memory access was encountered",
                   "CUDA error: unspecified launch failure",
                   "CUDA error: device-side assert triggered",
                   "CUDA error: misaligned address",
                   "CUDA error: an illegal instruction was encountered"):
        assert not is_transient(RuntimeError(sticky)), sticky
    assert not is_transient(torch.cuda.OutOfMemoryError(
        "out of memory after an illegal memory access"))
    assert not is_transient(DeadlineExceeded("UNAVAILABLE but the budget is spent"))
    shared = [TransientDispatchError("injected"), BackendUnavailableError("injected"),
              RuntimeError("UNAVAILABLE: the backend dropped"),
              RuntimeError("RESOURCE EXHAUSTED: out of HBM"),
              RuntimeError("connection reset by peer"), ValueError("bad shapes"),
              RuntimeError("boom")]
    jax_shared = [type(e)(str(e)) if not isinstance(
        e, (TransientDispatchError, BackendUnavailableError)) else e for e in shared]
    assert [is_transient(e) for e in shared] == [True, True, True, True, True, False, False]
    assert [is_transient(e) for e in shared[2:]] == [jax_transient(e) for e in jax_shared[2:]]


# ------------------------------------------------------------ prometheus --


def _metrics_record():
    return {
        "uptime_s": 12.5, "spec_fingerprint": "abc123", "warm": {"seconds": 3.25,
                                                                 "steps": [2, 4]},
        "requests": {"done": 7, "error": 1, "queued": 0},
        "queue_depth": 2, "in_flight": 3, "max_queue": 64,
        "scheduler": {"policy": "fair", "pending": 1, "lanes": {"A": 1}},
        "tenants": {"A": {"submitted": 5, "error_rate": 0.2, "device_seconds": 1.5},
                    'b"x\\y': {"submitted": 1, "shed_rate": float("nan")}},
        "breaker": {"state": "closed", "trips": 0, "open_s": 5.0},
        "counters": {"retries": 2, "shed": 0},
        "store": {"entries": 1, "hit_rate": None, "bytes_in_use": 123456789},
        "compile": {"events": 4, "total_s": 1.23456789012345},
        "request_latency": {"count": 3, "blocked_p99_s": 0.5},
        "programs": {"serve_edit": {"count": 3, "blocked_p50_s": 0.25,
                                    "max_trace_id": None},
                     "serve_invert": {"count": 1, "blocked_p50_s": float("inf")}},
        "replicas": {"r0": {"requests": {"done": 2}, "healthy": True, "store": {"x": 1},
                            "load": -0.5}},
        "capacity": {"busy_fraction": 0.25, "occupancy": 1.0, "flag": False},
        "devices": [{"bytes_in_use": 5}],
    }


def test_render_prometheus_byte_identical_to_jax():
    from videop2p_tpu.obs.prom import parse_prometheus as jax_parse
    from videop2p_tpu.obs.prom import render_prometheus as jax_render

    from videop2p_tpu_torch.obs.prom import (
        engine_metrics_prometheus,
        parse_prometheus,
        render_prometheus,
    )

    rec = _metrics_record()
    text = render_prometheus(rec)
    assert text == jax_render(rec)
    assert engine_metrics_prometheus(rec) == text
    assert render_prometheus({}) == jax_render({}) == ""
    ours, theirs = parse_prometheus(text), jax_parse(text)
    assert json.dumps(ours, sort_keys=True) == json.dumps(theirs, sort_keys=True)
    by_name = {s["name"]: s for s in ours["samples"] if not s["labels"]}
    assert by_name["videop2p_compile_total_s"]["value"] == pytest.approx(1.23456789012345)


# -------------------------------------------------------------------- cost --


def _cost_run(model):
    model.note_fresh_inversion(2.5)
    rows = [model.price_dispatch(1.2, real=1, padded=1, program="serve_edit",
                                 singleton="serve_edit"),
            model.price_dispatch(3.0, real=3, padded=4, program="serve_edit_b4_scan",
                                 singleton="serve_edit"),
            model.price_dispatch(0.5, real=2, padded=2, program="serve_edit_b2_scan"),
            model.price_dispatch(-1.0, real=0, padded=0)]
    model.account_request(tenant="A", cost={"program": "serve_edit", "device_seconds": 1.2,
                                            "queue_seconds": 0.1, "flops": 0.0},
                          store_hit=False,
                          programs=[("serve_edit", {"device_seconds": 0.9}),
                                    ("serve_invert", {"device_seconds": 0.3})])
    model.account_request(tenant="", cost={"device_seconds": 0.75,
                                           "saved_device_seconds": 2.5}, store_hit=True)
    model.note_fresh_inversion(1.5)
    return (rows, model.savings(), model.tenant_costs(), model.capacity(10.0),
            model.capacity(0.0, requests_costed=4), model.attribution_records(10.0))


def test_cost_model_matches_jax():
    """The same dispatch sequence priced by both models, the JAX one with
    no static facts observed (the port has none: its flop and HBM-byte
    fields read 0.0)."""
    from videop2p_tpu.obs.cost import CAPACITY_FIELDS as JAX_CAPACITY
    from videop2p_tpu.obs.cost import CostModel as JaxCost

    from videop2p_tpu_torch.obs.cost import CAPACITY_FIELDS, CostModel

    assert CAPACITY_FIELDS == JAX_CAPACITY
    ours, theirs = _cost_run(CostModel()), _cost_run(JaxCost())
    assert json.dumps(ours, sort_keys=True) == json.dumps(theirs, sort_keys=True)
    cap = ours[3]
    assert cap["conservation_residual_s"] == 0.0
    assert cap["busy_seconds"] == pytest.approx(cap["attributed_seconds"]
                                                + cap["padding_seconds"])


# ------------------------------------------------------------------ timing --


@pytest.mark.parametrize("n", [1, 7, 1500])
def test_latency_reservoir_summary_matches_jax(n):
    from videop2p_tpu.obs.timing import LatencyReservoir as JaxReservoir
    from videop2p_tpu.obs.timing import percentile as jax_percentile

    from videop2p_tpu_torch.obs.timing import EXECUTE_TIMING_FIELDS, LatencyReservoir, percentile

    rng = np.random.default_rng(n)
    ours, theirs = LatencyReservoir(capacity=64, seed=3), JaxReservoir(capacity=64, seed=3)
    assert ours.summary() is None and theirs.summary() is None
    for i in range(n):
        d, b = float(rng.random()), float(rng.random() * 2)
        tid = f"{i:032x}" if i % 3 == 0 else None
        ours.add(d, b, tid)
        theirs.add(d, b, tid)
    assert ours.summary() == theirs.summary()
    assert tuple(ours.summary()) == EXECUTE_TIMING_FIELDS
    xs = list(rng.random(11))
    for q in (0, 1, 50, 95, 99, 100):
        assert percentile(xs, q) == jax_percentile(xs, q)


# ------------------------------------------------------------------- spans --


def test_traceparent_and_span_ids_match_jax(tmp_path):
    from videop2p_tpu.obs.spans import format_traceparent as jax_format
    from videop2p_tpu.obs.spans import parse_traceparent as jax_parse

    from videop2p_tpu_torch.obs import RunLedger, read_ledger
    from videop2p_tpu_torch.obs.spans import (
        SPAN_EVENT_FIELDS,
        Tracer,
        format_traceparent,
        make_span_id,
        make_trace_id,
        parse_traceparent,
    )

    tid, sid = make_trace_id(), make_span_id()
    assert len(tid) == 32 and len(sid) == 16 and int(tid, 16) >= 0 and int(sid, 16) >= 0
    assert format_traceparent(tid, sid) == jax_format(tid, sid)
    headers = [None, "", 7, format_traceparent(tid, sid), format_traceparent(tid, sid).upper(),
               f" 00-{tid}-{sid}-01 ", "00-abc-def-01", f"00-{'0' * 32}-{sid}-01",
               f"00-{tid}-{'0' * 16}-01", f"00-{'g' * 32}-{sid}-01", f"000-{tid}-{sid}-01",
               f"00-{tid}-{sid}"]
    assert [parse_traceparent(h) for h in headers] == [jax_parse(h) for h in headers]
    led = RunLedger(str(tmp_path / "spans.jsonl"))
    assert Tracer(led).emit("serve.x", trace_id=tid, span_id=sid) is None
    fields = Tracer(led, enabled=True).emit("serve.x", trace_id=tid, span_id=sid,
                                            duration_s=0.5, rid="r1")
    led.close()
    spans = [e for e in read_ledger(str(tmp_path / "spans.jsonl")) if e["event"] == "span"]
    assert len(spans) == 1 and set(SPAN_EVENT_FIELDS) <= set(spans[0])
    assert spans[0]["rid"] == "r1" and fields["duration_s"] == 0.5


# ----------------------------------------------------------------- quality --


def test_psnr_ssim_match_jax():
    from videop2p_tpu.obs import quality as jq

    from videop2p_tpu_torch.obs import quality as pq

    rng = np.random.default_rng(0)
    a = rng.random((3, 16, 16, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    for name in ("psnr", "ssim", "frame_psnr"):
        got = np32(getattr(pq, name)(torch.from_numpy(a), torch.from_numpy(b)))
        want = np.asarray(getattr(jq, name)(a, b))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=name)
    np.testing.assert_allclose(np32(pq.adjacent_frame_psnr(a)),
                               np.asarray(jq.adjacent_frame_psnr(a)), atol=1e-5, rtol=0)
    assert float(pq.psnr(a, a)) == float("inf") and float(pq.ssim(a, a)) == 1.0


# ------------------------------------------------ store, ledger, batching --


def _products(mib: float):
    return (torch.zeros(int(mib * (1 << 20)) // 4), {"anchor": torch.zeros(0)})


def test_store_lru_eviction_and_oversize_refusal():
    from videop2p_tpu_torch.serve.store import InversionStore, tree_nbytes

    assert tree_nbytes(_products(1)) == 1 << 20
    store = InversionStore(3 << 20)
    for k in ("a", "b", "c"):
        assert store.put(k, _products(1))
    assert store.get("a") is not None  # a is now the most recent
    assert store.put("d", _products(1))  # evicts b, the least recent
    assert sorted(store.keys()) == ["a", "c", "d"] and store.evictions == 1
    assert not store.put("huge", _products(4))  # above the whole budget
    assert store.rejected_oversize == 1 and "huge" not in store and len(store) == 3
    assert store.get("b") is None
    stats = store.stats()
    assert stats["bytes_in_use"] == 3 << 20 and stats["hits"] == 1 and stats["misses"] == 1
    with pytest.raises(ValueError):
        InversionStore(0)


def test_store_disk_layer_validates_and_detects_corruption(tmp_path):
    from videop2p_tpu_torch.serve.faults import FaultPlan
    from videop2p_tpu_torch.serve.store import InversionStore

    traj = np.random.default_rng(0).normal(size=(3, 1, 2, 4, 4, 4)).astype(np.float32)
    store = InversionStore(1 << 20, persist_dir=str(tmp_path))
    store.put("k1", _products(0.1), trajectory=traj, meta={"prompt": "x"})
    np.testing.assert_array_equal(store.load_disk("k1"), traj)
    assert store.load_disk("absent") is None and store.disk_hits == 1
    (tmp_path / "inv_cache" / "k2").mkdir(parents=True)
    (tmp_path / "inv_cache" / "k2" / "trajectory.npy").write_bytes(b"torn")
    assert store.load_disk("k2") is None and store.disk_corrupt == 1
    plan = FaultPlan.parse("corrupt:k1")
    corrupting = InversionStore(1 << 20, persist_dir=str(tmp_path), faults=plan)
    assert corrupting.load_disk("k1") is None and corrupting.disk_corrupt == 1
    assert plan.injected == [{"kind": "store_corrupt", "key": "k1"}]


def test_run_ledger_concurrent_writers_and_close(tmp_path):
    from videop2p_tpu_torch.obs import RunLedger, read_ledger

    path = str(tmp_path / "ledger.jsonl")
    led = RunLedger(path, meta={"cli": "test"})

    def writer(i):
        for j in range(200):
            led.event("tick", writer=i, j=j, pad="x" * 512)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    led.close()
    led.event("after_close", x=1)  # silent, never raises
    led.close()
    with open(path) as fh:
        lines = fh.read().splitlines()
    events = [json.loads(line) for line in lines]  # no torn line
    ticks = [e for e in events if e["event"] == "tick"]
    assert len(ticks) == 8 * 200
    assert events[0]["event"] == "run_start" and events[0]["cli"] == "test"
    assert events[0]["torch_version"] == torch.__version__
    assert events[-1]["event"] == "run_end"
    assert not any(e["event"] == "after_close" for e in events)
    assert read_ledger(path) == events


def test_ledger_records_programs_phases_and_memory(tmp_path):
    """A program's first call is a miss and a ``compile`` event; execute
    timing fills its reservoir; ``phase_timer`` and a kernel build land as
    events while the ledger is active; ``memory`` is unsupported on the
    CPU."""
    from videop2p_tpu_torch.obs import instrumented_program, read_ledger
    from videop2p_tpu_torch.cli.common import make_run_ledger
    from videop2p_tpu_torch.ops import _build
    from videop2p_tpu_torch.utils.profiling import phase_timer

    path = str(tmp_path / "l.jsonl")
    led = make_run_ledger(path, device="cpu")
    synced = []
    prog = instrumented_program(lambda x: x + 1, program="p", sync=lambda: synced.append(1))
    assert prog(1) == 2 and prog(2) == 3
    with phase_timer("warm"):
        pass
    for listener in _build.BUILD_LISTENERS:
        listener("groupnorm.cu", 1.5)
    led.memory_snapshot("now")
    assert led.execute_timing_summary()["p"]["count"] == 2 and len(synced) == 2
    led.close()
    events = read_ledger(path)
    calls = [e for e in events if e["event"] == "program_call"]
    assert [c["cache_miss"] for c in calls] == [True, False]
    compiles = [e for e in events if e["event"] == "compile"]
    assert [(c["program"], c["metric"]) for c in compiles] == [("p", "first_call"),
                                                             (None, "nvcc")]
    assert any(e["event"] == "phase" and e["name"] == "warm" for e in events)
    mem = next(e for e in events if e["event"] == "memory")
    assert mem["supported"] is False
    assert any(e["event"] == "execute_timing" and e["program"] == "p" for e in events)


def test_compat_key_follows_structure_shapes_and_statics():
    from dataclasses import dataclass

    from videop2p_tpu_torch.serve.batching import compat_key, stack_items, unstack_outputs

    @dataclass
    class Ctx:
        maps: torch.Tensor
        kind: str = "refine"
        blend: object = None

    def tree(x=None, kind="refine", blend=None, dtype=torch.float32, shape=(2, 3)):
        x = torch.zeros(shape, dtype=dtype) if x is None else x
        return (Ctx(x, kind, blend), {"cond": x, "steps": [1, 2]})

    base = compat_key(tree())
    assert compat_key(tree(x=torch.ones(2, 3))) == base  # values never enter
    assert compat_key(tree()) == base  # never object ids
    for other in (tree(kind="replace"), tree(dtype=torch.bfloat16), tree(shape=(2, 4)),
                  tree(blend=Ctx(torch.zeros(1)))):
        assert compat_key(other) != base
    assert compat_key(tree(), extra=(1,)) != compat_key(tree(), extra=(2,))
    members = stack_items([tree(), tree(x=torch.ones(2, 3))])
    assert len(members) == 2 and members[1][1]["cond"].sum() == 6
    with pytest.raises(ValueError):
        stack_items([tree(), tree(kind="replace")])
    with pytest.raises(ValueError):
        stack_items([])
    outs = unstack_outputs((torch.arange(4), torch.arange(4) * 2), 3)
    assert [(int(a), int(b)) for a, b in outs] == [(0, 0), (1, 2), (2, 4)]


def test_edit_request_validation_and_json_surface():
    from videop2p_tpu_torch.serve import EditRequest

    for bad, match in ((dict(prompts=["a", "b"]), "source 'prompt'"),
                       (dict(prompt="a", prompts=["a"]), ">= 2"),
                       (dict(prompt="a", prompts=["b", "c"], image_path="x"), r"prompts\[0\]"),
                       (dict(prompt="a", prompts=["a", "b"]), "image_path"),
                       (dict(prompt="a", prompts=["a", "b"], image_path="x", steps=0),
                        "positive int"),
                       (dict(prompt="a", prompts=["a", "b"], image_path="x", deadline_s=0),
                        "deadline_s"),
                       (dict(prompt="a", prompts=["a", "b"], image_path="x",
                             quant_mode="int3"), "quant"),
                       (dict(prompt="a", prompts=["a", "b"], image_path="x", student=1),
                        "bool")):
        with pytest.raises(ValueError, match=match):
            EditRequest(**bad).validate()
    with pytest.raises(ValueError, match="unknown request field"):
        EditRequest.from_dict({"prompt": "a", "bogus": 1})
    req = EditRequest.from_dict({"image_path": "x", "prompt": "a", "prompts": ["a", "b"]})
    req.validate()
    assert "frames" not in req.to_dict()
    from videop2p_tpu.serve.engine import _REQUEST_FIELDS as JAX_FIELDS
    from videop2p_tpu.serve.engine import TERMINAL_STATUSES as JAX_TERMINAL

    from videop2p_tpu_torch.serve.engine import _REQUEST_FIELDS, TERMINAL_STATUSES

    assert _REQUEST_FIELDS == JAX_FIELDS and TERMINAL_STATUSES == JAX_TERMINAL
