"""The port's fleet telemetry store and signals (``videop2p_tpu_torch/obs/
{tsdb,signals,attention}.py``) against the JAX package's.

Seeded numpy scrape streams — several replicas and the router, per-status
request counters with restarts, per-tenant counters, latency and capacity
gauges, explicit gaps, and out-of-order timestamps the store must drop —
go through both packages' :class:`TimeSeriesStore`, and both
:class:`SignalEngine`\\ s evaluate the same stores at the same clock. Both
sides are the same float64 arithmetic in the same order, so every record,
query, quantile and slope must be EQUAL (tolerance 0; NaN equals NaN).
"""

from __future__ import annotations

import math

import numpy as np
import pytest

import tests.test_torch_parity  # noqa: F401 — one torch thread a test process

from videop2p_tpu.obs import signals as jsig
from videop2p_tpu.obs import tsdb as jts
from videop2p_tpu_torch.obs import signals as tsig
from videop2p_tpu_torch.obs import tsdb as tts

REPLICAS = ("replica0", "replica1", "router")
STATUSES = ("done", "error", "deadline_exceeded", "engine_closed", "queued")
TENANTS = ("A", "B", "probe")


def _same(a, b) -> bool:
    """Exact equality of nested records, NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(
            a, b, equal_nan=a.dtype.kind == "f")
    return type(a) is type(b) and a == b


def _scrape_ops(seed: int, n: int = 60):
    """The (series, t, value, labels) adds and gaps of ``n`` seeded scrape
    passes, in the order a collector writes them."""
    rng = np.random.default_rng(seed)
    ops = []
    counters = {(r, s): 0.0 for r in REPLICAS for s in STATUSES}
    tenant = {(r, t, f): 0.0 for r in REPLICAS for t in TENANTS
              for f in ("submitted", "done", "shed", "rejected", "device_seconds")}
    t = 0.0
    for i in range(n):
        t += float(rng.uniform(0.2, 1.5))
        for j, rep in enumerate(REPLICAS):
            ts = t + j * 1e-6
            lab = {"replica": rep}
            if rng.random() < 0.08:  # a failed scrape: up = 0 and gaps
                ops.append(("add", tsig.S_UP, ts, 0.0, lab))
                for name in (tsig.S_QUEUE_DEPTH, tsig.S_LATENCY_P99):
                    ops.append(("gap", name, ts, None, lab))
                continue
            ops.append(("add", tsig.S_UP, ts, 1.0, lab))
            ops.append(("add", tsig.S_QUEUE_DEPTH, ts, float(rng.integers(0, 6)), lab))
            ops.append(("add", tsig.S_IN_FLIGHT, ts, float(rng.integers(0, 3)), lab))
            ops.append(("add", tsig.S_LATENCY_P50, ts, float(rng.uniform(0.1, 2)), lab))
            ops.append(("add", tsig.S_LATENCY_P99, ts, float(rng.uniform(1, 9)), lab))
            ops.append(("add", tsig.S_QUEUE_WAIT_P99, ts, float(rng.uniform(0, 4)), lab))
            ops.append(("add", tsig.S_DISPATCH_P50, ts, float(rng.uniform(0.2, 1)), lab))
            ops.append(("add", tsig.S_STORE_HIT_RATE, ts, float(rng.uniform(0, 1)), lab))
            ops.append(("add", tsig.S_BUSY_FRACTION, ts, float(rng.uniform(0, 1)), lab))
            ops.append(("add", tsig.S_PADDING_WASTE, ts, float(rng.uniform(0, .2)), lab))
            ops.append(("add", tsig.S_COST_PER_REQUEST, ts, float(rng.uniform(.5, 3)), lab))
            for s in STATUSES:
                if rng.random() < 0.03:  # a restart: the counter drops
                    counters[(rep, s)] = float(rng.integers(0, 3))
                else:
                    counters[(rep, s)] += float(rng.poisson(0.3 if s == "error" else 2))
                ops.append(("add", tsig.S_REQUESTS, ts, counters[(rep, s)],
                            {**lab, "status": s}))
            for (r, ten, f), v in tenant.items():
                if r != rep:
                    continue
                tenant[(r, ten, f)] = v + float(rng.uniform(0, 2))
                ops.append(("add", tsig.S_TENANT, ts, tenant[(r, ten, f)],
                            {**lab, "tenant": ten, "field": f}))
            ops.append(("add", tsig.S_SCRAPES, ts, float(i + 1), lab))
            ops.append(("add", tsig.S_SCRAPE_ERRORS, ts, float(rng.integers(0, 2)), lab))
        for tgt in REPLICAS:
            for probe in ("determinism", "golden_quality"):
                ops.append(("add", tsig.S_PROBE_SUCCESS, t + 0.5e-3,
                            float(rng.random() < 0.9), {"target": tgt, "probe": probe}))
        if rng.random() < 0.1:  # a clock that steps back: dropped, counted
            ops.append(("add", tsig.S_UP, t - 5.0, 1.0, {"replica": "replica0"}))
        if rng.random() < 0.05:  # an unfloatable value: dropped, counted
            ops.append(("add", tsig.S_QUEUE_DEPTH, t + 1e-3, "n/a", {"replica": "replica1"}))
    return ops, t


def _stores(seed: int, capacity: int = 64):
    ops, t_end = _scrape_ops(seed)
    a, b = jts.TimeSeriesStore(capacity), tts.TimeSeriesStore(capacity)
    for kind, name, t, v, lab in ops:
        for store in (a, b):
            ra = (store.add(name, t, v, lab) if kind == "add" else store.gap(name, t, lab))
            assert isinstance(ra, bool)
    return a, b, t_end


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_store_queries_equal_jax(seed):
    """Every query of the port's store equals JAX's on the same stream:
    rings (gaps included), drops, windows, means, maxima, nearest-rank
    quantiles, counter-reset-aware increases and rates, latest samples."""
    a, b, t_end = _stores(seed)
    assert (a.dropped, a.gaps, a.samples, len(a)) == (b.dropped, b.gaps, b.samples, len(b))
    assert a.dropped > 0 and a.gaps > 0
    assert a.keys() == b.keys() and a.names() == b.names()
    for name, items in a.keys():
        lab = dict(items)
        assert _same(a.series(name, lab), b.series(name, lab))
        assert a.latest(name, lab) == b.latest(name, lab)
        for now, w in ((t_end, 5.0), (t_end, 30.0), (t_end * 0.6, 12.0), (t_end, 1e9)):
            assert a.window(name, now, w, lab) == b.window(name, now, w, lab)
            assert a.mean(name, now, w, lab) == b.mean(name, now, w, lab)
            assert a.vmax(name, now, w, lab) == b.vmax(name, now, w, lab)
            assert a.increase(name, now, w, lab) == b.increase(name, now, w, lab)
            assert a.rate(name, now, w, lab) == b.rate(name, now, w, lab)
            for q in (0, 50, 90, 99, 100):
                assert a.quantile(name, now, w, q, lab) == b.quantile(name, now, w, q, lab)
    for name in a.names():
        assert a.labelsets(name) == b.labelsets(name)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_signal_engine_records_equal_jax(seed):
    """``SignalEngine.evaluate`` at a walking clock, with exemplars and the
    prober's verdicts pushed in, gives JAX's ``fleet_signals`` records field
    for field (burns over both windows, slopes, saturation, tenant demand,
    economics, EWMA flags, probe burn, advice and reasons), and the same
    ``summary()``."""
    a, b, t_end = _stores(seed)
    ea = jsig.SignalEngine(a, window_scale=0.01, saturation_threshold=3.0)
    eb = tsig.SignalEngine(b, window_scale=0.01, saturation_threshold=3.0)
    ex = {"serve_dispatch": {"p99_trace_id": "ab" * 16, "max_trace_id": None}}
    status = {"replica0": "pass", "replica1": "quarantine", "router": "pass"}
    divs = [{"divergent": "replica1", "hash_a": "aa" * 32, "hash_b": "bb" * 32,
             "replica_a": "replica0"}]
    for i, now in enumerate(np.linspace(t_end * 0.3, t_end, 9)):
        if i == 4:
            for eng in (ea, eb):
                eng.set_exemplars(ex)
                eng.set_probe_status(status, divs)
        ra, rb = ea.evaluate(float(now)), eb.evaluate(float(now))
        assert list(rb) == list(tsig.FLEET_SIGNALS_FIELDS)
        assert _same(ra, rb), {k: (ra[k], rb[k]) for k in ra if not _same(ra[k], rb[k])}
    assert ea.summary() == eb.summary()


def test_signal_burn_windows_and_idle_advice_equal_jax():
    """The two hand-built fleets of the JAX tests — a fast-window error spike
    that must not page and sustained errors that must; an idle fleet that
    shrinks until one in-flight sample or a dark replica — through both
    engines, record for record."""

    def seed_requests(ts, now, errors_recent, errors_old, done=20):
        lab = {"replica": "replica0"}
        err = 0.0
        for i in range(int(now) + 1):
            ts.add(tsig.S_UP, float(i), 1.0, lab)
            ts.add(tsig.S_REQUESTS, float(i), min(float(i), float(done)),
                   {**lab, "status": "done"})
            if i < 3:
                err += errors_old / 3.0
            if i > now - 2:
                err += errors_recent / 2.0
            ts.add(tsig.S_REQUESTS, float(i), err, {**lab, "status": "error"})

    for recent, old, alert in ((0.2, 0.0, False), (2.0, 6.0, True)):
        recs = []
        for mod in (jsig, tsig):
            store = (jts if mod is jsig else tts).TimeSeriesStore()
            seed_requests(store, 30, recent, old)
            eng = mod.SignalEngine(store, window_scale=0.01)
            recs.append([eng.evaluate(30.0), eng.evaluate(30.5), eng.summary()])
        assert _same(recs[0], recs[1])
        assert recs[1][0]["burn_alert"] is alert

    recs = []
    for mod, store_mod in ((jsig, jts), (tsig, tts)):
        ts = store_mod.TimeSeriesStore()
        eng = mod.SignalEngine(ts, window_scale=0.01)
        for i in range(10):
            for r in ("replica0", "replica1"):
                for name in (mod.S_UP, mod.S_QUEUE_DEPTH, mod.S_IN_FLIGHT):
                    ts.add(name, float(i), 1.0 if name == mod.S_UP else 0.0, {"replica": r})
        out = [eng.evaluate(9.0)]
        ts.add(mod.S_IN_FLIGHT, 9.5, 1.0, {"replica": "replica1"})
        out.append(eng.evaluate(9.6))
        ts.gap(mod.S_UP, 10.0, {"replica": "replica0"})
        ts.add(mod.S_UP, 10.0, 1.0, {"replica": "replica1"})
        out.append(eng.evaluate(10.1))
        recs.append(out)
    assert _same(recs[0], recs[1])
    assert [r["scale_advice"] for r in recs[1]] == ["shrink", "hold", "grow"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_theil_sen_slope_equals_jax(seed):
    """Median of pairwise slopes on seeded points with outliers, repeated
    timestamps and the max_points cut: the same float64 either side."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 50, 150)).round(1)
    v = 0.3 * t + rng.normal(0, 1, t.size)
    v[rng.integers(0, t.size, 8)] = 1e6
    pts = list(zip(t.tolist(), v.tolist()))
    for cut in (2, 30, 100, 150):
        assert jsig.theil_sen_slope(pts, cut) == tsig.theil_sen_slope(pts, cut)
    assert tsig.theil_sen_slope([]) == jsig.theil_sen_slope([]) == 0.0
    assert tsig.theil_sen_slope([(1.0, 5.0), (1.0, 9.0)]) == 0.0


def test_schema_constants_equal_jax():
    """The ledger schemas and series names the collector and the readers
    (``tools/fleet_dash.py``) key on are JAX's."""
    assert tsig.FLEET_SIGNALS_FIELDS == jsig.FLEET_SIGNALS_FIELDS
    assert tsig.FLEET_TENANT_FIELDS == jsig.FLEET_TENANT_FIELDS
    assert tts.FLEET_SERIES_FIELDS == jts.FLEET_SERIES_FIELDS
    assert tsig.__all__ == jsig.__all__
    for name in jsig.__all__:
        if name.startswith("S_"):
            assert getattr(tsig, name) == getattr(jsig, name)
    assert (tsig.ERROR_STATUSES, tsig.FINISHED_STATUSES) == (
        jsig.ERROR_STATUSES, jsig.FINISHED_STATUSES)


@pytest.mark.parametrize("seed", [0, 1])
def test_snapshot_sidecar_round_trip_equals_jax(seed, tmp_path):
    """The ``fleet_series`` record and the ``.npz`` arrays (stride-thinned,
    newest kept, NaN gaps preserved) equal JAX's; either package's sidecar
    restores in the other into a store with the same rings."""
    from videop2p_tpu.obs import RunLedger as JaxLedger
    from videop2p_tpu.obs import read_ledger as jax_read
    from videop2p_tpu_torch.obs import RunLedger, read_ledger

    a, b, _ = _stores(seed, capacity=200)
    for max_points in (7, 64, 256):
        arr_a, keys_a = a.snapshot_arrays(max_points=max_points)
        arr_b, keys_b = b.snapshot_arrays(max_points=max_points)
        assert keys_a == keys_b and arr_a.keys() == arr_b.keys()
        for k in arr_a:
            assert _same(arr_a[k], arr_b[k]), k
    pa, pb = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    with JaxLedger(str(tmp_path / "jax.jsonl")) as led:
        rec_a = a.snapshot(led, label="fleet", sidecar_path=pa, max_points=32)
    with RunLedger(str(tmp_path / "port.jsonl")) as led:
        rec_b = b.snapshot(led, label="fleet", sidecar_path=pb, max_points=32)
    assert {k: v for k, v in rec_a.items() if k != "sidecar"} == {
        k: v for k, v in rec_b.items() if k != "sidecar"}
    ev_a = [e for e in jax_read(str(tmp_path / "jax.jsonl")) if e["event"] == "fleet_series"]
    ev_b = [e for e in read_ledger(str(tmp_path / "port.jsonl"))
            if e["event"] == "fleet_series"]
    assert len(ev_a) == len(ev_b) == 1 and ev_b[0]["sidecar"] == pb
    assert _same(jts.load_series_sidecar(pb), tts.load_series_sidecar(pa))
    assert _same(tts.load_series_sidecar(pb), jts.load_series_sidecar(pb))
    ra, rb = jts.restore_store(pb), tts.restore_store(pa)
    assert ra.keys() == rb.keys() and ra.samples == rb.samples
    for name, items in ra.keys():
        assert _same(ra.series(name, dict(items)), rb.series(name, dict(items)))
    # the sidecar helpers themselves: the same arrays back, any dtype
    from videop2p_tpu_torch.obs.attention import load_obs_sidecar, save_obs_sidecar

    arrays = {"f": np.arange(5.0), "i": np.arange(3, dtype=np.int32),
              "s": np.asarray('["a"]')}
    back = load_obs_sidecar(save_obs_sidecar(str(tmp_path / "sub" / "x.npz"), arrays))
    assert all(np.array_equal(back[k], arrays[k]) and back[k].dtype == arrays[k].dtype
               for k in arrays)


def test_gaps_counter_resets_and_bounded_rings():
    """The store's own contract on a hand-built stream (as JAX's tests pin
    it): non-monotonic and unfloatable samples dropped and counted, NaN gaps
    skipped by queries but kept on the axis, a restart's counter drop
    counted as its post-reset value, rings bounded at ``capacity``."""
    ts = tts.TimeSeriesStore(capacity=8)
    lab = {"replica": "replica0"}
    assert ts.add("q", 1.0, 2.0, lab) and ts.add("q", 2.0, 4.0, lab)
    assert not ts.add("q", 2.0, 9.0, lab) and not ts.add("q", 1.5, 9.0, lab)
    assert not ts.add("q", 3.0, "nope", lab)
    assert ts.dropped == 3
    assert ts.gap("q", 3.0, lab) and ts.add("q", 4.0, 6.0, lab)
    assert ts.window("q", 4.0, 3.0, lab) == [(2.0, 4.0), (4.0, 6.0)]
    ts.gap("q", 5.0, lab)
    assert ts.latest("q", lab) == (4.0, 6.0) and ts.gaps == 2
    for t, v in [(10.0, 10.0), (11.0, 14.0), (12.0, 3.0), (13.0, 8.0)]:
        ts.add("c", t, v)
    assert ts.increase("c", 13.0, 10.0) == 12.0
    assert ts.rate("c", 13.0, 10.0) == 4.0
    for i in range(20):
        ts.add("q", 10.0 + i, 1.0, lab)
    assert len(ts.series("q", lab)) == 8
    with pytest.raises(ValueError):
        tts.TimeSeriesStore(capacity=1)
