"""The port's correctness plane (``videop2p_tpu_torch/obs/probe.py``,
``serve/prober.py``) against the JAX package's, and on a tiny fleet.

The JAX tests' scriptable JSON-API fakes (``tests/test_probe.py``) go
through both packages' :class:`ProbeSuite`, :class:`AnswerAudit` and
:class:`FleetProber` with the same injected clock: every probe record,
audit divergence, verdict and ledger event must be EQUAL. Then a tiny
two-replica in-process fleet on the CPU with ``wrong:*`` on replica 1: the
audit (anchored on replica 0's known answer) quarantines replica 1, the
router routes around it, and the quarantine lifts when its answers agree
again.
"""

from __future__ import annotations

import itertools
import os

import pytest

from tests.test_torch_parity import TEST_THREADS  # noqa: F401 — one thread a process

from videop2p_tpu.obs import probe as jprobe
from videop2p_tpu.serve import prober as jprober
from videop2p_tpu_torch.obs import probe as tprobe
from videop2p_tpu_torch.serve import prober as tprober

CANARY = dict(image_path="data/rabbit", prompt="a rabbit is jumping",
              prompts=["a rabbit is jumping", "a origami rabbit is jumping"])
SHA_A, SHA_B, SHA_C = "aa" * 32, "bb" * 32, "cc" * 32


class FakeClient:
    """A JSON-API shaped engine fake with a scriptable answer (the JAX
    tests' fake): ``flip_hash`` returns a fresh hash per wait, ``echo_trace``
    echoes (True), garbles (False) or omits (None) the trace id."""

    def __init__(self, *, fingerprint="fp-tiny", sha=SHA_A, src_err=0.0, status="done",
                 psnr=30.0, ssim=0.9, store_hit=True, store_source="memory",
                 echo_trace=True, reject_bad=True, flip_hash=False, dead=False, metrics=None):
        self.fingerprint, self.sha, self.src_err, self.status = fingerprint, sha, src_err, status
        self.psnr, self.ssim, self.store_hit, self.store_source = psnr, ssim, store_hit, store_source
        self.echo_trace, self.reject_bad, self.flip_hash = echo_trace, reject_bad, flip_hash
        self.dead, self._metrics = dead, metrics
        self.submitted, self._pending, self._n = [], {}, 0

    def submit(self, request, *, traceparent=None):
        if self.dead:
            raise ConnectionError("connection refused")
        if self.reject_bad and int(request.get("steps") or 0) > 9000:
            raise RuntimeError(f"/v1/edits failed with HTTP 400: steps={request['steps']} "
                               "not warmed")
        self.submitted.append(dict(request))
        rid = f"rid{len(self.submitted)}"
        self._pending[rid] = (dict(request), traceparent)
        return rid

    def wait(self, rid, *, timeout_s=600.0):
        request, traceparent = self._pending[rid]
        self._n += 1
        rec = {"status": self.status, "src_err": self.src_err,
               "content_sha256": f"{self._n:064x}" if self.flip_hash else self.sha,
               "store_hit": self.store_hit, "store_source": self.store_source}
        if request.get("tenant") == "probe":
            rec["edit_psnr"], rec["edit_ssim"] = self.psnr, self.ssim
        if traceparent is not None and self.echo_trace is not None:
            rec["trace_id"] = traceparent.split("-")[1] if self.echo_trace else "f00d" * 8
        return rec

    def healthz(self):
        return {"status": "ok"}

    def metrics(self):
        if self._metrics is not None:
            return dict(self._metrics)
        return {"spec_fingerprint": self.fingerprint}


def _clock():
    counter = itertools.count()
    return lambda: 0.125 * next(counter)


def _suites(**kw):
    return (jprobe.ProbeSuite(dict(CANARY), clock=_clock(), **kw),
            tprobe.ProbeSuite(dict(CANARY), clock=_clock(), **kw))


# (probe, fake settings, suite settings): the JAX tests' cases
SINGLE_CASES = [
    ("cached_replay", {}, {}),
    ("cached_replay", dict(src_err=1e-9), {}),
    ("cached_replay", dict(status="error"), {}),
    ("determinism", {}, {}),
    ("determinism", dict(flip_hash=True), {}),
    ("determinism", dict(sha=""), {}),
    ("golden_quality", {}, {}),
    ("golden_quality", dict(psnr=2.0), {}),
    ("golden_quality", dict(ssim=1.5), {}),
    ("golden_quality", dict(psnr=None, ssim=None), {}),
    ("golden_quality", dict(psnr=30.0), dict(psnr_band=(35.0, 40.0))),
    ("contract_unwarmed_steps", {}, {}),
    ("contract_unwarmed_steps", dict(reject_bad=False), {}),
    ("contract_traceparent", {}, {}),
    ("contract_traceparent", dict(echo_trace=False), {}),
    ("contract_traceparent", dict(echo_trace=None), {}),
]


@pytest.mark.parametrize("probe, fake, suite_kw", SINGLE_CASES)
def test_single_probe_records_equal_jax(probe, fake, suite_kw):
    ja, tb = _suites(**suite_kw)
    ca, cb = FakeClient(**fake), FakeClient(**fake)
    ra = getattr(ja, f"probe_{probe}")(ca, "replica0")
    rb = getattr(tb, f"probe_{probe}")(cb, "replica0")
    assert ra == rb
    assert list(rb) == list(tprobe.PROBE_EVENT_FIELDS)
    assert ca.submitted == cb.submitted
    assert all(r["tenant"] == tprobe.PROBE_TENANT and r["seed"] == 8888 for r in cb.submitted)


@pytest.mark.parametrize("dst", [
    dict(sha=SHA_A, store_hit=True, store_source="disk"),
    dict(sha=SHA_A, store_hit=False, store_source=None),
    dict(sha=SHA_B, store_hit=True, store_source="disk"),
])
def test_store_roundtrip_records_equal_jax(dst):
    ja, tb = _suites()
    ra = ja.probe_store_roundtrip(FakeClient(sha=SHA_A), FakeClient(**dst), "r0->r1")
    rb = tb.probe_store_roundtrip(FakeClient(sha=SHA_A), FakeClient(**dst), "r0->r1")
    assert ra == rb


@pytest.mark.parametrize("fake", [{}, dict(dead=True), dict(src_err=0.5, flip_hash=True)])
def test_suite_run_equals_jax(fake):
    """The whole single-target suite, in PROBE_KINDS order; a dead target
    gives one failed record a probe, never an exception; the canary is
    pinned to the probe lane with its seed whatever the caller passed."""
    ja, tb = _suites()
    assert tb.canary == ja.canary
    assert tb.canary["tenant"] == "probe" and tb.canary["save_name"] == "probe_canary"
    pinned = tprobe.ProbeSuite(dict(CANARY, seed=7, save_name="x", tenant="evil"))
    assert (pinned.canary["seed"], pinned.canary["save_name"], pinned.canary["tenant"]) == (
        7, "x", "probe")
    ra, rb = ja.run(FakeClient(**fake), "replica0"), tb.run(FakeClient(**fake), "replica0")
    assert ra == rb
    assert [r["probe"] for r in rb] == [k for k in tprobe.PROBE_KINDS if k != "store_roundtrip"]


AUDIT_CASES = [
    (None, [("fp", "replica0", SHA_A), ("fp", "replica1", SHA_A), ("fp", "replica2", SHA_B)]),
    (None, [("fp", "replica0", SHA_A), ("fp", "replica1", SHA_B)]),          # earliest wins
    (None, [("", "replica0", SHA_A), ("fp", "replica0", "")]),               # nothing to audit
    ({"fp": SHA_C}, [("fp", "replica0", SHA_A), ("fp", "replica1", SHA_A)]),  # seed beats all
    ({"fp": SHA_C}, [("fp", "replica0", SHA_A), ("fp", "replica1", SHA_A),
                     ("fp", "replica2", SHA_C)]),                             # named holder
    (None, [("fp", "replica0", SHA_A), ("fp", "replica1", SHA_B), ("fp", "replica1", SHA_A),
            ("fq", "replica0", SHA_C), ("fq", "router", SHA_B)]),            # per fingerprint
]


@pytest.mark.parametrize("reference, observations", AUDIT_CASES)
def test_answer_audit_equals_jax(reference, observations):
    a, b = jprobe.AnswerAudit(reference), tprobe.AnswerAudit(reference)
    for obs in observations:
        a.observe(*obs)
        b.observe(*obs)
    assert a.observed == b.observed
    assert a.divergences() == b.divergences()
    assert a.divergent_targets() == b.divergent_targets()
    assert a.summary() == b.summary()
    assert all(list(d) == list(tprobe.PROBE_AUDIT_FIELDS) for d in b.divergences())


def test_probe_schemas_equal_jax():
    assert tprobe.PROBE_EVENT_FIELDS == jprobe.PROBE_EVENT_FIELDS
    assert tprobe.PROBE_AUDIT_FIELDS == jprobe.PROBE_AUDIT_FIELDS
    assert tprobe.PROBE_KINDS == jprobe.PROBE_KINDS
    assert tprobe.PROBE_TENANT == jprobe.PROBE_TENANT


def _faked(mod, fakes, **kw):
    prober = mod.FleetProber([(n, "http://invalid.invalid:1") for n in fakes], dict(CANARY),
                             interval_s=3600.0, clock=_clock(), **kw)
    for tgt in prober.targets:
        tgt.client = fakes[tgt.name]
    return prober


def _fleet(router_sha=SHA_A, wrong=SHA_B):
    router_metrics = {"replicas": {"replica0": {"spec_fingerprint": "fp-tiny"},
                                   "replica1": {"spec_fingerprint": "fp-tiny"}}}
    return {"replica0": FakeClient(sha=SHA_A), "replica1": FakeClient(sha=wrong),
            "router": FakeClient(sha=router_sha, metrics=router_metrics)}


class Recorder:
    def __init__(self):
        self.pushes, self.triggers, self.registered = [], [], []

    def set_probe_status(self, status, divergences=()):
        self.pushes.append((dict(status), list(divergences)))

    def register_target(self, name, probe):
        self.registered.append(name)

    def trigger(self, kind, detail="", **context):
        self.triggers.append((kind, detail, context))


@pytest.mark.parametrize("router_sha, wrong", [(SHA_A, SHA_B), (SHA_B, SHA_A), (SHA_A, SHA_A)])
def test_fleet_prober_rounds_equal_jax(router_sha, wrong, tmp_path):
    """Three ``run_once`` rounds over the same faked fleet on both packages
    (a wrong replica, a wrong ROUTER that is audited but never quarantined,
    a healthy fleet; then the wrong answer corrected): equal summaries,
    verdicts, history, tsdb series, signal pushes, incident triggers and
    ``probe`` / ``probe_audit`` ledger events."""
    from videop2p_tpu.obs import RunLedger as JaxLedger
    from videop2p_tpu.obs import read_ledger as jax_read
    from videop2p_tpu_torch.obs import RunLedger, read_ledger

    out = []
    for mod, ledger_cls, read, name in ((jprober, JaxLedger, jax_read, "jax"),
                                        (tprober, RunLedger, read_ledger, "port")):
        fakes, rec = _fleet(router_sha, wrong), Recorder()
        path = str(tmp_path / f"{name}.jsonl")
        with ledger_cls(path) as led:
            prober = _faked(mod, fakes, ledger=led, signals=rec, incidents=rec)
            rounds = [prober.run_once(now=1.0), prober.probe_status()]
            rounds += [prober.run_once(now=2.0), prober.probe_status()]
            fakes["replica1"].sha = fakes["router"].sha = SHA_A
            rounds += [prober.run_once(now=3.0), prober.probe_status(), prober.stats()]
        events = [{k: v for k, v in e.items() if k != "t"} for e in read(path)
                  if e["event"] in ("probe", "probe_audit")]
        series = {k: prober.tsdb.series(k[0], dict(k[1])) for k in prober.tsdb.keys()}
        out.append((rounds, list(prober.history), events, series, rec.pushes, rec.triggers,
                    rec.registered))
    assert out[0] == out[1]
    rounds = out[1][0]
    if wrong == SHA_B:
        assert rounds[1]["replica1"] == "quarantine"
    if router_sha == SHA_B:
        assert rounds[1]["router"] == "pass" and rounds[0]["divergent"] == ["router"]
    assert rounds[5] == {"replica0": "pass", "replica1": "pass", "router": "pass"}


def test_prober_cadence_final_round_and_interim_verdict():
    """A round run before the loop counts as its first (the next is due an
    interval later); ``stop(final_round=True)`` runs a round only when none
    completed (JAX's rule); and the router's suite runs under the verdicts
    its replicas' answers already give in that round."""
    seen = []

    class Router(FakeClient):
        def submit(self, request, *, traceparent=None):
            seen.append(dict(prober.probe_status()))
            return super().submit(request, traceparent=traceparent)

    fakes = _fleet()
    fakes["router"] = Router(sha=SHA_A, metrics={"spec_fingerprint": "fp-tiny"})
    prober = _faked(tprober, fakes)
    prober.run_once(now=1.0)
    assert seen and all(s["replica1"] == "quarantine" for s in seen)
    prober.start()
    prober.stop(final_round=True)
    assert prober.rounds == 1  # the loop waited out its interval; no final round
    idle = _faked(tprober, _fleet())
    idle.stop(final_round=True)
    assert idle.rounds == 1 and idle.probe_status()["replica1"] == "quarantine"


# ------------------------------------------------- a tiny fleet on the CPU -----


def test_tiny_fleet_wrong_replica_quarantined_routed_around_and_lifted(tmp_path):
    """Two in-process replicas over one tiny ``ProgramSet``, replica 1
    with ``wrong:*`` (HTTP 200, healthy, deterministic, wrong bytes). A
    probe round anchored on replica 0's known answer: replica 1's own
    probes all pass, the audit quarantines it, the router's canaries and a
    routed request land on replica 0 (bit-equal to the known answer), the
    router's /healthz shows the verdict. With the fault removed, the next
    round lifts the quarantine."""
    from videop2p_tpu_torch.serve import (
        EngineClient,
        ProgramSet,
        ProgramSpec,
        ReplicaSupervisor,
        Router,
        RouterServer,
    )

    spec = ProgramSpec(tiny=True, width=16, video_len=2, steps=2)
    programs = ProgramSet(spec, device="cpu")
    sup = ReplicaSupervisor(spec, 2, out_dir=str(tmp_path / "fleet"), programs=programs,
                            warm_prompts=CANARY["prompts"], faults={1: "wrong:*"},
                            engine_kwargs=dict(device="cpu"))
    sup.start()
    router = Router(sup.urls, probe_ttl_s=0.05)
    server = RouterServer(router).start()
    try:
        suite = tprobe.ProbeSuite(dict(CANARY))
        known = EngineClient(sup.urls[0]).wait(
            EngineClient(sup.urls[0]).submit(suite.canary), timeout_s=120.0)
        assert known["status"] == "done"
        fp = EngineClient(sup.urls[0]).metrics()["spec_fingerprint"]
        prober = tprober.FleetProber(
            [(r.name, r.url) for r in sup.replicas] + [("router", server.url)],
            dict(CANARY), interval_s=3600.0, http_timeout_s=120.0, wait_s=120.0,
            reference={fp: known["content_sha256"]})
        router.set_probe_status_provider(prober.probe_status)
        # the router's canaries run under the replicas' verdicts of the
        # round: routed around replica 1, the router's answer agrees
        summary = prober.run_once()
        assert summary["divergent"] == ["replica1"]
        assert prober.probe_status() == {"replica0": "fail", "replica1": "quarantine",
                                         "router": "pass"}
        own = [r for kind, r in prober.history if kind == "probe" and r["target"] == "replica1"]
        assert len(own) == 5 and all(r["ok"] for r in own)
        assert all(r["ok"] for kind, r in prober.history
                   if r.get("target") in ("replica0", "router"))
        audit = [r for kind, r in prober.history if kind == "probe_audit"]
        assert audit[0]["divergent"] == "replica1" and audit[0]["hash_a"] == known[
            "content_sha256"]
        health = EngineClient(server.url).healthz()
        assert health["replicas"]["replica1"]["probe_status"] == "quarantine"
        assert health["replicas"]["replica1"]["quarantined"] is True
        client = EngineClient(server.url)
        routed = client.wait(client.submit(dict(suite.canary)), timeout_s=120.0)
        assert routed["replica"] == "replica0"
        assert routed["content_sha256"] == known["content_sha256"]
        assert router.health_record()["quarantined"] >= 1
        # the fault lifted: replica 1 answers right again, the quarantine lifts
        sup.replicas[1].engine.faults.wrong = ()
        prober.run_once()
        assert prober.probe_status()["replica1"] == "pass"
        assert prober.audit.summary()["ok"]
        assert EngineClient(server.url).healthz()["replicas"]["replica1"]["quarantined"] is False
    finally:
        server.close()
        sup.stop()
    assert os.path.isdir(str(tmp_path / "fleet" / "replica1"))
