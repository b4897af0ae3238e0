"""Active-probing loop: the correctness plane's scheduler (port of
``videop2p_tpu/serve/prober.py``).

``obs/probe.py`` defines WHAT a known-answer probe is; this module is the
WHEN and the WHERE — a :class:`FleetProber` with the same daemon shape as
:class:`~videop2p_tpu_torch.serve.collector.FleetCollector`'s:

  * runs the :class:`~videop2p_tpu_torch.obs.probe.ProbeSuite` against every
    replica (and the router, which is probed like any other target — a
    routing bug that serves wrong bytes is caught the same way) on a
    deterministic interval, under the reserved low-priority
    :data:`~videop2p_tpu_torch.obs.probe.PROBE_TENANT` DRR lane so canaries
    never starve real traffic;
  * schedules the fleet-scope **store round-trip** probe around the
    replica ring (invert via replica ``i``, demand a store hit on
    ``i+1``);
  * feeds every result into the tsdb as ``probe_success`` /
    ``probe_latency`` series (labels ``{target, probe}``) next to the
    collector's scraped gauges, so
    :class:`~videop2p_tpu_torch.obs.signals.SignalEngine` derives probe-failure
    burn from the same store;
  * runs the fleet-wide **answer audit**
    (:class:`~videop2p_tpu_torch.obs.probe.AnswerAudit`): canary content
    hashes keyed by ProgramSpec fingerprint must agree across replicas
    and across restarts; a divergence emits one ``probe_audit`` ledger
    event with the pair of replica names + hashes, fires the
    ``probe_failed`` incident trigger, and flips the divergent target's
    status to ``quarantine`` — which :meth:`probe_status` serves to the
    router as its pluggable verdict provider. Quarantine lifts by the
    same mechanism: a later round whose hash agrees again clears it. The
    router's suite runs under the verdicts its replicas' answers already
    give in the same round (:meth:`_interim_verdict`), so its canaries are
    routed as client traffic is.

Injected clocks, bounded history for the loadgen drain, ``run_once`` for
deterministic tests — the collector's conventions throughout.

Stdlib only, apart from the port's own modules.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from videop2p_tpu_torch.obs.probe import (
    PROBE_AUDIT_FIELDS,
    PROBE_EVENT_FIELDS,
    AnswerAudit,
    ProbeSuite,
)
from videop2p_tpu_torch.obs.signals import S_PROBE_LATENCY, S_PROBE_SUCCESS
from videop2p_tpu_torch.obs.tsdb import TimeSeriesStore
from videop2p_tpu_torch.serve.client import EngineClient

__all__ = ["FleetProber"]


class _ProbeTarget:
    """One probed surface: a fail-fast client + running tallies."""

    def __init__(self, name: str, url: str, http_timeout_s: float):
        self.name = name
        self.url = url.rstrip("/")
        self.client = EngineClient(url, timeout_s=http_timeout_s, retries=0)
        self.probes = 0
        self.failures = 0


class FleetProber:
    """Schedule the known-answer suite over a fleet and audit answers.

    ``targets`` is ``[(name, url), ...]`` — replica names should match
    the router's (``replica0``…) so quarantine verdicts map onto its
    views; a target named ``router_name`` is probed but exempt from
    quarantine (you cannot route around the router). ``reference`` seeds
    the audit's known answers (``{fingerprint: sha}`` from a prior
    healthy run — the across-restarts anchor); without it the majority
    hash is the reference.
    """

    def __init__(
        self,
        targets: Sequence[Tuple[str, str]],
        canary: Dict[str, Any],
        *,
        tsdb: Optional[TimeSeriesStore] = None,
        capacity: int = 512,
        interval_s: float = 5.0,
        http_timeout_s: float = 30.0,
        wait_s: float = 600.0,
        ledger: Any = None,
        router_name: str = "router",
        reference: Optional[Dict[str, str]] = None,
        suite_kwargs: Optional[Dict[str, Any]] = None,
        signals: Any = None,
        clock: Callable[[], float] = time.perf_counter,
        incidents: Any = None,
    ):
        self.targets = [_ProbeTarget(n, u, http_timeout_s)
                        for n, u in targets]
        self.tsdb = tsdb if tsdb is not None else TimeSeriesStore(capacity)
        self.interval_s = float(interval_s)
        self.ledger = ledger
        self.router_name = str(router_name)
        self.suite = ProbeSuite(canary, wait_s=wait_s, clock=clock,
                                **(suite_kwargs or {}))
        self.audit = AnswerAudit(reference)
        self.signals = signals
        self.clock = clock
        self.incidents = incidents
        self.rounds = 0
        self.probes = 0
        self.probe_failures = 0
        self.divergences = 0
        # per-target verdicts served to the router: "pass" | "fail" |
        # "quarantine" — recomputed every round, so quarantine lifts as
        # soon as a target's answer agrees with the fleet again
        self._status: Dict[str, str] = {}
        # (fingerprint, target, hash) triples already reported — a
        # persistent divergence is one incident, not one per round
        self._seen_divergences: set = set()
        # every probe/audit record, bounded — loadgen opens its ledger
        # only at end-of-run, so it drains this buffer into `probe` /
        # `probe_audit` events instead of passing a live ledger
        self.history: deque = deque(maxlen=4096)
        self._lock = threading.Lock()
        # when the last round ended (host clock): the loop's cadence
        self._last_round_s: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if incidents is not None:
            for tgt in self.targets:
                incidents.register_target(
                    f"probe:{tgt.name}",
                    (lambda c: lambda: {"healthz": c.healthz(),
                                        "metrics": c.metrics()})(tgt.client))

    # ---- pieces ----------------------------------------------------------

    def _fingerprint(self, target: _ProbeTarget) -> str:
        """The target's ProgramSpec fingerprint — the audit key. The
        router's ``/metrics`` has no fingerprint of its own; when every
        replica it fronts agrees on one, the router's answers are
        audited under it (a fleet that already disagrees on SPEC is a
        deployment error the audit should not paper over)."""
        try:
            m = target.client.metrics()
        except Exception:  # noqa: BLE001 — unreachable targets audit nothing
            return ""
        fp = m.get("spec_fingerprint")
        if fp:
            return str(fp)
        fps = {str(r.get("spec_fingerprint"))
               for r in (m.get("replicas") or {}).values()
               if isinstance(r, dict) and r.get("spec_fingerprint")}
        return fps.pop() if len(fps) == 1 else ""

    def _emit_probe(self, rec: Dict[str, Any], t: float) -> None:
        self.probes += 1
        if not rec.get("ok"):
            self.probe_failures += 1
        if self.ledger is not None:
            self.ledger.event(
                "probe", **{k: rec.get(k) for k in PROBE_EVENT_FIELDS})
        self.history.append(("probe", dict(rec)))
        labels = {"target": rec["target"], "probe": rec["probe"]}
        self.tsdb.add(S_PROBE_SUCCESS, t, 1.0 if rec.get("ok") else 0.0,
                      labels)
        self.tsdb.add(S_PROBE_LATENCY, t, float(rec.get("latency_s") or 0.0),
                      labels)

    def _emit_audit(self, div: Dict[str, Any]) -> None:
        self.divergences += 1
        rec = {k: div.get(k) for k in PROBE_AUDIT_FIELDS}
        if self.ledger is not None:
            self.ledger.event("probe_audit", **rec)
        self.history.append(("probe_audit", rec))
        if self.incidents is not None:
            self.incidents.trigger(
                "probe_failed",
                detail=(f"answer audit: {div.get('divergent')} diverges "
                        f"from {div.get('replica_a')} "
                        f"({str(div.get('hash_b'))[:12]} != "
                        f"{str(div.get('hash_a'))[:12]})"),
                canary=dict(self.suite.canary),
                fingerprint=div.get("fingerprint"),
                hash_a=div.get("hash_a"), hash_b=div.get("hash_b"),
                replica_a=div.get("replica_a"),
                replica_b=div.get("replica_b"))

    def _interim_verdict(self, per_target_ok: Dict[str, bool]) -> None:
        """Before the router's suite: quarantine the replicas whose answers
        this round already diverge (and lift the quarantine of those that
        agree again), so the router's canaries are routed as client
        traffic is under those verdicts. JAX's prober takes every verdict at
        the round's end; then a two-replica router's canaries can land on
        the wrong replica, or the determinism probe's two submissions on
        different replicas. The round's events and its final verdicts are
        JAX's either way."""
        flagged = {d["divergent"] for d in self.audit.divergences()}
        with self._lock:
            for name, ok in per_target_ok.items():
                if name in flagged:
                    self._status[name] = "quarantine"
                elif self._status.get(name) == "quarantine":
                    self._status[name] = "pass" if ok else "fail"

    # ---- one pass --------------------------------------------------------

    def run_once(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One full probing round at time ``now``: the suite per target,
        the store round-trip around the replica ring, then the answer
        audit + status recomputation. Returns the audit summary.
        Timestamps get a tiny skew per sample so series stay strictly
        monotonic at one shared ``now``."""
        t = self.clock() if now is None else float(now)
        skew = 0
        per_target_ok: Dict[str, bool] = {}
        for tgt in self.targets:
            if tgt.name == self.router_name:
                self._interim_verdict(per_target_ok)
            records = self.suite.run(tgt.client, tgt.name)
            tgt.probes += len(records)
            for rec in records:
                self._emit_probe(rec, t + skew * 1e-6)
                skew += 1
            failed = [r for r in records if not r.get("ok")]
            tgt.failures += len(failed)
            per_target_ok[tgt.name] = not failed
            # the audit observes the determinism probe's hash — the one
            # answer proven self-consistent this round
            sha = next((r.get("content_sha256") for r in records
                        if r["probe"] == "determinism" and r.get("ok")), "")
            self.audit.observe(self._fingerprint(tgt), tgt.name, sha)
            if failed and self.incidents is not None:
                worst = failed[0]
                self.incidents.trigger(
                    "probe_failed",
                    detail=(f"{worst['probe']} failed on {tgt.name}: "
                            f"{worst['detail']}"),
                    canary=dict(self.suite.canary),
                    target=tgt.name,
                    failed=[r["probe"] for r in failed])
        # fleet-scope store round-trip around the replica ring
        replicas = [tgt for tgt in self.targets
                    if tgt.name != self.router_name]
        for i, dst in enumerate(replicas):
            if len(replicas) < 2:
                break
            src = replicas[i - 1]
            rec = self.suite.probe_store_roundtrip(
                src.client, dst.client, f"{src.name}->{dst.name}")
            self._emit_probe(rec, t + skew * 1e-6)
            skew += 1
            if not rec.get("ok"):
                per_target_ok[dst.name] = False
                dst.failures += 1
        # the audit verdict: divergent targets are quarantined (the
        # router is probed but never quarantined — there is no routing
        # around the router)
        divergences = self.audit.divergences()
        flagged = set()
        for div in divergences:
            key = (div["fingerprint"], div["divergent"], div["hash_b"])
            if key not in self._seen_divergences:
                self._seen_divergences.add(key)
                self._emit_audit(div)
            flagged.add(div["divergent"])
        with self._lock:
            self._status = {
                name: ("quarantine"
                       if name in flagged and name != self.router_name
                       else ("pass" if per_target_ok.get(name, True)
                             else "fail"))
                for name in [tgt.name for tgt in self.targets]}
        if self.signals is not None:
            try:
                self.signals.set_probe_status(self.probe_status(),
                                              divergences)
            except Exception:  # noqa: BLE001 — signals never break probing
                pass
        self.rounds += 1
        self._last_round_s = time.perf_counter()
        return self.audit.summary()

    # ---- the verdict surface --------------------------------------------

    def probe_status(self) -> Dict[str, str]:
        """The router's pluggable provider: per-target verdicts. Cheap —
        one dict copy under a lock, no I/O."""
        with self._lock:
            return dict(self._status)

    # ---- the loop --------------------------------------------------------

    def run(self, *, duration_s: Optional[float] = None) -> None:
        """A round, then ``interval_s`` of wait, until :meth:`stop` (or
        ``duration_s``); a round run just before the loop (the loadgen's
        first, ahead of its load) counts as the loop's first."""
        deadline = (self.clock() + float(duration_s)
                    if duration_s is not None else None)
        while not self._stop.is_set():
            if self._last_round_s is not None and self._stop.wait(max(
                    self._last_round_s + self.interval_s - time.perf_counter(), 0.0)):
                break
            try:
                self.run_once()
            except Exception:  # noqa: BLE001 — a probing crash must not kill the host
                self._last_round_s = time.perf_counter()
            if deadline is not None and self.clock() >= deadline:
                break

    def start(self) -> "FleetProber":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self.run, name="fleet-prober", daemon=True)
        self._thread.start()
        return self

    def stop(self, *, final_round: bool = False) -> None:
        """Stop the loop; a round in flight completes first (every probe in
        it is bounded by the suite's own timeouts: a round of full-width
        canary edits outlasts JAX's 60 s join). ``final_round`` runs one
        round when none completed."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if final_round and not self.rounds:
            try:
                self.run_once()
            except Exception:  # noqa: BLE001
                pass

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            status = dict(self._status)
        return {
            "targets": len(self.targets),
            "rounds": self.rounds,
            "probes": self.probes,
            "probe_failures": self.probe_failures,
            "divergences": self.divergences,
            "quarantined": sorted(n for n, s in status.items()
                                  if s == "quarantine"),
            "status": status,
            "audit": self.audit.summary(),
        }
