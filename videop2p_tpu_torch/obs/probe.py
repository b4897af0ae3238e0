"""Known-answer probing: the correctness plane's synthetic monitors (port
of ``videop2p_tpu/obs/probe.py``).

Obs Layers 1–8 *self-report*: a replica serving wrong bytes with HTTP 200
is "healthy" to ``/healthz``, the router, the burn signals and the cost
plane alike. This module is Layer 9 — black-box probes that continuously
prove the fleet returns *correct* answers, exploiting the properties the
editing contract pins by construction:

  * **cached_replay** — the cached replay must reproduce the source
    stream bit-exactly: the canary edit's ``src_err`` must be exactly 0;
  * **determinism** — the same request submitted twice must return a
    bit-identical video tensor (compared by the engine's per-request
    ``content_sha256`` — no artifact re-hashing);
  * **golden_quality** — the canary edit's PSNR/SSIM (computed by the
    engine ONLY for the reserved :data:`PROBE_TENANT` lane — probe-off
    requests pay one tenant-string comparison and nothing else) must sit
    inside a pinned band;
  * **store_roundtrip** — an inversion persisted by one replica must be
    a store hit on another, with an identical content hash;
  * **contract_unwarmed_steps** — a request for steps the engine never
    warmed must be REJECTED with HTTP 400, not served cold;
  * **contract_traceparent** — a submitted W3C ``traceparent`` must be
    echoed as the request's ``trace_id`` (tracing-off replicas pass with
    a detail note — absence of tracing is a configuration, not a bug).

Every probe produces one ``probe`` ledger event pinned by
:data:`PROBE_EVENT_FIELDS`. The :class:`AnswerAudit` is the fleet-wide
correctness invariant: content hashes for the same canary request, keyed
by ProgramSpec fingerprint, must agree across replicas and across
restarts — a divergence is flagged with the pair of replica names and
hashes (``probe_audit`` events, :data:`PROBE_AUDIT_FIELDS`), and the
divergent replica is the quarantine candidate the router routes around
(``serve/prober.py`` closes that loop).

This module never opens sockets itself: probes run against any client
exposing the JSON-API surface (``submit``/``wait``/``metrics``) —
``serve/client.py``'s :class:`EngineClient` in production, plain fakes in
the unit tests. Stdlib only.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "PROBE_EVENT_FIELDS",
    "PROBE_AUDIT_FIELDS",
    "PROBE_KINDS",
    "PROBE_TENANT",
    "AnswerAudit",
    "ProbeSuite",
]

# ledger-event schema pins: every `probe`
# event carries exactly these fields — obs/history.py's probe section and
# tools/probe_report.py key on them. `content_sha256` is "" for probes
# with no answer to hash (e.g. the 400-contract probe).
PROBE_EVENT_FIELDS = ("probe", "target", "ok", "latency_s",
                      "content_sha256", "detail")

# one `probe_audit` event per divergence: the fleet invariant violation,
# with the agreeing reference replica/hash and the divergent pair member.
PROBE_AUDIT_FIELDS = ("fingerprint", "targets", "hashes", "divergent",
                      "replica_a", "hash_a", "replica_b", "hash_b")

# the taxonomy, in suite execution order (docs/OBSERVABILITY.md Layer 9)
PROBE_KINDS = (
    "cached_replay",
    "determinism",
    "golden_quality",
    "store_roundtrip",
    "contract_unwarmed_steps",
    "contract_traceparent",
)

# the reserved low-priority probe lane: canaries ride the fair scheduler
# as their own DRR tenant so they never starve real traffic, and the
# engine computes golden-quality metrics ONLY for this tenant (the one
# attribute check that is the entire probe-off hot-path overhead).
PROBE_TENANT = "probe"


class AnswerAudit:
    """Cross-replica answer agreement, keyed by ProgramSpec fingerprint.

    The known answer may be *seeded* (``reference={fingerprint: sha}``
    from a prior healthy run — the across-restarts anchor); without a
    seed the reference is the majority hash among observations (ties
    broken toward the earliest-observed hash, so a standing fleet's
    answer wins over a later divergent restart).
    """

    def __init__(self, reference: Optional[Dict[str, str]] = None):
        self.reference = dict(reference or {})
        # fingerprint -> {target: sha}, insertion-ordered on both levels
        self.observed: Dict[str, Dict[str, str]] = {}

    def observe(self, fingerprint: str, target: str, sha: str) -> None:
        """Record one target's canary answer hash; empty hashes are
        ignored (a failed probe has no answer to audit)."""
        if not fingerprint or not sha:
            return
        self.observed.setdefault(str(fingerprint), {})[str(target)] = str(sha)

    def _reference_for(self, fp: str) -> Tuple[str, str]:
        """(holder, hash) of the reference answer for a fingerprint."""
        seen = self.observed.get(fp, {})
        ref = self.reference.get(fp)
        if ref is not None:
            holder = next((t for t, h in seen.items() if h == ref),
                          "reference")
            return holder, ref
        # majority vote, earliest-observed hash wins ties
        counts: Dict[str, int] = {}
        for h in seen.values():
            counts[h] = counts.get(h, 0) + 1
        best = max(counts.items(),
                   key=lambda kv: (kv[1], -list(counts).index(kv[0])))
        holder = next(t for t, h in seen.items() if h == best[0])
        return holder, best[0]

    def divergences(self) -> List[Dict[str, Any]]:
        """One :data:`PROBE_AUDIT_FIELDS` record per divergent target —
        empty when every observed hash agrees with its reference."""
        out: List[Dict[str, Any]] = []
        for fp, seen in self.observed.items():
            if not seen:
                continue
            holder, ref = self._reference_for(fp)
            for target, sha in seen.items():
                if sha != ref:
                    out.append({
                        "fingerprint": fp,
                        "targets": len(seen),
                        "hashes": len(set(seen.values()) | {ref}),
                        "divergent": target,
                        "replica_a": holder,
                        "hash_a": ref,
                        "replica_b": target,
                        "hash_b": sha,
                    })
        return out

    def divergent_targets(self) -> List[str]:
        return sorted({d["divergent"] for d in self.divergences()})

    def summary(self) -> Dict[str, Any]:
        divs = self.divergences()
        return {
            "fingerprints": len(self.observed),
            "targets": len({t for seen in self.observed.values()
                            for t in seen}),
            "divergences": len(divs),
            "divergent": sorted({d["divergent"] for d in divs}),
            "ok": not divs,
        }


class ProbeSuite:
    """The declarative known-answer suite against one JSON-API target.

    ``canary`` is a complete edit-request dict for a tiny clip the target
    is warm for (``image_path``/``prompts``/``steps``/``seed``); the
    suite forces it onto the :data:`PROBE_TENANT` lane and a fixed seed
    so every submission is the *same* known-answer request.
    """

    def __init__(
        self,
        canary: Dict[str, Any],
        *,
        bad_steps: int = 99991,
        psnr_band: Tuple[float, Optional[float]] = (3.0, None),
        ssim_band: Tuple[float, float] = (-1.0, 1.01),
        wait_s: float = 600.0,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.canary = dict(canary)
        self.canary.setdefault("seed", 8888)
        self.canary.setdefault("save_name", "probe_canary")
        self.canary["tenant"] = PROBE_TENANT
        self.bad_steps = int(bad_steps)
        self.psnr_band = psnr_band
        self.ssim_band = ssim_band
        self.wait_s = float(wait_s)
        self.clock = clock

    # ---- plumbing --------------------------------------------------------

    def _record(self, probe: str, target: str, ok: bool, latency_s: float,
                sha: Optional[str], detail: str) -> Dict[str, Any]:
        return {
            "probe": probe,
            "target": str(target),
            "ok": bool(ok),
            "latency_s": round(float(latency_s), 4),
            "content_sha256": sha or "",
            "detail": str(detail),
        }

    def _submit_wait(self, client, overrides: Optional[Dict[str, Any]] = None,
                     traceparent: Optional[str] = None) -> Dict[str, Any]:
        req = dict(self.canary)
        req.update(overrides or {})
        if traceparent is not None:
            rid = client.submit(req, traceparent=traceparent)
        else:
            rid = client.submit(req)
        return client.wait(rid, timeout_s=self.wait_s)

    # ---- the probes ------------------------------------------------------

    def probe_cached_replay(self, client, target: str) -> Dict[str, Any]:
        """The paper's own invariant: the cached replay of the canary's
        source stream must be bit-exact — ``src_err`` exactly 0.0."""
        t0 = self.clock()
        rec = self._submit_wait(client)
        dt = self.clock() - t0
        status = rec.get("status")
        src_err = rec.get("src_err")
        ok = status == "done" and src_err == 0.0
        return self._record(
            "cached_replay", target, ok, dt, rec.get("content_sha256"),
            f"status={status} src_err={src_err}")

    def probe_determinism(self, client, target: str) -> Dict[str, Any]:
        """Same request twice → bit-identical answer (by content hash)."""
        t0 = self.clock()
        a = self._submit_wait(client)
        b = self._submit_wait(client)
        dt = self.clock() - t0
        ha, hb = a.get("content_sha256"), b.get("content_sha256")
        done = a.get("status") == "done" and b.get("status") == "done"
        ok = done and bool(ha) and ha == hb
        detail = ("bit-identical" if ok else
                  f"status=({a.get('status')},{b.get('status')}) "
                  f"hashes=({ha},{hb})")
        return self._record("determinism", target, ok, dt, ha, detail)

    def probe_golden_quality(self, client, target: str) -> Dict[str, Any]:
        """Canary edit PSNR/SSIM inside the pinned band (the engine
        computes both only for the probe tenant)."""
        t0 = self.clock()
        rec = self._submit_wait(client)
        dt = self.clock() - t0
        p, s = rec.get("edit_psnr"), rec.get("edit_ssim")
        lo, hi = self.psnr_band
        slo, shi = self.ssim_band
        ok = (rec.get("status") == "done" and p is not None and s is not None
              and p >= lo and (hi is None or p <= hi)
              and slo <= s <= shi)
        return self._record(
            "golden_quality", target, ok, dt, rec.get("content_sha256"),
            f"psnr={p} ssim={s} band=[{lo},{hi if hi is not None else 'inf'}]")

    def probe_store_roundtrip(self, client_src, client_dst,
                              target: str) -> Dict[str, Any]:
        """Invert via one replica, then the same canary on another must be
        a store hit (memory or the shared disk layer) with an identical
        content hash — the cross-replica cache invariant."""
        t0 = self.clock()
        a = self._submit_wait(client_src)
        b = self._submit_wait(client_dst)
        dt = self.clock() - t0
        source = b.get("store_source")
        ha, hb = a.get("content_sha256"), b.get("content_sha256")
        ok = (a.get("status") == "done" and b.get("status") == "done"
              and bool(b.get("store_hit"))
              and source in ("memory", "disk")
              and bool(ha) and ha == hb)
        return self._record(
            "store_roundtrip", target, ok, dt, hb,
            f"source={source} hit={b.get('store_hit')} "
            f"match={bool(ha) and ha == hb}")

    def probe_contract_unwarmed_steps(self, client,
                                      target: str) -> Dict[str, Any]:
        """A request for steps outside the warm buckets must be rejected
        with HTTP 400 at admission — never served via a cold compile."""
        t0 = self.clock()
        try:
            self._submit_wait(client, overrides={"steps": self.bad_steps})
        except (RuntimeError, ValueError) as e:
            dt = self.clock() - t0
            msg = str(e)
            ok = "HTTP 400" in msg or "not warmed" in msg or "warm" in msg
            return self._record("contract_unwarmed_steps", target, ok, dt,
                                None, msg[:200])
        dt = self.clock() - t0
        return self._record(
            "contract_unwarmed_steps", target, False, dt, None,
            f"steps={self.bad_steps} was ADMITTED — admission contract broken")

    def probe_contract_traceparent(self, client, target: str,
                                   traceparent: Optional[str] = None,
                                   ) -> Dict[str, Any]:
        """A submitted traceparent must be echoed as the request's
        trace_id; a tracing-off target passes with a detail note."""
        if traceparent is None:
            # deterministic, distinctive, and valid W3C shape — no
            # dependency on obs/spans' entropy source
            traceparent = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
        want = traceparent.split("-")[1]
        t0 = self.clock()
        rec = self._submit_wait(client, traceparent=traceparent)
        dt = self.clock() - t0
        tid = rec.get("trace_id")
        if tid is None:
            ok, detail = rec.get("status") == "done", "tracing off (pass)"
        else:
            ok = rec.get("status") == "done" and tid == want
            detail = f"sent={want} echoed={tid}"
        return self._record("contract_traceparent", target, ok, dt,
                            rec.get("content_sha256"), detail)

    # ---- suite driver ----------------------------------------------------

    def run(self, client, target: str) -> List[Dict[str, Any]]:
        """Every single-target probe, in :data:`PROBE_KINDS` order
        (``store_roundtrip`` is fleet-scope — the prober schedules it
        across replica pairs). A probe that raises becomes a failed
        record, never an exception: probing must not take the prober
        down with the replica."""
        out: List[Dict[str, Any]] = []
        for kind, fn in (
            ("cached_replay", self.probe_cached_replay),
            ("determinism", self.probe_determinism),
            ("golden_quality", self.probe_golden_quality),
            ("contract_unwarmed_steps", self.probe_contract_unwarmed_steps),
            ("contract_traceparent", self.probe_contract_traceparent),
        ):
            t0 = self.clock()
            try:
                out.append(fn(client, target))
            except Exception as e:  # noqa: BLE001 — a dead target is a failed probe
                out.append(self._record(
                    kind, target, False, self.clock() - t0, None,
                    f"{type(e).__name__}: {e}"))
        return out
