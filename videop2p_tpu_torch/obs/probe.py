"""The known-answer probes' schema, as far as the engine reads it (the
part of ``videop2p_tpu/obs/probe.py`` the serving engine needs).

The prober itself (``AnswerAudit``, ``ProbeSuite``) waits for the fleet
port. What the engine needs now is :data:`PROBE_TENANT`, the reserved
tenant lane for which it computes golden-quality metrics (PSNR and SSIM of
the edit against the reconstruction), and the probe event's field schema.
"""

from __future__ import annotations

__all__ = ["PROBE_EVENT_FIELDS", "PROBE_TENANT"]

# every `probe` ledger event carries exactly these fields; `content_sha256`
# is "" for probes with no answer to hash (e.g. the 400-contract probe)
PROBE_EVENT_FIELDS = ("probe", "target", "ok", "latency_s",
                      "content_sha256", "detail")

# the reserved low-priority probe lane: the engine computes golden-quality
# metrics ONLY for this tenant (one string comparison is the whole cost of
# the probe plane on a request that is not a probe)
PROBE_TENANT = "probe"
