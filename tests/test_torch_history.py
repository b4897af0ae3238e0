"""The port's run history (``obs/history.py``) against the JAX package's:
the rule packs, ``split_runs`` / ``extract_run``, ``RunHistory`` and
``evaluate_rules`` on ledgers written by either package, and on a ledger
of two runs of the port's CLI. Every comparison is exact: both compute the
same host-side arithmetic on the same JSON.
"""

import json
import math

import pytest

import tests.test_torch_parity  # noqa: F401  (one intra-op thread a test process)

PACKS = ("DEFAULT_RULES", "QUALITY_RULES", "COMM_RULES", "TIMING_RULES", "FAULT_RULES",
         "SEAM_RULES", "SLO_RULES", "SEGMENT_RULES", "SIGNAL_RULES", "INCIDENT_RULES",
         "COST_RULES", "PROBE_RULES")


@pytest.mark.parametrize("pack", PACKS)
def test_rule_packs_equal_jax(pack):
    from videop2p_tpu.obs import history as jh

    from videop2p_tpu_torch.obs import history as ph

    got, want = getattr(ph, pack), getattr(jh, pack)
    assert [(r.name, r.metric, r.kind, r.threshold_pct, r.min_abs, r.programs, r.direction)
            for r in got] == [(r.name, r.metric, r.kind, r.threshold_pct, r.min_abs,
                               r.programs, r.direction) for r in want]


def test_program_metrics_equal_jax():
    from videop2p_tpu.obs.introspect import PROGRAM_METRICS as JAX_METRICS

    from videop2p_tpu_torch.obs.history import PROGRAM_METRICS

    assert PROGRAM_METRICS == JAX_METRICS


def _write_runs(led_cls, path: str, **kw) -> None:
    """Two runs on one ledger, the second slower, worse and with a crash:
    phases, quality, execute timing, a memory peak, spans, an SLO report,
    probes, an incident, a serve_health summary."""
    for run, scale in ((0, 1.0), (1, 2.0)):
        led = led_cls(path, **kw)
        led.phase("cached_invert_edit", 2.0 * scale)
        led.phase("vae_decode", 0.25 * scale)
        led.event("quality", program="edit_quality", recon_psnr=30.0 - 4 * run,
                  recon_ssim=0.9 - 0.05 * run, background_psnr=float("inf"),
                  edit_adjacent_psnr=20.0, source_adjacent_psnr=21.0)
        for _ in range(3):
            led.record_execute("cached_invert_edit", 0.01 * scale, 1.5 * scale)
        led.event("memory", note="after_edit", supported=True,
                  devices=[{"device": 0, "peak_bytes_in_use": (8 << 30) * scale}])
        for name, d in (("serve.queue", 0.1), ("serve.dispatch", 1.0 * scale)):
            led.event("span", name=name, duration_s=d, trace_id="t" * 32)
        led.event("slo_report", name="availability", compliant=run == 0,
                  budget_burn=0.5 + run, section="reliability")
        led.event("probe", target="replica0", ok=run == 0, latency_s=2.0 * scale)
        led.event("serve_health", label="serve", error_rate=0.1 * run, shed_rate=0.0,
                  breaker_trips=run, deadline_exceeded=0,
                  tenants={"gold": {"error_rate": 0.0}})
        if run:
            led.event("incident", trigger="crash", suppressed=0, events=12)
        led.close()


def _writers():
    from videop2p_tpu.obs.ledger import RunLedger as JaxLedger

    from videop2p_tpu_torch.obs import RunLedger

    return {"port": (RunLedger, {"device": "cpu"}),
            "jax": (JaxLedger, {"device_info": False})}


def _normalized(obj):
    """JSON-comparable (NaN and inf spelled out)."""
    return json.loads(json.dumps(obj, default=str))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_extract_and_verdicts_equal_jax(tmp_path, writer):
    from videop2p_tpu.obs import history as jh
    from videop2p_tpu.obs.ledger import read_ledger as jax_read

    from videop2p_tpu_torch.obs import history as ph
    from videop2p_tpu_torch.obs.ledger import read_ledger

    cls, kw = _writers()[writer]
    path = str(tmp_path / "runs.jsonl")
    _write_runs(cls, path, **kw)
    events = read_ledger(path)
    assert events == jax_read(path)
    p_runs, j_runs = ph.split_runs(events), jh.split_runs(events)
    assert len(p_runs) == len(j_runs) == 2
    p_recs = [ph.extract_run(r, source=path) for r in p_runs]
    j_recs = [jh.extract_run(r, source=path) for r in j_runs]
    assert _normalized(p_recs) == _normalized(j_recs)
    base = ph.RunHistory(p_recs[:-1]).baseline_for(p_recs[-1])
    assert base["run_id"] == jh.RunHistory(j_recs[:-1]).baseline_for(j_recs[-1])["run_id"]
    got = ph.evaluate_rules(base, p_recs[-1])
    want = jh.evaluate_rules(j_recs[0], j_recs[-1])
    assert _normalized(got) == _normalized(want)
    assert not got["pass"]
    flagged = {v["rule"] for v in got["regressions"]}
    assert {"phase:seconds+25%", "quality:recon_psnr-5%", "timing:blocked_p50_s+25%",
            "incident:count+0%", "slo:compliant-0%", "probe:success_rate-0%",
            "device_memory:peak_bytes_in_use+10%"} <= flagged
    # a run against itself is clean
    assert ph.evaluate_rules(p_recs[0], p_recs[0])["pass"]


def test_run_history_scan_equals_jax(tmp_path):
    """A directory of ledgers, one rotated: the same runs in the same order,
    the rotated segments read through their base ledger once."""
    from videop2p_tpu.obs import history as jh

    from videop2p_tpu_torch.obs import RunLedger
    from videop2p_tpu_torch.obs import history as ph

    _write_runs(RunLedger, str(tmp_path / "a.jsonl"), device="cpu")
    led = RunLedger(str(tmp_path / "b.jsonl"), device="cpu", max_bytes=400)
    for i in range(8):
        led.phase("edit_sample", 1.0 + i)
    led.close()
    got, want = ph.RunHistory.scan(str(tmp_path)), jh.RunHistory.scan(str(tmp_path))
    assert len(got) == len(want) == 3
    assert _normalized(got.runs) == _normalized(want.runs)
    assert got.series("seconds", kind="phase") == want.series("seconds", kind="phase")
    assert got.latest()["phases"]["edit_sample"]["calls"] == 8


def test_decrease_rules_handle_inf_as_jax():
    from videop2p_tpu.obs import history as jh

    from videop2p_tpu_torch.obs import history as ph

    inf = float("inf")
    for b, n in ((inf, inf), (inf, 31.0), (30.0, inf), (30.0, 20.0), (0.0, 0.0)):
        recs = [{"quality": {"recon_psnr": v}} for v in (b, n)]
        got = ph.evaluate_rules(*recs, ph.QUALITY_RULES)
        want = jh.evaluate_rules(*recs, jh.QUALITY_RULES)
        assert _normalized(got) == _normalized(want), (b, n)
    assert not math.isnan(ph.QUALITY_RULES[0].threshold_pct)


def test_port_cli_ledger_gated_alike(tmp_path):
    """Two runs of the port's CLI on one ledger: the port's verdicts are
    the ones JAX's history engine computes on the same file, and they are
    the ones the CLI wrote."""
    import numpy as np

    from videop2p_tpu.obs import history as jh

    from tests.test_torch_slice import RABBIT
    from videop2p_tpu_torch.cli.run_videop2p import main
    from videop2p_tpu_torch.obs import history as ph
    from videop2p_tpu_torch.obs.ledger import read_ledger

    led = str(tmp_path / "led.jsonl")
    frames = np.random.default_rng(0).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    kw = dict(RABBIT, pretrained_model_path=str(tmp_path / "ckpt"), tiny=True, device="cpu",
              fast=True, num_ddim_steps=2, video_len=2, frames=frames, save_gifs=False,
              ledger=led, quality=True)
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        main(**kw)
        main(**kw)
    events = read_ledger(led)
    p_recs = [ph.extract_run(r) for r in ph.split_runs(events)]
    j_recs = [jh.extract_run(r) for r in jh.split_runs(events)]
    assert _normalized(p_recs) == _normalized(j_recs) and len(p_recs) == 2
    got = ph.evaluate_rules(p_recs[0], p_recs[1])
    assert _normalized(got) == _normalized(jh.evaluate_rules(j_recs[0], j_recs[1]))
    written = [e for e in events if e["event"] == "regression_verdicts"]
    assert len(written) == 1 and written[0]["baseline_run_id"] == p_recs[0]["run_id"]
    assert _normalized(written[0]["verdicts"]) == _normalized(got["verdicts"])
    assert {v["kind"] for v in got["verdicts"]} >= {"phase", "quality", "compile"}
