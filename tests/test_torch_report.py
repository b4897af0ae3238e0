"""The port's HTML edit report (``obs/report.py``) against the JAX
package's: the same section headings and table cells (and here the same
page) for the same ledger and sidecar — a ledger of two port CLI runs with
every ported flag, official mode's null-text record, and a ledger of the
serving planes' events written by the JAX package.
"""

import re

import numpy as np
import pytest

import tests.test_torch_parity  # noqa: F401  (one intra-op thread a test process)


def _sections(html_text: str):
    heads = re.findall(r"<h[1-4][^>]*>(.*?)</h[1-4]>", html_text, flags=re.S)
    cells = re.findall(r"<t[dh][^>]*>(.*?)</t[dh]>", html_text, flags=re.S)
    return heads, cells


def _render_both(ledger: str, sidecar, tmp_path):
    from videop2p_tpu.obs.report import write_report as jax_write

    from videop2p_tpu_torch.obs.report import write_report

    got = open(write_report(ledger, str(tmp_path / "port.html"), sidecar)).read()
    want = open(jax_write(ledger, str(tmp_path / "jax.html"), sidecar)).read()
    return got, want


@pytest.fixture(scope="module")
def cli_ledger(tmp_path_factory):
    from tests.test_torch_slice import RABBIT
    from videop2p_tpu_torch.cli.run_videop2p import main

    root = tmp_path_factory.mktemp("report")
    led = str(root / "led.jsonl")
    frames = np.random.default_rng(0).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    kw = dict(RABBIT, pretrained_model_path=str(root / "ckpt"), tiny=True, device="cpu",
              num_ddim_steps=2, video_len=2, frames=frames, save_gifs=False, ledger=led,
              telemetry=True, attn_maps=True, quality=True, report=True, latency=True)
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        main(**kw, fast=True)
        res = main(**kw, fast=False, num_inner_steps=2)
    return led, res


def test_cli_report_equals_jax(cli_ledger, tmp_path):
    led, res = cli_ledger
    got, want = _render_both(led, res["sidecar"], tmp_path)
    heads, cells = _sections(got)
    assert (heads, cells) == _sections(want)
    for head in ("Edit quality", "Null-text optimization", "Regression verdicts"):
        assert any(head in h for h in heads), head
    assert "Per-word cross-attention heatmaps" in got and "data:image/png;base64," in got
    assert got == want
    # the report the CLI wrote (before its ledger's close flushed the
    # execute timing, as JAX's CLI writes it) holds the same sections but
    # "Where time goes"
    cli_heads, _ = _sections(open(res["report"]).read())
    assert set(heads) - set(cli_heads) == {"Where time goes", "Execute latency per program"}


def test_report_cli_entry_point(cli_ledger, tmp_path):
    from videop2p_tpu_torch.obs.report import main

    led, _ = cli_ledger
    out = str(tmp_path / "r.html")
    assert main(["report", led, "-o", out]) == 0
    assert "Video-P2P edit report" in open(out).read()
    assert main(["report"]) == 2 and main(["report", led, "-o"]) == 2


def test_jax_written_ledger_renders_alike(tmp_path):
    """A JAX-written ledger of the planes' events (execute timing, spans,
    an SLO report, fleet signals, a trace directory): the same sections."""
    from videop2p_tpu.obs.ledger import RunLedger as JaxLedger

    path = str(tmp_path / "planes.jsonl")
    led = JaxLedger(path, device_info=False)
    for i in range(4):
        led.record_execute("serve_dispatch", 0.01 * (i + 1), 0.5 * (i + 1))
        led.event("span", name="serve.dispatch", duration_s=0.5 * (i + 1),
                  trace_id=f"{i:032x}", span_id=f"{i:016x}")
    led.event("slo_report", name="availability", compliant=True, budget_burn=0.2,
              section="reliability", objective=0.99, observed=1.0)
    led.event("fleet_signals", label="fleet", burn_alerts=0, scrape_error_rate=0.0,
              saturation=0.4, scale_advice="hold")
    led.event("trace", name="edit_sample", trace_dir=str(tmp_path / "missing"))
    led.close()
    got, want = _render_both(path, None, tmp_path)
    assert _sections(got) == _sections(want)
    assert got == want
