"""The port's per-step telemetry (``obs/telemetry.py``), the run ledger's
``telemetry`` events and ``max_bytes`` rotation, and
``obs/timing.py:measure_overhead_p50``, against the JAX package's on the
same inputs (seeded numpy, NaN and inf included); the ``--latency`` switch
that ``cli/common.py:make_run_ledger`` sets for the life of its ledger; and
``utils/metrics.py:MetricsLogger``'s ledger view and TensorBoard mirror.

Tolerances: the latent statistics in float32 within 1e-6 relative (both
sides reduce the same finite elements, in their own order); the NaN and inf
counts and every decoded record exactly (both decode the same numbers).
"""

import json
import os
import sys
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_parity  # noqa: F401  (one intra-op thread a test process)


def _latent(kind: str) -> np.ndarray:
    x = np.random.default_rng(3).normal(size=(2, 3, 4, 4, 4)).astype(np.float32) * 3.0
    if kind in ("nan", "both"):
        x[0, 1, 2, 3, 0] = np.nan
        x[1, 0, 0, 0, :2] = np.nan
    if kind in ("inf", "both"):
        x[0, 0, 1, 1, 1] = np.inf
        x[1, 2, 3, 3, 3] = -np.inf
    return x


@pytest.mark.parametrize("kind", ["finite", "nan", "inf", "both"])
def test_latent_stats_match_jax(kind):
    from videop2p_tpu.obs.telemetry import latent_stats as jax_stats

    from videop2p_tpu_torch.obs.telemetry import latent_stats

    x = _latent(kind)
    got, want = latent_stats(torch.from_numpy(x)), jax_stats(jnp.asarray(x))
    assert sorted(got) == sorted(want)
    for k in ("nan_count", "inf_count"):
        assert got[k].dtype == torch.int32
        assert int(got[k]) == int(want[k]), k
    for k in ("abs_max", "mean"):
        assert torch.isfinite(got[k])
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


def _stacked(n: int, seed: int = 0) -> dict:
    """Per-step curves as a pipeline stacks them, nan / inf counts that
    start at a given step included."""
    rng = np.random.default_rng(seed)
    nan = np.zeros(n, np.int32)
    inf = np.zeros(n, np.int32)
    if n > 2:
        nan[2:] = 3
        inf[n - 1] = 1
    return {"abs_max": rng.random(n).astype(np.float32) * 5,
            "mean": rng.normal(size=n).astype(np.float32),
            "nan_count": nan, "inf_count": inf,
            "cross_gate_mean": rng.random(n).astype(np.float32),
            "self_edit_active": (np.arange(n) % 2).astype(np.int32)}


@pytest.mark.parametrize("n", [0, 1, 5])
def test_step_decoders_match_jax(n):
    from videop2p_tpu.obs import telemetry as jt

    from videop2p_tpu_torch.obs import telemetry as pt

    curves = _stacked(n)
    port = {k: torch.from_numpy(v) for k, v in curves.items()}
    jax_in = {k: jnp.asarray(v) for k, v in curves.items()}
    assert pt.decode_step_stats(port) == jt.decode_step_stats(jax_in)
    assert pt.summarize_step_stats(port) == jt.summarize_step_stats(jax_in)


@pytest.mark.parametrize("with_latent", [False, True])
def test_null_text_decoder_matches_jax(with_latent):
    from videop2p_tpu.obs import telemetry as jt

    from videop2p_tpu_torch.obs import telemetry as pt

    rng = np.random.default_rng(1)
    losses = rng.random(6).astype(np.float32) * 1e-3
    inner = np.array([3, 2, 10, 1, 0, 4], np.int32)
    port = {"final_loss": torch.from_numpy(losses), "inner_steps": torch.from_numpy(inner)}
    jax_in = {"final_loss": jnp.asarray(losses), "inner_steps": jnp.asarray(inner)}
    if with_latent:
        curves = _stacked(6, seed=2)
        port["latent_stats"] = {k: torch.from_numpy(v) for k, v in curves.items()}
        jax_in["latent_stats"] = {k: jnp.asarray(v) for k, v in curves.items()}
    got, want = pt.decode_null_text_stats(port), jt.decode_null_text_stats(jax_in)
    assert got == want
    assert ("latent" in got) == with_latent


def test_sparkline_and_overhead_record_match_jax():
    from videop2p_tpu.obs import telemetry as jt

    from videop2p_tpu_torch.obs import telemetry as pt

    for values in ([], [1.0] * 5, [3, 1, float("nan"), 2, 8], list(range(120))):
        assert pt.sparkline(values) == jt.sparkline(values)
    assert pt.telemetry_overhead_record(1.25, 1.3) == jt.telemetry_overhead_record(1.25, 1.3)


def test_stack_step_stats_keeps_records_on_their_device():
    from videop2p_tpu_torch.obs.telemetry import latent_stats, stack_step_stats

    recs = [dict(latent_stats(torch.full((2, 2), float(i))),
                 entropy={"a/attn2": torch.tensor(float(i))}) for i in range(3)]
    out = stack_step_stats(recs)
    assert out["abs_max"].tolist() == [0.0, 1.0, 2.0]
    assert out["entropy"]["a/attn2"].shape == (3,)
    assert out["nan_count"].dtype == torch.int32
    assert stack_step_stats([]) == {}


def test_ledger_telemetry_event_reads_in_both_packages(tmp_path):
    from videop2p_tpu.obs.ledger import read_ledger as jax_read

    from videop2p_tpu_torch.obs import RunLedger, read_ledger
    from videop2p_tpu_torch.obs.telemetry import decode_step_stats, summarize_step_stats

    path = str(tmp_path / "led.jsonl")
    curves = {k: torch.from_numpy(v) for k, v in _stacked(4).items()}
    rec = {"summary": summarize_step_stats(curves), "steps": decode_step_stats(curves)}
    with RunLedger(path, device="cpu") as led:
        led.telemetry("edit_sample", rec)
    events = read_ledger(path)
    assert events == jax_read(path)
    tel = [e for e in events if e["event"] == "telemetry"]
    assert len(tel) == 1 and tel[0]["program"] == "edit_sample"
    assert tel[0]["summary"] == json.loads(json.dumps(rec["summary"]))
    assert [s["step"] for s in tel[0]["steps"]] == [0, 1, 2, 3]
    start = events[0]
    assert start["backend"] == "cpu" and start["mesh"] is None


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_max_bytes_rotation_matches_jax(tmp_path, writer):
    """A ledger of either package written with a small ``max_bytes`` rotates
    into the same chain, which both readers read back whole, oldest
    first."""
    from videop2p_tpu.obs.ledger import RunLedger as JaxLedger
    from videop2p_tpu.obs.ledger import read_ledger as jax_read

    from videop2p_tpu_torch.obs import RunLedger, read_ledger

    path = str(tmp_path / "rot.jsonl")
    if writer == "port":
        led = RunLedger(path, device="cpu", max_bytes=600)
    else:
        led = JaxLedger(path, max_bytes=600, device_info=False)
    for i in range(12):
        led.event("metric", step=i, train_loss=0.5 + i)
    led.close()
    assert (tmp_path / "rot.1.jsonl").exists() and (tmp_path / "rot.2.jsonl").exists()
    events = read_ledger(path)
    assert events == jax_read(path)
    assert [e["step"] for e in events if e["event"] == "metric"] == list(range(12))
    markers = [e for e in events if e["event"] == "ledger_rotated"]
    assert markers and [m["index"] for m in markers] == list(range(1, len(markers) + 1))
    assert sorted(markers[0]) == ["event", "index", "previous", "rotated_bytes", "run_id", "t"]
    for p in tmp_path.glob("rot*.jsonl"):
        assert p.stat().st_size <= 600


def test_measure_overhead_p50_schema_and_sign():
    from videop2p_tpu.obs.timing import measure_overhead_p50 as jax_measure

    from videop2p_tpu_torch.obs.timing import measure_overhead_p50

    calls = []

    def off():
        calls.append("off")
        time.sleep(0.002)

    def on():
        calls.append("on")
        time.sleep(0.006)

    rec = measure_overhead_p50(off, on, repeats=3)
    assert calls == ["off", "on"] * 4  # one warm-up each, then interleaved
    assert sorted(rec) == sorted(jax_measure(lambda: None, lambda: None, repeats=1))
    assert rec["telemetry_on_s"] > rec["telemetry_off_s"] > 0
    assert rec["telemetry_overhead_pct"] > 50.0



@pytest.mark.parametrize("prev", [None, "0"])
def test_make_run_ledger_restores_the_latency_switch(tmp_path, monkeypatch, prev):
    from videop2p_tpu_torch.cli.common import make_run_ledger
    from videop2p_tpu_torch.obs.timing import latency_enabled

    if prev is None:
        monkeypatch.delenv("VIDEOP2P_OBS_LATENCY", raising=False)
    else:
        monkeypatch.setenv("VIDEOP2P_OBS_LATENCY", prev)
    led = make_run_ledger(str(tmp_path / "a.jsonl"), latency=True, device="cpu")
    assert latency_enabled() and led.timing_enabled()
    led.close()
    assert os.environ.get("VIDEOP2P_OBS_LATENCY") == prev
    # scoped to the ledger: the process-wide switch is left alone
    led = make_run_ledger(str(tmp_path / "b.jsonl"), enable=True, latency=True,
                          set_latency_env=False, device="cpu")
    assert led.timing_enabled() and not latency_enabled()
    led.close()
    assert os.environ.get("VIDEOP2P_OBS_LATENCY") == prev


@pytest.mark.parametrize("tensorboard", [False, True])
def test_metrics_logger_ledger_view_and_tensorboard_mirror(tmp_path, monkeypatch,
                                                           tensorboard):
    """Every logged step is a line of ``metrics.jsonl`` and a ``metric``
    event; the TensorBoard mirror (a stand-in writer here: the real import
    pulls in TensorFlow where it is installed) only when asked for."""
    from videop2p_tpu_torch.obs.ledger import RunLedger, read_ledger
    from videop2p_tpu_torch.utils import metrics

    calls = []

    class Writer:
        def __init__(self, log_dir, comment):
            calls.append(("init", log_dir, comment))

        def add_scalar(self, key, value, step):
            calls.append(("scalar", key, value, step))

        def flush(self):
            calls.append(("flush",))

        def close(self):
            calls.append(("close",))

    fake = types.ModuleType("torch.utils.tensorboard")
    fake.SummaryWriter = Writer
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
    monkeypatch.setattr(metrics, "TB_FLUSH_EVERY", 2)
    run_dir = str(tmp_path / "run")
    led = RunLedger(str(tmp_path / "led.jsonl"), device="cpu")
    with metrics.MetricsLogger(run_dir, ledger=led, tensorboard=tensorboard) as m:
        for step in (1, 2, 3):
            m.log(step, {"train_loss": 0.5 * step})
    led.close()
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [(r["step"], r["train_loss"]) for r in lines] == [(1, 0.5), (2, 1.0), (3, 1.5)]
    events = [e for e in read_ledger(str(tmp_path / "led.jsonl")) if e["event"] == "metric"]
    assert [{k: e[k] for k in lines[0]} for e in events] == lines
    want = [("init", os.path.join(run_dir, "tb"), "text2video-fine-tune"),
            ("scalar", "train_loss", 0.5, 1), ("scalar", "train_loss", 1.0, 2), ("flush",),
            ("scalar", "train_loss", 1.5, 3), ("flush",), ("close",)]
    assert calls == (want if tensorboard else [])
