"""The port's program analysis (``videop2p_tpu_torch/obs/introspect.py``)
against the JAX package's record and against ``torch.utils.flop_counter``:
the schema, closed-form counts, determinism in one process and across two,
the kernel wrappers' own reports (their launches stubbed on CPU tensors:
the formulas equal the flop counter's count of each plain version, exactly),
the ledger's one analysis per program and its skip reasons, the serving
cost model fed through the analysis observer, and the JAX package's tools
rendering a port ledger's ``program_analysis`` events.
"""

import json
import os
import runpy
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import tests.test_torch_parity  # noqa: F401  (one intra-op thread a test process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def analysis_on(monkeypatch):
    # the JAX CLI's --no_program_analysis sets the kill switch for the rest
    # of its process, which another test file may have run in
    monkeypatch.delenv("VIDEOP2P_OBS_NO_ANALYSIS", raising=False)


def _record(fn, *args):
    from videop2p_tpu_torch.obs.introspect import analyze_call

    return analyze_call(fn, *args)[1]


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in ("analysis_s", "t")}


def _tanh_mm(x):
    return torch.tanh(x @ x) + 1


def test_schema_is_jax_program_metrics_and_fingerprint():
    from videop2p_tpu.obs.introspect import PROGRAM_METRICS as JAX_METRICS

    from videop2p_tpu_torch.obs.history import PROGRAM_METRICS as HISTORY_METRICS
    from videop2p_tpu_torch.obs.introspect import PROGRAM_METRICS

    assert PROGRAM_METRICS == JAX_METRICS == HISTORY_METRICS
    rec = _record(_tanh_mm, torch.randn(4, 4))
    assert set(rec) == set(PROGRAM_METRICS) | {"hlo_fingerprint", "hlo_histogram",
                                                "analysis_s"}
    assert all(isinstance(rec[k], int) for k in PROGRAM_METRICS)
    assert len(rec["hlo_fingerprint"]) == 16 and int(rec["hlo_fingerprint"], 16) >= 0


def test_tanh_matmul_closed_form():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(16, 16)).astype(np.float32))
    rec = _record(_tanh_mm, x)
    assert rec["flops"] == 2 * 16 ** 3 == 8192
    assert rec["transcendentals"] == 256
    assert rec["hlo_histogram"] == {"add": 1, "mm": 1, "tanh": 1}
    assert rec["hlo_instructions"] == 3
    # mm, tanh and add each read and write (16, 16) float32 tensors
    assert rec["bytes_accessed"] == 7 * 16 * 16 * 4
    assert rec["argument_bytes"] == rec["output_bytes"] == 1024 and rec["alias_bytes"] == 0
    assert rec["generated_code_bytes"] == 0
    assert rec["peak_hbm_bytes"] == (rec["argument_bytes"] + rec["output_bytes"]
                                     + rec["temp_bytes"] - rec["alias_bytes"])


def test_histogram_sorted_as_jax():
    from videop2p_tpu.obs.introspect import instruction_histogram as jax_hist

    from videop2p_tpu_torch.obs.introspect import instruction_histogram

    counts = {"mm": 2, "add": 5, "convolution": 2, "tanh": 1}
    text = "\n".join(f"%x{i} = f32[2] {op}(%y)" for op, n in counts.items()
                     for i in range(n))
    assert list(instruction_histogram(counts).items()) == list(jax_hist(text).items())


def test_outputs_and_record_same_across_two_analyses():
    from videop2p_tpu_torch.obs.introspect import analyze_call

    x = torch.randn(3, 8, 8)
    w = torch.randn(8, 8)

    def prog(x):
        return torch.softmax(torch.nn.functional.silu(x @ w), dim=-1).sum(0)

    out1, rec1 = analyze_call(prog, x)
    out2, rec2 = analyze_call(prog, x)
    assert torch.equal(out1, prog(x)) and torch.equal(out1, out2)
    assert _strip(rec1) == _strip(rec2)
    # the closed-over weight is an argument, as JAX passes parameters
    assert rec1["argument_bytes"] == x.numel() * 4 + w.numel() * 4
    assert rec1["transcendentals"] == 2 * 3 * 8 * 8


_SUBPROCESS = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
torch.manual_seed(0)
torch.set_num_threads(1)
from videop2p_tpu_torch.models.layers import ResnetBlock3D
from videop2p_tpu_torch.obs.introspect import analyze_call
block = ResnetBlock3D(32, 32, 64, groups=8).eval()
x = torch.randn(1, 2, 4, 4, 32)
temb = torch.randn(1, 64)
with torch.no_grad():
    rec = analyze_call(block, x, temb)[1]
rec.pop("analysis_s")
print("REC" + json.dumps(rec, sort_keys=True))
"""


def test_record_same_across_two_processes():
    recs = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", _SUBPROCESS, REPO], capture_output=True,
                             text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
        assert out.returncode == 0, out.stderr[-2000:]
        line = next(x for x in out.stdout.splitlines() if x.startswith("REC"))
        recs.append(json.loads(line[3:]))
    assert recs[0] == recs[1]
    assert recs[0]["flops"] > 0 and recs[0]["hlo_histogram"]["convolution"] == 2


def test_different_program_different_fingerprint():
    x = torch.randn(16, 16)
    base = _record(_tanh_mm, x)
    other = _record(lambda x: torch.sigmoid(x @ x) + 1, x)
    wider = _record(_tanh_mm, torch.randn(32, 32))
    assert len({base["hlo_fingerprint"], other["hlo_fingerprint"],
                wider["hlo_fingerprint"]}) == 3
    # the same program on other values is the same program
    assert _record(_tanh_mm, torch.randn(16, 16))["hlo_fingerprint"] == base["hlo_fingerprint"]


def test_backward_is_counted():
    x = torch.randn(8, 16)
    w = torch.randn(16, 4, requires_grad=True)

    def step(x):
        loss = (x @ w).sum()
        loss.backward()
        return w.grad

    rec = _record(step, x)
    # the forward product, then the weight gradient (x^T @ dout)
    assert rec["flops"] == 2 * (2 * 8 * 16 * 4)


def test_hidden_ops_are_not_seen():
    from videop2p_tpu_torch.obs.introspect import hidden_from_analysis

    def prog(x):
        with hidden_from_analysis():
            y = torch.tanh(x @ x)
        return y + 1

    rec = _record(prog, torch.randn(4, 4))
    assert rec["hlo_histogram"] == {"add": 1} and rec["flops"] == 0


def test_note_kernel_without_analysis_is_a_noop():
    from videop2p_tpu_torch.obs.introspect import note_kernel

    note_kernel("k", "x.cu", (torch.ones(2),), (torch.ones(2),), flops=10)


# ---- the kernel wrappers' reports against their plain versions -----------


@pytest.fixture
def stubbed_launches(monkeypatch):
    """Every launcher a no-op and CUDA's stream query a stub, so that the
    wrappers' launch paths run on CPU tensors up to the launch."""
    from videop2p_tpu_torch.ops import attention as fa
    from videop2p_tpu_torch.ops import groupnorm as gn

    noop = lambda *a: None  # noqa: E731
    monkeypatch.setattr(fa, "_launcher", lambda: noop)
    monkeypatch.setattr(fa, "_flash_launcher", lambda: noop)
    monkeypatch.setattr(fa, "_flash_bwd_launcher", lambda name: noop)
    monkeypatch.setattr(fa, "_fwd_scratch", lambda *a: None)
    monkeypatch.setattr(fa, "_flash_bwd_scratch_bytes", lambda *a: 16)
    monkeypatch.setattr(gn, "_launcher", lambda: noop)
    monkeypatch.setattr(gn, "_sm_count", lambda index: 4)
    monkeypatch.setattr(gn, "_scratch", {})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return fa, gn


def _counted(fn, *args):
    """(flop_counter's flops, the analysis' transcendentals) of a plain
    version."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops(), _record(fn, *args)["transcendentals"]


def _reported(fn, *args):
    rec = _record(fn, *args)
    return rec["flops"], rec["transcendentals"], rec


def _rand(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


def _dq_plain(q, k, v, o, do, m, l):
    """The dQ kernel's work alone: the scores, dP, dS·K."""
    scale = q.shape[-1] ** -0.5
    p = torch.exp(q @ k.transpose(-1, -2) * scale - m[..., None]) / l[..., None]
    di = (o * do).sum(-1, keepdim=True)
    ds = (do @ v.transpose(-1, -2) - di) * p * scale
    return ds @ k


def _dkv_plain(q, k, v, o, do, m, l):
    """The dK/dV kernel's work alone: the scores, dV, dP, dK."""
    scale = q.shape[-1] ** -0.5
    p = torch.exp(q @ k.transpose(-1, -2) * scale - m[..., None]) / l[..., None]
    dv = p.transpose(-1, -2) @ do
    di = (o * do).sum(-1, keepdim=True)
    ds = (do @ v.transpose(-1, -2) - di) * p * scale
    return ds.transpose(-1, -2) @ q, dv


@pytest.mark.parametrize("shape", [(1, 2, 2, 16, 8), (2, 3, 1, 24, 16)])
def test_fused_forward_report_equals_plain_count(stubbed_launches, shape):
    fa, _ = stubbed_launches
    b, f, h, n, d = shape
    q, k, v = _rand(*shape), _rand(b, h, n, d, seed=1), _rand(b, h, n, d, seed=2)
    flops, trans, rec = _reported(fa._fused_launch, q, k, v)
    assert (flops, trans) == _counted(fa.chunked_frame_attention, q, k, v)
    assert (flops, trans) == (4 * b * f * h * n * n * d, b * f * h * n * n)
    assert rec["hlo_histogram"]["frame_attention_fwd"] == 1


@pytest.mark.parametrize("rect", [False, True])
def test_flash_forward_report_equals_plain_count(stubbed_launches, rect):
    fa, _ = stubbed_launches
    b, f, h, n, d = 1, 2, 2, 16, 8
    q, k, v = _rand(b, f, h, n, d), _rand(b, h, n, d, seed=1), _rand(b, h, n, d, seed=2)
    with torch.no_grad():
        flops, trans, rec = _reported(lambda *a: fa._FlashFrameAttention.apply(*a, rect, False),
                                      q, k, v)
    plain = (fa.flash_rect_frame_attention_reference if rect
             else fa.flash_frame_attention_reference)
    assert (flops, trans) == _counted(plain, q, k, v)
    assert rec["hlo_histogram"]["flash_attention_fwd"] == 1
    # K and V are read once, whatever the frames' stride-0 view
    assert rec["bytes_accessed"] >= (q.numel() * 2 + k.numel() + v.numel()) * 4


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_flash_backward_reports_equal_plain_counts(stubbed_launches, kernel):
    fa, _ = stubbed_launches
    b0, b1, h, lq, lk, d = 1, 2, 2, 16, 12, 8
    q5, o5, do5 = (_rand(b0, b1, h, lq, d, seed=s) for s in (0, 3, 4))
    k4, v4 = _rand(b0, h, lk, d, seed=1), _rand(b0, h, lk, d, seed=2)
    m, l = _rand(b0, b1, h, lq, seed=5), _rand(b0, b1, h, lq, seed=6).abs() + 1
    outs = (torch.empty_like(q5), torch.empty_like(k4), torch.empty_like(v4))
    rec = _record(lambda *a: fa._flash_bwd(*a, *outs), q5, k4, v4, o5, do5, m, l)
    counts = rec["hlo_histogram"]
    assert counts["flash_attention_bwd_dq"] == counts["flash_attention_bwd_dkv"] == 1
    plain = {"dq": _dq_plain, "dkv": _dkv_plain}[kernel]
    want_flops, want_trans = _counted(plain, q5, k4[:, None], v4[:, None], o5, do5, m, l)
    scores = b0 * b1 * h * lq * lk
    factor = {"dq": 6, "dkv": 8}[kernel]
    assert want_flops == factor * scores * d and want_trans == scores
    # the record holds both kernels' work: 6 + 8 flops a score and element
    assert rec["flops"] == 14 * scores * d and rec["transcendentals"] == 2 * scores


@pytest.mark.parametrize("act", ["none", "silu"])
def test_group_norm_report_equals_plain_count(stubbed_launches, act):
    _, gn = stubbed_launches
    x, scale, bias = _rand(2, 12, 32), _rand(32, seed=1), _rand(32, seed=2)
    flops, trans, rec = _reported(lambda *a: gn._launch(*a, 8, 1e-5, act), x, scale, bias)
    plain = lambda x, s, b: gn.group_norm_reference(x, s, b, num_groups=8, act=act)  # noqa: E731
    assert (flops, trans) == _counted(plain, x, scale, bias)
    assert trans == (x.numel() if act == "silu" else 0)
    assert rec["hlo_histogram"]["group_norm_fwd"] == 1
    # x, scale and bias read once, y written once
    assert rec["bytes_accessed"] == (2 * x.numel() + 2 * 32) * 4


def test_group_norm_scratch_growth_is_hidden(stubbed_launches):
    """The kernel's scratch grows on the call that first needs it: the
    analysis of that call equals a later one's."""
    _, gn = stubbed_launches
    x, scale, bias = _rand(2, 12, 32), _rand(32, seed=1), _rand(32, seed=2)
    first = _record(lambda *a: gn._launch(*a, 8, 1e-5, "silu"), x, scale, bias)
    second = _record(lambda *a: gn._launch(*a, 8, 1e-5, "silu"), x, scale, bias)
    assert gn._scratch and _strip(first) == _strip(second)


# ---- the ledger -----------------------------------------------------------


def _ledger(tmp_path, name="led.jsonl"):
    from videop2p_tpu_torch.obs.ledger import RunLedger

    return RunLedger(str(tmp_path / name)).activate()


def test_one_program_analysis_per_program(tmp_path):
    from videop2p_tpu_torch.obs.ledger import instrumented_program, read_ledger

    led = _ledger(tmp_path)
    prog = instrumented_program(_tanh_mm, program="toy")
    other = instrumented_program(torch.sigmoid, program="other")
    x = torch.randn(16, 16)
    outs = [prog(x) for _ in range(3)] + [other(x)]
    led.close()
    assert all(torch.equal(o, _tanh_mm(x)) for o in outs[:3])
    events = read_ledger(led.path)
    pa = [e for e in events if e["event"] == "program_analysis"]
    assert [e["program"] for e in pa] == ["toy", "other"]
    assert pa[0]["flops"] == 8192 and pa[0]["transcendentals"] == 256
    calls = [e["program"] for e in events if e["event"] == "program_call"]
    assert calls == ["toy"] * 3 + ["other"]
    kinds = [e["event"] for e in events]
    # after the first call's program_call and compile events
    assert kinds.index("program_analysis") > kinds.index("compile")


@pytest.mark.parametrize("reason", ["analyze_false", "disabled", "analysis_error"])
def test_skip_reasons(tmp_path, monkeypatch, reason):
    from videop2p_tpu_torch.obs import introspect
    from videop2p_tpu_torch.obs.ledger import instrumented_program, read_ledger

    if reason == "disabled":
        monkeypatch.setenv("VIDEOP2P_OBS_NO_ANALYSIS", "1")
    if reason == "analysis_error":
        def broken(self, *a, **k):
            raise ValueError("a formula failed")

        monkeypatch.setattr(introspect.ProgramAnalysis, "_note", broken)
    led = _ledger(tmp_path)
    prog = instrumented_program(_tanh_mm, program="toy", analyze=reason != "analyze_false")
    x = torch.randn(16, 16)
    out = [prog(x), prog(x)]
    led.close()
    assert all(torch.equal(o, _tanh_mm(x)) for o in out)
    events = read_ledger(led.path)
    assert not [e for e in events if e["event"] == "program_analysis"]
    skips = [e for e in events if e["event"] == "program_analysis_skipped"]
    assert [(e["program"], e["reason"]) for e in skips] == [("toy", reason)]


def test_no_ledger_no_analysis(monkeypatch):
    from videop2p_tpu_torch.obs import introspect
    from videop2p_tpu_torch.obs.ledger import instrumented_program

    def fail(*a, **k):
        raise AssertionError("analysed without a ledger")

    monkeypatch.setattr(introspect.ProgramAnalysis, "__init__", fail)
    assert torch.equal(instrumented_program(_tanh_mm, program="toy")(torch.ones(2, 2)),
                       _tanh_mm(torch.ones(2, 2)))


def test_observers_see_the_record(tmp_path):
    from videop2p_tpu_torch.obs.ledger import instrumented_program

    led = _ledger(tmp_path)
    seen = []
    led.analysis_observers.append(lambda program, rec: seen.append((program, rec["flops"])))
    led.analysis_observers.insert(0, lambda program, rec: 1 / 0)  # must not block
    instrumented_program(_tanh_mm, program="toy")(torch.randn(16, 16))
    led.close()
    assert seen == [("toy", 8192)]


def test_cost_model_prices_flops_through_the_observer(tmp_path):
    from videop2p_tpu_torch.obs.cost import CostModel
    from videop2p_tpu_torch.obs.ledger import instrumented_program

    led = _ledger(tmp_path)
    cost = CostModel()
    led.analysis_observers.append(cost.observe_program)
    assert cost.price_dispatch(1.0, real=1, padded=1, singleton="serve_edit")["flops"] == 0.0
    instrumented_program(_tanh_mm, program="serve_edit")(torch.randn(16, 16))
    instrumented_program(_tanh_mm, program="serve_invert")(torch.randn(16, 16))
    led.close()
    static = cost.static_cost("serve_edit")
    assert static["flops"] == 8192.0 and static["peak_hbm_bytes"] > 0
    # a batch of 2 through the singleton program: each slot its flops, whole
    slot = cost.price_dispatch(2.0, real=2, padded=2, singleton="serve_edit")
    assert slot["flops"] == 8192.0 and slot["program"] == "serve_edit"
    assert slot["hbm_byte_seconds"] == static["peak_hbm_bytes"] * 2.0
    saved = cost.savings()
    assert saved["saved_flops"] == 8192.0 and saved["saved_device_seconds"] > 0


def _port_ledger(tmp_path, name):
    from videop2p_tpu_torch.obs.ledger import instrumented_program

    led = _ledger(tmp_path, name)
    instrumented_program(_tanh_mm, program="toy")(torch.randn(16, 16))
    instrumented_program(torch.sigmoid, program="other", analyze=False)(torch.randn(4))
    led.close()
    return led.path


def test_jax_ledger_summary_renders_port_analysis(tmp_path, capsys):
    path = _port_ledger(tmp_path, "a.jsonl")
    summary = runpy.run_path(os.path.join(REPO, "tools", "ledger_summary.py"))
    assert summary["main"](["ledger_summary.py", path]) == 0
    out = capsys.readouterr().out
    assert "toy" in out and "analyze_false" in out


def test_jax_obs_diff_compares_port_analyses(tmp_path, capsys):
    a, b = _port_ledger(tmp_path, "a.jsonl"), _port_ledger(tmp_path, "b.jsonl")
    diff = runpy.run_path(os.path.join(REPO, "tools", "obs_diff.py"))
    assert diff["main"](["obs_diff.py", "--json", a, b]) == 0
    verdict = json.loads(capsys.readouterr().out)
    assert verdict["pass"] is True
    assert any("toy" in json.dumps(v) for v in verdict["verdicts"])
