"""The port's device-trace mining (``videop2p_tpu_torch/obs/trace.py``)
against the JAX package's ``obs/trace.py``: synthetic chrome traces read
back into the events they were written from, those events mined by both
packages' ``analyze_events`` into equal records (less ``families``, whose
tables are each package's own), the interval, overlap and idle closed
forms, the CUDA family table, a real CPU ``torch.profiler`` capture,
``trace_window``'s ledger event and sidecar, ``utils/profiling.trace`` and
the report's mining of a ``trace`` event's directory.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

import tests.test_torch_parity  # noqa: F401  (one intra-op thread a test process)


def _chrome(events, *, modules=(), host=()):
    """A chrome trace (Kineto's layout) of ``(name, start_ps, dur_ps)``
    device kernels, module annotations and host ops; times in µs."""
    out = []
    for cat, evs in (("kernel", events), ("gpu_user_annotation", modules),
                     ("cpu_op", host)):
        for name, start, dur in evs:
            out.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
                        "ts": start / 1e6, "dur": dur / 1e6, "args": {}})
    out.append({"ph": "i", "cat": "kernel", "name": "instant", "ts": 1.0})
    return {"schemaVersion": 1, "traceEvents": out}


KERNELS = [
    ("void frame_attention_tf32_kernel<40>(sm90::tf32::fwd::Problem)", 1_000_000, 400_000),
    ("void frame_attention_tf32_prep_kernel<40>(sm90::tf32::fwd::Problem)", 600_000, 300_000),
    ("gn_persistent_kernel<float, 4>", 1_500_000, 250_000),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_nt_n_tilesize128x128x32", 2_000_000, 500_000),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc", 2_600_000, 700_000),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float>>", 3_400_000,
     40_000),
    ("Memcpy DtoD (Device -> Device)", 3_500_000, 10_000),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 3_300_000, 300_000),
]
MODULES = [("cached_invert_edit", 500_000, 3_100_000)]


SCENARIOS = {
    "single_card": [e for e in KERNELS if "nccl" not in e[0]],
    "collective": KERNELS,
    "empty": [],
}


@pytest.mark.parametrize("form", ["json", "gzip", "bare_list"])
def test_reader_returns_the_written_events(tmp_path, form):
    from videop2p_tpu_torch.obs.trace import OP_CATEGORIES, load_chrome_traces, trace_events

    trace = _chrome(KERNELS, modules=MODULES, host=[("aten::mm", 900_000, 50_000)])
    sub = tmp_path / "plugins" / "nested"
    sub.mkdir(parents=True)
    if form == "gzip":
        with gzip.open(sub / "t.json.gz", "wt") as f:
            json.dump(trace, f)
    else:
        body = trace["traceEvents"] if form == "bare_list" else trace
        (sub / "t.json").write_text(json.dumps(body))
    traces = load_chrome_traces(str(tmp_path))
    assert trace_events(traces, OP_CATEGORIES) == sorted(KERNELS, key=lambda e: e[1])
    assert trace_events(traces, ("gpu_user_annotation",)) == MODULES
    assert trace_events(traces, ("cpu_op",)) == [("aten::mm", 900_000, 50_000)]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_records_equal_jax_analyze_events(scenario):
    from videop2p_tpu.obs.trace import analyze_events as jax_analyze

    from videop2p_tpu_torch.obs.trace import TRACE_ANALYSIS_FIELDS, analyze_events

    events = sorted(SCENARIOS[scenario], key=lambda e: e[1])
    # JAX's collective test is on XLA names: give its side an XLA name for
    # the collective (the port matches NCCL's)
    jax_events = [("all-reduce.1" if "nccl" in n else n, s, d) for n, s, d in events]
    port, port_arrays = analyze_events(events, MODULES, name="w", trace_dir="/x")
    ref, ref_arrays = jax_analyze(jax_events, MODULES, name="w", trace_dir="/x")
    assert set(TRACE_ANALYSIS_FIELDS) <= set(port)
    strip = lambda r: {k: v for k, v in r.items() if k not in ("families", "top_ops")}  # noqa
    assert strip(port) == strip(ref)
    assert [(t["seconds"], t["count"]) for t in port["top_ops"]] == [
        (t["seconds"], t["count"]) for t in ref["top_ops"]]
    assert sorted(port_arrays) == sorted(ref_arrays)
    for key in port_arrays:
        np.testing.assert_array_equal(port_arrays[key], ref_arrays[key])


def test_fields_are_jax_fields():
    from videop2p_tpu.obs.trace import TRACE_ANALYSIS_FIELDS as JAX_FIELDS

    from videop2p_tpu_torch.obs.trace import TRACE_ANALYSIS_FIELDS

    assert TRACE_ANALYSIS_FIELDS == JAX_FIELDS


@pytest.mark.parametrize("compute,collective,want", [
    ([(0, 10)], [(20, 30)], 0.0),                  # disjoint: fully exposed
    ([(0, 100)], [(10, 20), (40, 50)], 1.0),       # hidden under compute
    ([(0, 15)], [(10, 20)], 0.5),                  # half under compute
    ([(0, 10)], [], None),                         # no collective (one card)
])
def test_overlap_fraction_closed_forms(compute, collective, want):
    from videop2p_tpu_torch.obs.trace import overlap_fraction

    assert overlap_fraction(compute, collective) == want


def test_interval_union_and_idle_closed_forms():
    from videop2p_tpu_torch.obs.trace import analyze_events, interval_union, union_length

    assert interval_union([(5, 8), (0, 2), (1, 3), (8, 9), (4, 4)]) == [(0, 3), (5, 9)]
    assert union_length([(0, 10), (5, 15), (20, 25)]) == 20
    rec, _ = analyze_events([("a", 0, 2_000_000), ("b", 1_000_000, 2_000_000),
                             ("c", 10_000_000, 1_000_000)])
    assert rec["span_s"] == 11e-6 and rec["idle_s"] == 7e-6 and rec["idle_max_s"] == 7e-6
    assert rec["device_total_s"] == 5e-6 and rec["compute_s"] == 4e-6
    assert rec["overlap_fraction"] is None and rec["num_ops"] == 3


@pytest.mark.parametrize("name,family", [
    ("void frame_attention_wgmma_kernel<48>(CUtensorMap, sm90::Problem)", "frame_attention"),
    ("flash_fwd_tf32_prep_kernel<40>", "flash_attention_fwd"),
    ("void flash_bwd_dkv_wgmma_kernel<48>(CUtensorMap)", "flash_attention_bwd"),
    ("flash_bwd_dq_tf32_kernel<80>", "flash_attention_bwd"),
    ("gn_persistent_kernel<__nv_bfloat16, 8>", "group_norm"),
    ("nvjet_tst_128x256_64x4_2x1_v_bz_TNT", "gemm"),
    ("cutlass3x_sm90_tensorop_s64x128x16gemm_f32", "gemm"),
    ("sm90_xmma_fprop_implicit_gemm_indexed_f32f32", "conv"),
    ("cudnn::engines_precompiled::nchwToNhwcKernel", "conv"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float>", "softmax"),
    ("void at::native::reduce_kernel<512, 1, ReduceOp<float>>", "reduce"),
    ("void at::native::unrolled_elementwise_kernel<CopyFunctor>", "copy"),
    ("void at::native::vectorized_elementwise_kernel<4, GeluFunctor>", "elementwise"),
    ("Memset (Device)", "copy"),
    ("ncclDevKernel_AllGather_RING_LL", "collective"),
    ("void at::native::upsample_nearest3d_out_frame<float>(float const*)",
     "upsample_nearest3d_out_frame"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float, "
     "false>(int, float, float const*, float*)", "vectorized_layer_norm_kernel"),
])
def test_op_family_table(name, family):
    from videop2p_tpu_torch.obs.trace import is_collective_op, op_family

    assert op_family(name) == family
    assert is_collective_op(name) == (family == "collective")


def test_cpu_profiler_trace_is_a_wellformed_zero_record(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from videop2p_tpu_torch.obs.trace import TRACE_ANALYSIS_FIELDS, analyze_trace_dir

    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("program"):
            (x @ x).sum()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    rec, arrays = analyze_trace_dir(str(tmp_path), name="cpu")
    assert set(TRACE_ANALYSIS_FIELDS) <= set(rec)
    assert rec["num_events"] == 0 and rec["device_total_s"] == 0.0
    assert rec["overlap_fraction"] is None and rec["families"] == {}
    assert all(a.size == 0 for a in arrays.values())


def test_trace_window_writes_event_and_sidecar(tmp_path):
    from videop2p_tpu_torch.obs.ledger import RunLedger, instrumented_program, read_ledger
    from videop2p_tpu_torch.obs.trace import TRACE_ANALYSIS_FIELDS, trace_window

    led = RunLedger(str(tmp_path / "led.jsonl")).activate()
    prog = instrumented_program(lambda x: torch.tanh(x @ x), program="toy")
    with trace_window("toy", trace_dir=str(tmp_path / "tr"), device="cpu") as target:
        prog(torch.randn(32, 32))
    led.close()
    assert target == str(tmp_path / "tr")
    assert os.path.isfile(tmp_path / "tr" / "trace_toy.json")
    ev = [e for e in read_ledger(led.path) if e["event"] == "trace_analysis"]
    assert len(ev) == 1 and set(TRACE_ANALYSIS_FIELDS) <= set(ev[0])
    assert ev[0]["name"] == "toy" and ev[0]["num_events"] == 0
    assert ev[0]["launches"] == {"frame_attention": 0, "group_norm": 0, "flash_attention": 0,
                                 "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
    with np.load(ev[0]["sidecar"]) as z:
        assert set(z.files) == {f"trace_toy/{k}" for k in (
            "op_start_ps", "op_dur_ps", "op_is_collective", "module_start_ps",
            "module_dur_ps")}
    # the program's label was a record_function range while the profiler ran
    with open(tmp_path / "tr" / "trace_toy.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "toy" in names
    assert os.environ.get("TEARDOWN_CUPTI") is not None


def test_trace_window_without_ledger_is_silent(tmp_path):
    from videop2p_tpu_torch.obs.ledger import current_ledger
    from videop2p_tpu_torch.obs.trace import trace_window

    assert current_ledger() is None
    with trace_window("quiet", trace_dir=str(tmp_path), device="cpu"):
        torch.randn(8, 8).sum()
    assert os.path.isfile(tmp_path / "trace_quiet.json")


def test_trace_window_mining_failure_is_a_skip(tmp_path, monkeypatch):
    from videop2p_tpu_torch.obs import trace
    from videop2p_tpu_torch.obs.ledger import RunLedger, read_ledger

    def broken(*a, **k):
        raise ValueError("unreadable")

    monkeypatch.setattr(trace, "analyze_trace_dir", broken)
    led = RunLedger(str(tmp_path / "led.jsonl")).activate()
    with trace.trace_window("w", trace_dir=str(tmp_path / "tr"), device="cpu"):
        torch.ones(2).sum()
    led.close()
    skips = [e for e in read_ledger(led.path) if e["event"] == "trace_analysis_skipped"]
    assert [(e["name"], e["reason"]) for e in skips] == [("w", "analysis_error")]


def test_profiling_trace_writes_a_trace_event(tmp_path, monkeypatch):
    from videop2p_tpu_torch.obs.ledger import RunLedger, read_ledger
    from videop2p_tpu_torch.utils.profiling import trace

    led = RunLedger(str(tmp_path / "led.jsonl")).activate()
    with trace("untraced"):
        torch.ones(2).sum()
    monkeypatch.setenv("VIDEOP2P_TRACE_DIR", str(tmp_path / "traces"))
    with trace("traced"):
        torch.ones(2).sum()
    led.close()
    events = read_ledger(led.path)
    assert [e["name"] for e in events if e["event"] == "phase"] == ["untraced", "traced"]
    traces = [e for e in events if e["event"] == "trace"]
    assert [(e["name"], e["trace_dir"]) for e in traces] == [
        ("traced", str(tmp_path / "traces" / "traced"))]
    assert os.path.isfile(tmp_path / "traces" / "traced" / "trace_traced.json")


def test_report_mines_a_trace_events_directory(tmp_path):
    from videop2p_tpu_torch.obs.report import _mine_trace_events, write_report

    tdir = tmp_path / "traces" / "edit"
    tdir.mkdir(parents=True)
    (tdir / "trace_edit.json").write_text(json.dumps(_chrome(SCENARIOS["single_card"],
                                                             modules=MODULES)))
    events = [{"event": "run_start", "run_id": "r", "t": 0.0},
              {"event": "trace", "name": "edit", "trace_dir": str(tdir), "t": 1.0},
              {"event": "trace", "name": "gone", "trace_dir": str(tmp_path / "nope"), "t": 1.5},
              {"event": "run_end", "t": 2.0}]
    mined = _mine_trace_events(events)
    extra = mined[len(events):]
    assert [(e["event"], e["name"], e["mined_from"]) for e in extra] == [
        ("trace_analysis", "edit", "trace")]
    assert extra[0]["num_events"] == len(SCENARIOS["single_card"])
    assert extra[0]["families"]["conv"] == 0.7e-6
    # a window already mined is left alone
    assert _mine_trace_events(mined)[len(mined):] == []
    led = tmp_path / "led.jsonl"
    led.write_text("".join(json.dumps(e) + "\n" for e in events))
    html_text = open(write_report(str(led))).read()
    assert "Device-trace breakdown" in html_text and "group_norm" in html_text
