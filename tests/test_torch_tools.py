"""The port's operator tools (``python -m videop2p_tpu_torch.tools.<name>``)
against JAX's root tools (``tools/<name>.py``) on the CPU.

Tools 1-8 (ledger_summary, obs_diff, edit_report, trace_view, cost_report,
fleet_dash, probe_report, incident_report) read the same inputs through
both and must give the same exit code, the same stdout and the same HTML
bytes. The inputs are written once per module: by the port's CLIs on the
CPU (two ``run_videop2p --fast --tiny`` runs on one ledger; a
``serve_loadgen --router 2`` fleet with every plane, tracing on and a
wrong replica, which writes a ``probe_failed`` bundle; the port's drive
ledger) and by the JAX package (the ledger helpers of its own tests, its
incident manager's bundle, JAX's drive ledger). ``obs_diff``'s gates: a
clean pair exits 0 and an injected regression exits 1 under
``TIMING_RULES``, ``SEAM_RULES`` and ``FAULT_RULES``, with the same verdict
rows in both tools.

``stream_drive``: its flags are JAX's plus ``--device``; on the weights both
packages share (``tests/test_torch_serve_jax.py``'s carried bundles, handed
to each tool's engine), a 5-frame drive of windows of 2, overlap 1, ends
within ``E2E_TOL`` of JAX's ``final.npy`` with every window ``done`` and
``src_err == 0.0``; a poisoned window's exit codes and
``--min_seam_psnr``'s equal JAX's; a SIGKILLed drive resumes from its
``--job_dir``.

The only output that differs from JAX's is each tool's own help text
(``--help``, and the usage text a usage error prints to stderr), which
names the port's module: those cases compare exit codes alone.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import io
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from tests.test_torch_parity import TEST_THREADS  # noqa: F401 — one thread a process

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("ledger_summary", "obs_diff", "edit_report", "trace_view", "cost_report",
         "fleet_dash", "probe_report", "incident_report", "stream_drive")
# the tools whose main() takes argv without the program name (argparse's)
_BARE_ARGV = ("trace_view", "stream_drive")

_JAX_TOOLS = {}


def jax_tool(name: str):
    """JAX's ``tools/<name>.py``, loaded from its file."""
    if name not in _JAX_TOOLS:
        spec = importlib.util.spec_from_file_location(
            f"{name}_under_torch_tools_test", os.path.join(REPO, "tools", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _JAX_TOOLS[name] = mod
    return _JAX_TOOLS[name]


def port_tool(name: str):
    return importlib.import_module(f"videop2p_tpu_torch.tools.{name}")


def call(mod, name: str, argv):
    """``mod.main`` on ``argv``: (exit code, stdout, stderr)."""
    argv = list(argv) if name in _BARE_ARGV else [f"{name}.py", *argv]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(argv)
    return rc, out.getvalue(), err.getvalue()


def both(name: str, argv, out_file=None):
    """The same call through JAX's tool and the port's: ((rc, stdout,
    stderr, the bytes of ``out_file``) of JAX's, of the port's). Each tool
    writes ``out_file`` afresh, so a page the port did not write cannot
    pass for its own."""
    results = []
    for mod in (jax_tool(name), port_tool(name)):
        if out_file and os.path.exists(out_file):
            os.remove(out_file)
        rc, out, err = call(mod, name, argv)
        page = open(out_file, "rb").read() if out_file and os.path.exists(out_file) else None
        results.append((rc, out, err, page))
    return results


def assert_same(results):
    (jrc, jout, jerr, jpage), (prc, pout, perr, ppage) = results
    assert prc == jrc, (jerr, perr)
    assert pout == jout
    assert perr == jerr
    assert ppage == jpage


def write_jsonl(path: str, events) -> str:
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(e) + "\n")
    return path


# ------------------------------------------------------------ the inputs ---


@pytest.fixture(scope="module")
def port_inputs(tmp_path_factory):
    """What the port's CLIs write on the CPU: two fast runs on one ledger
    (every observability flag on, the program analysis on), the runs split
    into a file each; a ``--router 2`` loadgen fleet with the collector,
    the prober, the SLO reports, tracing and a wrong replica 1 (its audit
    writes a ``probe_failed`` bundle)."""
    from _pytest.monkeypatch import MonkeyPatch

    from tests.test_torch_cli_obs import FLAGS, _config, _run_cli
    from videop2p_tpu_torch.obs import read_ledger, split_runs
    from videop2p_tpu_torch.serve import ProgramSet, ProgramSpec
    from videop2p_tpu_torch.tools import serve_loadgen

    root = tmp_path_factory.mktemp("port_inputs")
    runs = str(root / "runs.jsonl")
    argv = ["--config", _config(root), "--device", "cpu", "--tiny", "--fast", "--steps", "2",
            "--no_reuse_inversion", "--ledger", runs] + FLAGS
    mp = MonkeyPatch()
    try:
        # an earlier JAX CLI in this worker may have set the analysis' kill switch
        mp.delenv("VIDEOP2P_OBS_NO_ANALYSIS", raising=False)
        with pytest.warns(UserWarning, match="RANDOM-INIT"):
            _run_cli("videop2p_tpu_torch.cli.run_videop2p", argv, mp)
            _run_cli("videop2p_tpu_torch.cli.run_videop2p", argv, mp)
    finally:
        mp.undo()
    first, second = split_runs(read_ledger(runs))
    fleet, inc, out = str(root / "fleet.jsonl"), str(root / "incidents"), str(root / "fleet_out")
    programs = ProgramSet(ProgramSpec(tiny=True, width=16, video_len=2, steps=2), device="cpu")
    rc = serve_loadgen.main(
        ["--router", "2", "--tiny", "--device", "cpu", "--requests", "4", "--concurrency", "2",
         "--collector", "--probes", "--slo", "--incidents", inc, "--tracing",
         "--replica_faults", "1:wrong:*", "--window_scale", "0.02", "--scrape_interval_s", "0.1",
         "--probe_interval_s", "3600", "--ledger", fleet, "--out_dir", out, "--steps", "2"],
        programs=programs)
    assert rc == 0
    bundles = sorted(e["bundle"] for e in read_ledger(fleet)
                     if e["event"] == "incident" and e.get("bundle"))
    assert bundles
    replicas = sorted(os.path.join(out, d, f) for d in os.listdir(out)
                      if os.path.isdir(os.path.join(out, d))
                      for f in os.listdir(os.path.join(out, d)) if f.endswith(".jsonl"))
    return {"root": root, "runs": runs, "run_a": write_jsonl(str(root / "run_a.jsonl"), first),
            "run_b": write_jsonl(str(root / "run_b.jsonl"), second), "fleet": fleet,
            "router": os.path.join(out, "router_ledger.jsonl"), "replicas": replicas,
            "bundle": bundles[0]}


@pytest.fixture(scope="module")
def jax_inputs(tmp_path_factory):
    """What the JAX package writes, through the ledger helpers of its own
    tests and its incident manager."""
    from tests.test_cost import _cost_ledger, _showback_events
    from tests.test_fleet import _signals_ledger
    from tests.test_obs import _ANALYSIS_A, _write_run
    from tests.test_timing import _base_reservoir, _timing_ledger
    from videop2p_tpu.obs.incident import IncidentManager
    from videop2p_tpu.obs.ledger import RunLedger
    from videop2p_tpu.obs.tsdb import TimeSeriesStore

    root = tmp_path_factory.mktemp("jax_inputs")
    run = str(root / "run.jsonl")
    _write_run(run, "r1", "2026-01-01T00:00:00Z", {"edit": _ANALYSIS_A},
               phases=(("edit", 1.5), ("invert", 0.75)))
    timing = str(root / "timing.jsonl")
    _timing_ledger(timing, "t1", _base_reservoir(), trace_fields={
        "name": "edit_window", "trace_dir": "/nonexistent", "sidecar": "s.npz",
        "device_total_s": 1.5, "compute_s": 1.2, "collective_s": 0.4, "overlap_fraction": 0.5,
        "idle_s": 0.1, "num_events": 10, "families": {"fusion": 1.0, "conv": 0.2}})
    showback = str(root / "showback.jsonl")
    with RunLedger(showback, run_id="s1", device_info=False) as led:
        for e in _showback_events()[1:]:
            led.event(e["event"], **{k: v for k, v in e.items() if k != "event"})
    ts = TimeSeriesStore()
    for i in range(8):
        ts.add("queue_depth", float(i), float(i % 3), {"replica": "replica0"})
    mgr = IncidentManager(str(root / "inc"), tsdb=ts, cooldown_s=3600.0)
    led = RunLedger(str(root / "inc_ledger.jsonl"), run_id="unit", device_info=False)
    mgr.attach_ledger(led)
    mgr.note_fingerprint("engine:unit", "fp-abc")
    mgr.register_target("engine:unit", lambda: {"healthz": {"status": "ok"}, "metrics": {}})
    mgr.register_target("router:dead", lambda: (_ for _ in ()).throw(OSError("conn refused")))
    led.event("fault", kind="hang", detail="attempt=5")
    bundle = mgr.trigger("breaker_open", detail="closed->open", trips=1)
    led.close()
    return {"run": run, "timing": timing, "showback": showback,
            "cost": _cost_ledger(str(root / "cost.jsonl")),
            "cost_pricier": _cost_ledger(str(root / "cost_pricier.jsonl"), cpr=0.3),
            "signals": _signals_ledger(str(root / "signals.jsonl")),
            "signals_burned": _signals_ledger(str(root / "burned.jsonl"), alerts=1,
                                              advice="grow"),
            "inc_ledger": str(root / "inc_ledger.jsonl"), "bundle": bundle}


# ------------------------------------------------- tools 1-8: the parity ---


def _paths(port_inputs, jax_inputs, names):
    pool = {f"port_{k}": v for k, v in port_inputs.items()}
    pool.update({f"jax_{k}": v for k, v in jax_inputs.items()})
    return [pool[n] for n in names]


@pytest.mark.parametrize("inputs", [
    ["port_runs"], ["port_run_b"], ["port_fleet"], ["port_router"], ["jax_run"],
    ["jax_timing"], ["jax_showback"], ["jax_signals"], ["jax_inc_ledger"],
])
def test_ledger_summary_matches_jax(inputs, port_inputs, jax_inputs):
    results = both("ledger_summary", _paths(port_inputs, jax_inputs, inputs))
    assert_same(results)
    assert results[0][0] == 0 and results[0][1]
    if inputs == ["port_runs"]:
        assert "cached_invert_edit" in results[1][1]


@pytest.mark.parametrize("inputs, extra", [
    (["port_run_a", "port_run_b"], []),
    (["port_run_a", "port_run_b"], ["--json"]),
    (["port_runs", "port_runs"], []),
    (["port_fleet", "port_fleet"], ["--json"]),
    (["port_router", "port_fleet"], []),
    (["jax_cost", "jax_cost_pricier"], ["--json"]),
    (["jax_cost_pricier", "jax_cost"], []),
    (["jax_signals", "jax_signals_burned"], ["--json"]),
    (["jax_signals", "jax_signals_burned"], ["--threshold-scale", "100"]),
    (["jax_run", "port_run_a"], []),
])
def test_obs_diff_matches_jax(inputs, extra, port_inputs, jax_inputs):
    results = both("obs_diff", [*extra, *_paths(port_inputs, jax_inputs, inputs)])
    assert_same(results)
    assert results[0][0] in (0, 1)
    if inputs[0] == inputs[1]:
        assert results[0][0] == 0  # a ledger against itself


def test_obs_diff_history_and_usage_match_jax(port_inputs, tmp_path):
    hist = tmp_path / "hist"
    hist.mkdir()
    for name in ("run_a", "run_b"):
        (hist / f"{name}.jsonl").write_bytes(open(port_inputs[name], "rb").read())
    for argv in (["--history", str(hist)], ["--history", str(hist), port_inputs["run_b"]],
                 ["--history", str(tmp_path / "empty_dir_missing")]):
        assert_same(both("obs_diff", argv))
    # unreadable input and usage errors: exit 2 in both (the usage text is
    # each tool's own)
    assert_same(both("obs_diff", [str(tmp_path / "nope.jsonl"), port_inputs["runs"]]))
    for argv in ([port_inputs["runs"]], ["--history", str(hist), "a", "b"]):
        (jrc, *_), (prc, *_) = both("obs_diff", argv)
        assert jrc == prc == 2


@pytest.mark.parametrize("inputs", [["port_runs"], ["jax_run"], ["port_fleet"]])
def test_edit_report_matches_jax(inputs, port_inputs, jax_inputs, tmp_path):
    page = str(tmp_path / "report.html")
    results = both("edit_report", [*_paths(port_inputs, jax_inputs, inputs), "-o", page], page)
    assert_same(results)
    assert results[0][0] == 0 and results[1][3]
    if inputs == ["port_runs"]:
        text = results[1][3].decode()
        assert "Per-word cross-attention heatmaps" in text and "Edit quality" in text


@pytest.mark.parametrize("extra", [[], ["--json"], ["--trace", "0"]])
def test_trace_view_matches_jax(extra, port_inputs):
    ledgers = [port_inputs["fleet"], port_inputs["router"], *port_inputs["replicas"]]
    results = both("trace_view", [*extra, *ledgers])
    assert_same(results)
    assert results[0][0] == 0
    if extra == ["--json"]:
        doc = json.loads(results[1][1])
        full = [t for t in doc["traces"]
                if set(t["segments"]) == {"queue", "resolve", "dispatch", "decode"}]
        assert full, doc["traces"][:2]


def test_trace_view_edge_cases_match_jax(port_inputs, jax_inputs, tmp_path):
    for argv in ([port_inputs["runs"]], [jax_inputs["inc_ledger"]],
                 ["--json", jax_inputs["inc_ledger"]], [str(tmp_path / "nope.jsonl")]):
        assert_same(both("trace_view", argv))


@pytest.mark.parametrize("name, inputs", [
    ("cost_report", ["port_fleet"]), ("cost_report", ["port_runs"]),
    ("cost_report", ["jax_showback"]), ("cost_report", ["jax_cost"]),
    ("fleet_dash", ["port_fleet"]), ("fleet_dash", ["jax_signals"]),
    ("fleet_dash", ["port_runs"]),
    ("probe_report", ["port_fleet"]), ("probe_report", ["port_runs"]),
    ("incident_report", ["port_bundle"]), ("incident_report", ["jax_bundle"]),
])
def test_html_tools_match_jax(name, inputs, port_inputs, jax_inputs, tmp_path):
    page = str(tmp_path / "page.html")
    argv = [*_paths(port_inputs, jax_inputs, inputs), "--out", page, "--title", "T"]
    results = both(name, argv, page)
    assert_same(results)
    assert results[0][0] == 0 and results[1][3].startswith(b"<!doctype html>")


@pytest.mark.parametrize("name", ["ledger_summary", "cost_report", "fleet_dash",
                                  "probe_report", "incident_report", "edit_report"])
def test_unreadable_input_and_usage_match_jax(name, tmp_path):
    assert_same(both(name, [str(tmp_path / "nope")]))
    (jrc, *_), (prc, *_) = both(name, [])
    assert jrc == prc == 2


# ------------------------------------------------------------ stream_drive ---


class _Parsed(Exception):
    def __init__(self, parser):
        super().__init__("parsed")
        self.parser = parser


def _parser_of(main, monkeypatch):
    """The ArgumentParser ``main`` builds, caught at its parse."""
    def grab(self, args=None, namespace=None):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed) as caught:
            main([])
    return caught.value.parser


def test_stream_drive_flags_are_jax_flags_plus_device(monkeypatch):
    ours = {a.dest: a for a in _parser_of(port_tool("stream_drive").main, monkeypatch)._actions
            if a.dest != "help"}
    theirs = {a.dest: a for a in _parser_of(jax_tool("stream_drive").main, monkeypatch)._actions
              if a.dest != "help"}
    assert set(ours) == set(theirs) | {"device"}
    for dest, act in theirs.items():
        mine = ours[dest]
        assert (mine.option_strings, mine.default, mine.choices, mine.nargs, mine.type,
                mine.const) == (act.option_strings, act.default, act.choices, act.nargs,
                                act.type, act.const), dest
    assert ours["device"].default == "cuda"


DRIVE = ["--frames", "5", "--video_len", "2", "--overlap", "1", "--steps", "2",
         "--max_inflight", "1"]


@pytest.fixture(scope="module")
def shared_sets():
    """Each tool's ``EditEngine`` routed through one program set per
    package on the carried tiny weights (the JAX set's programs compile
    once for every drive of this module)."""
    from _pytest.monkeypatch import MonkeyPatch

    import videop2p_tpu.serve as jax_serve
    from tests.test_torch_serve_jax import paired_bundles

    import videop2p_tpu_torch.serve as port_serve

    jax_bundle, port_bundle = paired_bundles()
    jax_engine, port_engine = jax_serve.EditEngine, port_serve.EditEngine
    sets = {}

    def jax_wrapped(spec, **kw):
        if "jax" not in sets:
            sets["jax"] = jax_serve.ProgramSet(spec, bundle=jax_bundle)
        return jax_engine(spec, programs=sets["jax"], **kw)

    def port_wrapped(spec, **kw):
        assert kw["device"] == "cpu"
        if "port" not in sets:
            sets["port"] = port_serve.ProgramSet(spec, bundle=port_bundle, device="cpu")
        return port_engine(spec, programs=sets["port"], **kw)

    mp = MonkeyPatch()
    mp.setattr(jax_serve, "EditEngine", jax_wrapped)
    mp.setattr(port_serve, "EditEngine", port_wrapped)
    yield sets
    mp.undo()


def drive_both(root, extra):
    """One drive through each tool on the shared weights: {"jax": (rc,
    record, job_dir, ledger), "port": ...}."""
    out = {}
    for side, dev in (("jax", []), ("port", ["--device", "cpu"])):
        mod = jax_tool("stream_drive") if side == "jax" else port_tool("stream_drive")
        job, ledger = str(root / f"{side}_job"), str(root / f"{side}_ledger.jsonl")
        rc, stdout, _ = call(mod, "stream_drive", [*DRIVE, *extra, "--job_dir", job,
                                                   "--ledger", ledger, *dev])
        out[side] = (rc, json.loads(stdout.strip().splitlines()[-1]), job, ledger)
    return out


@pytest.fixture(scope="module")
def drives(shared_sets, tmp_path_factory):
    """One clean 5-frame drive (windows of 2, overlap 1) through JAX's tool
    and one through the port's, on the shared weights."""
    return drive_both(tmp_path_factory.mktemp("drives"), [])


def test_stream_drive_matches_jax_on_shared_weights(drives):
    from tests.test_torch_serve_jax import E2E_TOL

    finals = {}
    for side, (rc, rec, job, ledger) in drives.items():
        assert rc == 0, (side, rec)
        health = rec["stream_health"]
        assert health["windows_done"] == 4 and health["windows_passthrough"] == 0, side
        assert health["src_err_max"] == 0.0, side
        assert [w["status"] for w in rec["windows"]] == ["done"] * 4, side
        assert all(w["src_err"] == 0.0 for w in rec["windows"]), side
        assert rec["final"] == os.path.join(job, "final.npy") and rec["ledger"] == ledger
        finals[side] = np.load(rec["final"])
    assert finals["port"].shape == finals["jax"].shape == (5, 16, 16, 3)
    np.testing.assert_allclose(finals["port"], finals["jax"], atol=E2E_TOL, rtol=0)
    assert set(drives["port"][1]) == set(drives["jax"][1])


@pytest.mark.parametrize("extra, rc", [
    # poisoned windows pass through at once (no window-level retry)
    (["--faults", "unavail@2-99", "--max_retries", "0", "--window_retries", "0"], 1),
    (["--faults", "unavail@2-99", "--max_retries", "0", "--window_retries", "0",
      "--allow_passthrough"], 0),
    (["--min_seam_psnr", "99"], 1),
])
def test_stream_drive_exit_codes_match_jax(extra, rc, shared_sets, tmp_path):
    runs = drive_both(tmp_path, extra)
    (jrc, jrec, *_), (prc, prec, *_) = runs["jax"], runs["port"]
    assert prc == jrc == rc
    for key in ("windows_done", "windows_passthrough", "windows_failed"):
        assert prec["stream_health"][key] == jrec["stream_health"][key], key


@pytest.mark.parametrize("name", ["ledger_summary", "obs_diff"])
def test_tools_read_both_drive_ledgers_alike(name, drives):
    """JAX's drive ledger and the port's through both tools."""
    jax_ledger, port_ledger = drives["jax"][3], drives["port"][3]
    argv = [jax_ledger] if name == "ledger_summary" else ["--json", jax_ledger, port_ledger]
    assert_same(both(name, argv))


def _inject(src: str, dst: str, kind: str, program=None, scale=None, values=None) -> str:
    """A copy of ``src`` with each ``kind`` event's fields multiplied by
    ``scale``'s factors and set to ``values``' values."""
    out = []
    for line in open(src):
        e = json.loads(line)
        if e.get("event") == kind and (program is None or e.get("program") == program):
            e.update({k: e[k] * f for k, f in (scale or {}).items()}, **(values or {}))
        out.append(e)
    return write_jsonl(dst, out)


@pytest.mark.parametrize("rules", ["TIMING_RULES", "SEAM_RULES", "FAULT_RULES"])
def test_obs_diff_gates_match_jax(rules, port_inputs, drives, tmp_path):
    """A clean pair exits 0 and an injected regression exits 1 in both
    tools, with the same verdict rows; every regression the injection
    causes is a rule of ``rules``."""
    from videop2p_tpu_torch.obs import history

    base = drives["port"][3]
    if rules == "TIMING_RULES":
        base = port_inputs["run_b"]
        bad = _inject(base, str(tmp_path / "bad.jsonl"), "execute_timing", "cached_invert_edit",
                      scale={k: 2.0 for k in ("blocked_p50_s", "blocked_p95_s",
                                              "blocked_p99_s", "blocked_max_s")})
    elif rules == "SEAM_RULES":
        bad = _inject(base, str(tmp_path / "bad.jsonl"), "stream_health",
                      scale={"seam_min_psnr": 0.5}, values={"windows_passthrough": 1})
    else:
        bad = _inject(base, str(tmp_path / "bad.jsonl"), "serve_health",
                      values={"errors": 2, "error_rate": 0.5, "breaker_trips": 1})
    clean = both("obs_diff", ["--json", base, base])
    assert_same(clean)
    assert clean[0][0] == 0
    gated = both("obs_diff", ["--json", base, bad])
    assert_same(gated)
    assert gated[0][0] == 1
    verdict = json.loads(gated[1][1])
    names = {r.name for r in getattr(history, rules)}
    assert verdict["regressions"] and {r["rule"] for r in verdict["regressions"]} <= names


def test_killed_stream_drive_resumes_from_its_job_dir(tmp_path):
    """SIGKILL the drive while its third window's dispatch is held by an
    injected hang (two windows persisted); the rerun skips them and its
    ``final.npy`` equals an uninterrupted drive's bit for bit."""
    def cmd(job, *extra):
        return [sys.executable, "-m", "videop2p_tpu_torch.tools.stream_drive", "--device",
                "cpu", "--frames", "7", *DRIVE[2:], "--job_dir", job, *extra]

    job = str(tmp_path / "kill_job")
    proc = subprocess.Popen(cmd(job, "--faults", "hang@3:30"), cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    manifest = os.path.join(job, "manifest.json")
    deadline, killed = time.perf_counter() + 120.0, False
    try:
        while time.perf_counter() < deadline and proc.poll() is None:
            try:
                with open(manifest) as f:
                    done = sum(w["status"] == "done" for w in json.load(f)["windows"])
            except (OSError, ValueError):
                done = 0
            if done >= 2:
                proc.send_signal(signal.SIGKILL)
                killed = True
                break
            time.sleep(0.05)
    finally:
        if proc.poll() is None and not killed:
            proc.kill()
        proc.wait(timeout=60)
    assert killed, proc.stdout.read()
    assert not os.path.exists(os.path.join(job, "final.npy"))
    out = subprocess.run(cmd(job), cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    health = json.loads(out.stdout.strip().splitlines()[-1])["stream_health"]
    assert health["windows_total"] == 6 and health["windows_skipped"] == 2
    assert health["windows_done"] == 4
    assert health["src_err_max"] == 0.0
    ref = str(tmp_path / "ref_job")
    out = subprocess.run(cmd(ref), cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert np.array_equal(np.load(os.path.join(job, "final.npy")),
                          np.load(os.path.join(ref, "final.npy")))


# ------------------------------------------------------------ independence ---


def test_tools_import_nothing_of_jax():
    """Each of the nine modules, and the serving and streaming packages
    ``stream_drive`` runs, under an import hook that refuses ``jax`` and
    ``videop2p_tpu``; each tool's ``--help`` exits 0."""
    script = textwrap.dedent(f"""
        import importlib.abc, runpy, sys

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "videop2p_tpu"):
                    raise ImportError("refused: " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        sys.path.insert(0, {REPO!r})
        import videop2p_tpu_torch.serve, videop2p_tpu_torch.stream  # noqa: F401
        for name in {list(TOOLS)!r}:
            sys.argv = [name, "--help"]
            try:
                runpy.run_module("videop2p_tpu_torch.tools." + name, run_name="__main__")
            except SystemExit as e:
                assert e.code in (0, None), (name, e.code)
            else:
                raise AssertionError(name + " --help did not exit")
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "videop2p_tpu"))
        assert not bad, bad
        print("independent")
    """)
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "independent"
