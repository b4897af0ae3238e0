"""The port's closed-loop load generator (``videop2p_tpu_torch/tools/
serve_loadgen.py``) on the CPU: its flags against JAX's ``tools/
serve_loadgen.py``, its pure helpers against JAX's, and the three modes end
to end at the tiny spec — ``--inproc --slo``, ``--url`` with the collector,
and ``--router 2`` with every plane on and a wrong-answer replica.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os

import pytest

from tests.test_torch_parity import TEST_THREADS  # noqa: F401 — one thread a process

from videop2p_tpu_torch.obs import read_ledger
from videop2p_tpu_torch.tools import serve_loadgen as loadgen

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = ("a rabbit is jumping", "a origami rabbit is jumping")


def _jax_loadgen():
    spec = importlib.util.spec_from_file_location(
        "serve_loadgen_under_torch_test", os.path.join(_REPO, "tools", "serve_loadgen.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_parser(monkeypatch):
    """JAX's loadgen builds its parser inside main(): catch it at parse."""
    caught = []

    def grab(self, args=None, namespace=None):
        caught.append(self)
        raise SystemExit(0)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(SystemExit):
            _jax_loadgen().main([])
    return caught[0]


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_flags_are_jax_flags_plus_device(monkeypatch):
    ours, theirs = _actions(loadgen.build_parser()), _actions(_jax_parser(monkeypatch))
    assert set(ours) == set(theirs) | {"device"}
    for dest, act in theirs.items():
        mine = ours[dest]
        assert (mine.option_strings, mine.default, mine.choices, mine.nargs, mine.type,
                mine.required, mine.const) == (
            act.option_strings, act.default, act.choices, act.nargs, act.type,
            act.required, act.const), dest
    assert ours["device"].default == "cuda"
    argv = ["--router", "2", "--requests", "8", "--concurrency", "2", "--collector",
            "--probes", "--slo", "--incidents", "d", "--replica_faults", "1:wrong:*",
            "--window_scale", "0.02", "--ledger", "fleet.jsonl", "--tiny"]
    assert vars(_jax_parser(monkeypatch).parse_args(argv)) == {
        k: v for k, v in vars(loadgen.build_parser().parse_args(argv)).items() if k != "device"}


@pytest.mark.parametrize("argv", [
    [],                                                   # no target
    ["--inproc", "--collector"],                          # no HTTP surface to scrape
    ["--inproc", "--probes"],                             # no HTTP surface to probe
    ["--faults", "fail@1", "--url", "http://127.0.0.1:1"],  # --faults needs --inproc
    ["--replica_faults", "0:unavail@1-9", "--inproc"],    # --replica_faults needs --router
    ["--inproc", "--router", "2"],                        # one target only
    ["--inproc", "--scheduler", "lifo"],                  # not a policy
])
def test_flag_validation_matches_jax(argv):
    """Each combination JAX's loadgen refuses at parse, the port refuses
    the same way (argparse's exit 2), before building anything."""
    with pytest.raises(SystemExit) as theirs:
        _jax_loadgen().main(list(argv))
    with pytest.raises(SystemExit) as ours:
        loadgen.main(list(argv))
    assert ours.value.code == theirs.value.code == 2


@pytest.mark.parametrize("weights, n", [({}, 4), ({"A": 5, "B": 1}, 12),
                                        ({"x": 1, "y": 1, "z": 3}, 10)])
def test_tenant_cycle_and_parsers_equal_jax(weights, n):
    jax = _jax_loadgen()
    assert loadgen.tenant_cycle(weights, n) == jax.tenant_cycle(weights, n)
    spec = ",".join(f"{k}:{v}" for k, v in weights.items())
    assert loadgen.parse_tenant_weights(spec) == jax.parse_tenant_weights(spec)
    assert loadgen._parse_replica_faults(["0:unavail@1-9", "1:wrong:*"]) == \
        jax._parse_replica_faults(["0:unavail@1-9", "1:wrong:*"])
    with pytest.raises(ValueError):
        loadgen._parse_replica_faults(["wrong"])


def _events(path):
    out = {}
    for e in read_ledger(path):
        out.setdefault(e["event"], []).append(e)
    return out


def test_inproc_slo_run(tmp_path, capsys):
    """``--inproc --tiny --device cpu --requests 4 --slo``: every request
    done, the reservoirs, the engine's health and cost rows, and the SLO
    objectives over the run's own summaries in one ledger."""
    ledger = str(tmp_path / "inproc.jsonl")
    rc = loadgen.main(["--inproc", "--tiny", "--device", "cpu", "--requests", "4",
                       "--concurrency", "2", "--steps", "2", "--slo", "--ledger", ledger,
                       "--out_dir", str(tmp_path / "out")])
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and record["done"] == 4 and record["errors"] == 0
    ev = _events(ledger)
    assert ev["run_start"][0]["cli"] == "serve_loadgen"
    assert {e["program"] for e in ev["execute_timing"]} >= {"loadgen_request", "loadgen_submit"}
    assert ev["serve_health"][0]["done"] == 4
    slo = {e["name"]: e for e in ev["slo_report"]}
    assert set(slo) == {"availability", "deadline_miss_rate", "served_p99_latency"}
    assert slo["availability"]["actual"] == 0.0 and slo["availability"]["compliant"]
    assert ev["loadgen_summary"][0]["done"] == 4


def test_url_mode_with_the_collector(tmp_path, capsys):
    """``--url`` against a tiny ``cli.serve``-style server with
    ``--collector``: the signals trail, the series snapshot and its sidecar
    land in the loadgen's ledger, with the remote engine's health."""
    from videop2p_tpu_torch.obs.tsdb import load_series_sidecar
    from videop2p_tpu_torch.serve import EditEngine, ProgramSpec
    from videop2p_tpu_torch.serve.http import EditServer

    eng = EditEngine(ProgramSpec(tiny=True, width=16, video_len=2, steps=4),
                     out_dir=str(tmp_path / "serve"), device="cpu")
    eng.warm(PROMPTS)
    server = EditServer(eng, port=0).start()
    try:
        ledger = str(tmp_path / "url.jsonl")
        rc = loadgen.main(["--url", server.url, "--requests", "3", "--concurrency", "2",
                           "--collector", "--scrape_interval_s", "0.05", "--window_scale",
                           "0.01", "--ledger", ledger, "--out_dir", str(tmp_path / "lg")])
    finally:
        server.close()
        eng.close()
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and record["done"] == 3
    assert record["signals"]["scrapes"] >= 1 and record["signals"]["scrape_errors"] == 0
    ev = _events(ledger)
    assert len(ev["fleet_signals"]) == record["signals"]["evaluations"] >= 1
    (snap,) = ev["fleet_series"]
    assert snap["sidecar"] == str(tmp_path / "lg" / "fleet_series.npz")
    assert any(k.startswith('up{replica="engine"}') for k in load_series_sidecar(snap["sidecar"]))
    assert ev["serve_health"][0]["done"] == 3 and "cost_attribution" in ev


def test_router_fleet_with_every_plane_and_a_wrong_replica(tmp_path, capsys):
    """``--router 2 --tiny --device cpu --collector --probes --slo
    --incidents DIR --replica_faults 1:wrong:*`` through the entry function,
    over a shared tiny set: the probe round before the load names replica 1
    (a tie of two answers goes to the first replica's, here a healthy
    engine's known answer), every load request is
    routed around it and the router's final /healthz shows it quarantined,
    every probe of replica 0 and of the router passes, a ``probe_failed``
    bundle holds the manifest, the flight ring and the targets, and the
    ledger carries the signals, the series and the SLO reports."""
    from videop2p_tpu_torch.obs.probe import ProbeSuite
    from videop2p_tpu_torch.serve import EditEngine, EditRequest, ProgramSet, ProgramSpec

    spec = ProgramSpec(tiny=True, width=16, video_len=2, steps=2)
    programs = ProgramSet(spec, device="cpu")
    request = {"image_path": "data/rabbit", "prompt": PROMPTS[0], "prompts": list(PROMPTS),
               "save_name": "loadgen"}
    known_eng = EditEngine(spec, out_dir=str(tmp_path / "known"), programs=programs,
                           device="cpu")
    known_eng.warm(PROMPTS)
    try:
        known = known_eng.result(known_eng.submit(EditRequest.from_dict(
            ProbeSuite(dict(request)).canary)), wait_s=120.0)
    finally:
        known_eng.close()
    assert known["status"] == "done"
    ledger, inc = str(tmp_path / "fleet.jsonl"), str(tmp_path / "incidents")
    rc = loadgen.main(
        ["--router", "2", "--tiny", "--device", "cpu", "--requests", "6", "--concurrency", "2",
         "--collector", "--probes", "--slo", "--incidents", inc,
         "--replica_faults", "1:wrong:*", "--window_scale", "0.02", "--scrape_interval_s",
         "0.1", "--probe_interval_s", "3600", "--ledger", ledger,
         "--out_dir", str(tmp_path / "out")],
        programs=programs)
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and record["done"] == 6 and record["errors"] == 0
    assert record["probes"]["quarantined"] == ["replica1"]
    assert record["probes"]["rounds"] == 1
    healthz = record["router_healthz"]["replicas"]
    assert healthz["replica1"]["probe_status"] == "quarantine" and healthz["replica1"]["quarantined"]
    # the router's canaries and the whole load went around replica 1
    assert record["router"]["per_replica"]["replica1"] == 0
    assert record["router"]["quarantined"] >= 6
    ev = _events(ledger)
    audits = ev["probe_audit"]
    assert audits[0]["divergent"] == "replica1" and audits[0]["hash_a"] == known["content_sha256"]
    probes = ev["probe"]
    assert len(probes) == 17
    assert all(p["ok"] for p in probes if p["target"] in ("replica0", "router"))
    assert all(p["ok"] for p in probes if p["target"] == "replica1")  # healthy but wrong
    replay = [p for p in probes if p["target"] == "replica0" and p["probe"] == "cached_replay"]
    assert all("src_err=0.0" in p["detail"] for p in replay)
    incidents = [e for e in ev["incident"] if e["trigger"] == "probe_failed"]
    assert incidents and sorted(os.listdir(incidents[0]["bundle"])) == [
        "flight.jsonl", "manifest.json", "series.npz", "targets.json"]
    targets = json.load(open(os.path.join(incidents[0]["bundle"], "targets.json")))
    assert {"scrape:router", "probe:replica1", "router:replica0"} <= set(targets)
    assert len(ev["fleet_signals"]) >= 2 and ev["fleet_signals"][-1]["quarantined"] == ["replica1"]
    assert os.path.isfile(ev["fleet_series"][0]["sidecar"])
    assert {e["name"] for e in ev["slo_report"]} >= {"availability", "served_p99_latency"}
    assert {e["label"] for e in ev["serve_health"]} == {"replica0", "replica1"}
    assert ev["router_health"][0]["per_replica"]["replica1"] >= 0
