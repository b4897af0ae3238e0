"""The port's serving entry point, ``python -m videop2p_tpu_torch.cli.serve``:
it parses the JAX CLI's flags (plus ``--device``), refuses what is not
ported naming the ROADMAP item, and with ``--device cpu`` serves a request
over HTTP in a subprocess and drains on SIGTERM, exiting 0 with
``serve_health`` in its ledger.
"""

import os
import signal
import socket
import subprocess
import sys
import time

import pytest

from tests.test_torch_parity import TEST_THREADS  # noqa: F401 — one thread a process

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_cli_parses_the_jax_flags():
    from videop2p_tpu.cli.serve import build_parser as jax_parser

    from videop2p_tpu_torch.cli.serve import build_parser

    ours, theirs = _actions(build_parser()), _actions(jax_parser())
    assert set(ours) == set(theirs) | {"device"}
    for dest, act in theirs.items():
        mine = ours[dest]
        assert (mine.option_strings, mine.default, mine.choices, mine.nargs, mine.type) == (
            act.option_strings, act.default, act.choices, act.nargs, act.type), dest
    assert ours["device"].default == "cuda"
    argv = ["--checkpoint", "ck", "--steps", "4", "--step_buckets", "2", "1",
            "--reuse_buckets", "uniform:2", "--tenants", "A:5,B:1", "--faults", "fail@2",
            "--scheduler", "fair", "--max_batch_wait_ms", "20", "--tracing"]
    a, b = build_parser().parse_args(argv), jax_parser().parse_args(argv)
    assert {k: v for k, v in vars(a).items() if k != "device"} == vars(b)


@pytest.mark.parametrize("argv, item", [
    (["--mesh", "1,2,1"], "item 13"),
    (["--ring_variant", "bidir"], "item 13"),
    (["--tp_collectives", "psum_scatter"], "item 13"),
    (["--batch_dispatch", "vmap"], "item 13"),
    (["--slo"], "item 14"),
    (["--incidents", "incidents_dir"], "item 14"),
])
def test_cli_refuses_what_is_not_ported(argv, item, monkeypatch):
    """The multi-GPU flags (item 13) raise; ``--slo`` and ``--incidents``
    (item 14's rest) are ported: they reach the engine as its options."""
    from videop2p_tpu_torch.cli.serve import main

    if item == "item 13":
        with pytest.raises(NotImplementedError, match=item):
            main(["--device", "cpu", "--tiny", *argv])
        return
    import videop2p_tpu_torch.serve as serve

    seen = {}

    def engine(spec, **kw):
        seen.update(kw)
        raise KeyboardInterrupt  # stop before warming and serving

    monkeypatch.setattr(serve, "EditEngine", engine)
    with pytest.raises(KeyboardInterrupt):
        main(["--device", "cpu", "--tiny", *argv])
    assert seen["slo"] is (argv == ["--slo"])
    assert seen["incidents"] == (argv[1] if argv[0] == "--incidents" else None)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serves_on_the_cpu_and_drains_on_sigterm(tmp_path):
    from videop2p_tpu_torch.obs import read_ledger
    from videop2p_tpu_torch.serve import EngineClient

    port = _free_port()
    out_dir = tmp_path / "serve_out"
    cmd = [sys.executable, "-m", "videop2p_tpu_torch.cli.serve", "--device", "cpu", "--tiny",
           "--steps", "2", "--video_len", "2", "--port", str(port), "--out_dir", str(out_dir),
           "--warm_prompts", "a rabbit is jumping", "a origami rabbit is jumping",
           "--drain_s", "30"]
    env = dict(os.environ, PYTHONPATH=REPO)
    log = open(tmp_path / "serve.log", "w")
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        client = EngineClient(f"http://127.0.0.1:{port}", timeout_s=30.0, retries=0)
        deadline = time.perf_counter() + 120
        while True:
            assert proc.poll() is None, (tmp_path / "serve.log").read_text()
            try:
                health = client.healthz()
                break
            except Exception:  # noqa: BLE001 — not listening yet
                assert time.perf_counter() < deadline, (tmp_path / "serve.log").read_text()
                time.sleep(0.2)
        assert health["ok"] and health["warm"]["steps"] == [2]
        rec = client.wait(client.submit({
            "image_path": os.path.join(REPO, "data", "rabbit"),
            "prompt": "a rabbit is jumping",
            "prompts": ["a rabbit is jumping", "a origami rabbit is jumping"],
            "save_name": "origami"}), timeout_s=120.0)
        assert rec["status"] == "done", rec.get("error")
        assert rec["src_err"] == 0.0 and os.path.isfile(rec["edit_gif"])
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0, (tmp_path / "serve.log").read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    kinds = [e["event"] for e in read_ledger(str(out_dir / "serve_ledger.jsonl"))]
    # the ledger closes with the health summary: after it only the shutdown
    # marker, the reservoirs' flush and the run's end
    tail = kinds[kinds.index("serve_health") + 1:]
    assert "serve_request" in kinds[:kinds.index("serve_health")]
    assert set(tail) == {"serve_shutdown", "execute_timing", "run_end"}
    assert kinds[-1] == "run_end"
    assert "SIGTERM" in (tmp_path / "serve.log").read_text()
