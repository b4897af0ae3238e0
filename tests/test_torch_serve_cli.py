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

import numpy as np
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
    """Every flag is ported. The multi-GPU flags (item 13): a
    model-parallel ``--mesh`` in a plain process is not the world and
    raises naming torchrun; ``--ring_variant`` / ``--tp_collectives``
    reach the engine's spec and ``--batch_dispatch vmap`` its options.
    ``--slo`` and ``--incidents`` (item 14's rest) reach the engine as its
    options."""
    from videop2p_tpu_torch.cli.serve import main

    if argv[0] == "--mesh":
        with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
            main(["--device", "cpu", "--tiny", *argv])
        return
    import videop2p_tpu_torch.serve as serve

    seen = {}

    def engine(spec, **kw):
        seen.update(kw, spec=spec)
        raise KeyboardInterrupt  # stop before warming and serving

    monkeypatch.setattr(serve, "EditEngine", engine)
    with pytest.raises(KeyboardInterrupt):
        main(["--device", "cpu", "--tiny", *argv])
    assert seen["slo"] is (argv == ["--slo"])
    assert seen["incidents"] == (argv[1] if argv[0] == "--incidents" else None)
    assert seen["batch_dispatch"] == (argv[1] if argv[0] == "--batch_dispatch" else "scan")
    assert seen["spec"].ring_variant == (argv[1] if argv[0] == "--ring_variant" else "overlap")
    assert seen["spec"].tp_collectives == (argv[1] if argv[0] == "--tp_collectives"
                                           else "gspmd")
    assert seen["programs"] is None


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


def _serve_one_request(tmp_path, name, launcher, extra):
    """A CLI server (``launcher`` + ``-m videop2p_tpu_torch.cli.serve``) on
    the CPU: one request, then SIGTERM to the process that binds the port
    (its pid is in the ``listening`` line). Returns (the record, its edit
    GIF's bytes and frames, the launcher's exit code, the log)."""
    from PIL import Image, ImageSequence

    from videop2p_tpu_torch.serve import EngineClient

    port = _free_port()
    cmd = [*launcher, "-m", "videop2p_tpu_torch.cli.serve", "--device", "cpu", "--tiny",
           "--steps", "2", "--video_len", "2", "--port", str(port),
           "--out_dir", str(tmp_path / name), "--warm_prompts", "a rabbit is jumping",
           "a origami rabbit is jumping", "--drain_s", "30", *extra]
    env = dict(os.environ, PYTHONPATH=REPO)
    log_path = tmp_path / f"{name}.log"
    log = open(log_path, "w")
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        client = EngineClient(f"http://127.0.0.1:{port}", timeout_s=30.0, retries=0)
        deadline = time.perf_counter() + 180
        while True:
            assert proc.poll() is None, log_path.read_text()
            try:
                client.healthz()
                break
            except Exception:  # noqa: BLE001 — not listening yet
                assert time.perf_counter() < deadline, log_path.read_text()
                time.sleep(0.2)
        rec = client.wait(client.submit({
            "image_path": os.path.join(REPO, "data", "rabbit"),
            "prompt": "a rabbit is jumping",
            "prompts": ["a rabbit is jumping", "a origami rabbit is jumping"],
            "save_name": "origami"}), timeout_s=120.0)
        pid = int(log_path.read_text().split("(pid ")[1].split(",")[0])
        os.kill(pid, signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        log.close()
    gif = open(rec["edit_gif"], "rb").read() if rec.get("edit_gif") else b""
    with Image.open(rec["edit_gif"]) as im:
        frames = np.stack([np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)])
    return rec, gif, frames, rc, log_path.read_text()


def test_cli_serves_a_mesh_of_two_ranks(tmp_path):
    """``torchrun --nproc_per_node 2 -m videop2p_tpu_torch.cli.serve --mesh
    1,2,1`` on gloo: rank 0 answers the request (done, src_err 0.0) with
    the one-process CLI's edit GIF byte for byte, SIGTERM to it drains and
    releases rank 1, and torchrun exits 0."""
    one, one_gif, one_frames, rc1, _ = _serve_one_request(tmp_path, "one", [sys.executable], [])
    rec, gif, frames, rc, log = _serve_one_request(
        tmp_path, "mesh", [sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", "2"], ["--mesh", "1,2,1"])
    for r in (one, rec):
        assert r["status"] == "done" and r["src_err"] == 0.0, r
    assert rc1 == 0 and rc == 0, log
    assert "rank released after" in log
    assert frames.shape == one_frames.shape == (2, 16, 16, 3)
    assert gif == one_gif


def test_router_spawns_a_mesh_child_under_torchrun(tmp_path):
    """``cli.router --spawn 1 --serve_arg=--mesh --serve_arg=1,2,1`` on the
    CPU: the child starts under ``torch.distributed.run`` with 2 gloo
    ranks and answers a request through the router (done, src_err 0.0).
    SIGTERM to the router stops it: the supervisor signals the child's
    rank 0 (not the launcher), which drains, writes ``serve_health`` and
    releases rank 1; the router exits 0."""
    from videop2p_tpu_torch.obs import read_ledger
    from videop2p_tpu_torch.serve import EngineClient

    port = _free_port()
    out = tmp_path / "fleet"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "videop2p_tpu_torch.cli.router", "--spawn", "1", "--device",
         "cpu", "--tiny", "--steps", "2", "--video_len", "2", "--port", str(port),
         "--out_dir", str(out), "--serve_arg=--mesh", "--serve_arg=1,2,1",
         "--serve_arg=--warm_prompts", "--serve_arg=a rabbit is jumping",
         "--serve_arg=a origami rabbit is jumping"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        client = EngineClient(f"http://127.0.0.1:{port}", timeout_s=30.0, retries=0)
        deadline = time.perf_counter() + 180.0
        while True:
            assert proc.poll() is None, proc.stdout.read()
            assert time.perf_counter() < deadline, "the fleet did not come up in 180 s"
            try:
                health = client.healthz()
                break
            except Exception:  # noqa: BLE001 — not listening yet
                time.sleep(0.5)
        assert health["healthy"] == 1, health
        rec = client.wait(client.submit({
            "image_path": os.path.join(REPO, "data", "rabbit"),
            "prompt": "a rabbit is jumping",
            "prompts": ["a rabbit is jumping", "a origami rabbit is jumping"],
            "save_name": "origami"}), timeout_s=120.0)
        assert rec["status"] == "done" and rec["src_err"] == 0.0, rec.get("error")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    log = (out / "replica0" / "serve.log").read_text()
    assert rc == 0, proc.stdout.read() + log
    assert "drives the mesh 1,2,1" in log and "SIGTERM — draining" in log, log
    assert "rank released after" in log, log
    assert "death signal" not in log, log
    kinds = [e["event"] for e in read_ledger(str(out / "replica0" / "serve_ledger.jsonl"))]
    assert "serve_health" in kinds, kinds[-5:]
