"""The port's run ledger against the JAX CLI's: ``python -m
videop2p_tpu_torch.cli.run_videop2p --device cpu --tiny --fast`` with every
ported flag, twice on one ledger, and one JAX CLI run of the same tiny
config at 2 DDIM steps with the same flags: the same event kinds, the same
keys in each event, and the second run's ``regression_verdicts``.
"""

import pytest

import tests.test_torch_parity  # noqa: F401  (one intra-op thread a test process)
from tests.test_torch_cli_obs import port_runs  # noqa: F401
from tests.test_torch_slice import RABBIT

# event kinds only the JAX CLI writes: none (both runs skip the program
# analysis, --no_program_analysis, and both write its skip events)
JAX_ONLY_KINDS: set = set()
# run_start's JAX-specific metadata (the port writes torch's instead)
JAX_ONLY_START = {"jax_version", "device_kind", "device_count"}


def _schema(events):
    keys = {}
    for e in events:
        keys.setdefault(e["event"], set()).update(e)
    return keys


@pytest.fixture(scope="module")
def jax_schema(tmp_path_factory):
    """One JAX CLI run of the tiny config at 2 DDIM steps with every flag."""
    import videop2p_tpu.cli.run_videop2p as jax_cli
    from videop2p_tpu.obs.ledger import read_ledger

    root = tmp_path_factory.mktemp("jax")
    led = str(root / "led.jsonl")
    kw = dict(RABBIT, pretrained_model_path=str(root / "ckpt"), tiny=True, fast=True,
              video_len=2, ledger=led, telemetry=True, attn_maps=True, quality=True,
              report=True, latency=True, incidents=str(root / "inc"),
              program_analysis=False)
    steps = jax_cli.NUM_DDIM_STEPS
    jax_cli.NUM_DDIM_STEPS = 2
    try:
        with pytest.warns(UserWarning, match="RANDOM-INIT"):
            jax_cli.main(**kw)
    finally:
        jax_cli.NUM_DDIM_STEPS = steps
    return _schema(read_ledger(led))


def test_cli_ledger_has_jax_kinds_and_keys(port_runs, jax_schema):  # noqa: F811
    from videop2p_tpu_torch.obs.history import split_runs

    runs = split_runs(port_runs["events"])
    assert len(runs) == 2
    first = _schema(runs[0])
    assert set(first) == set(jax_schema) - JAX_ONLY_KINDS
    for kind, want in jax_schema.items():
        if kind in JAX_ONLY_KINDS:
            continue
        if kind == "run_start":
            assert want - JAX_ONLY_START <= first[kind]
        elif kind == "memory":
            assert want <= first[kind]
        else:
            assert first[kind] == want, kind
    second = _schema(runs[1])
    assert "regression_verdicts" in second and "regression_verdicts" not in first
    assert second["regression_verdicts"] == jax_schema.get(
        "regression_verdicts", {"event", "t", "baseline_run_id", "verdicts", "regressions",
                                "pass"})
