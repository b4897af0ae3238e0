"""Null-text optimization's telemetry (``telemetry=``) against the JAX
package's, on the CPU in float32 with ``tests/test_torch_nulltext.py``'s
tiny UNet, trajectory and embeddings, and its ``outer_chunk`` programs in
the run ledger.

Tolerances: each outer step's latent statistics within 1e-4 relative (the
embeddings themselves differ by Adam's sign steps, within 0.02:
``tests/test_torch_nulltext.py``); the NaN / inf counts exactly; the
embeddings with telemetry on = off, and chunked = unchunked, bit for bit.
"""

import numpy as np
import pytest
import torch

import tests.test_torch_parity  # noqa: F401  (one intra-op thread a test process)


@pytest.fixture(scope="module")
def null_text_setup():
    from tests.test_torch_nulltext import setup as nulltext_setup

    return nulltext_setup.__wrapped__()


@pytest.mark.parametrize("kw", [
    dict(num_inner_steps=2),
    dict(num_inner_steps=3, null_text_mode="amortized"),
], ids=["optimize", "amortized"])
def test_null_text_telemetry_matches_jax(null_text_setup, kw):
    """Each outer step's latent statistics against JAX's (the advanced
    latent), within 1e-4 relative
    (the embeddings themselves differ by Adam's sign steps:
    ``tests/test_torch_nulltext.py``); the counts exactly; the embeddings
    with telemetry on = off, bit for bit."""
    import jax

    from videop2p_tpu.pipelines.inversion import null_text_optimization as jax_null_text

    from tests.test_torch_nulltext import STEPS
    from tests.test_torch_parity import t
    from videop2p_tpu_torch.obs.telemetry import decode_null_text_stats
    from videop2p_tpu_torch.pipelines.inversion import null_text_optimization

    s = null_text_setup
    with jax.default_matmul_precision("highest"):
        want = jax_null_text(s["jfn"], s["params"], s["jsched"], s["traj"], s["cond"],
                             s["uncond"], num_inference_steps=STEPS, return_losses=True,
                             return_inner_steps=True, telemetry=True, **kw)
    args = (s["pfn"], s["psched"], t(s["traj"]), t(s["cond"]), t(s["uncond"]))
    emb, losses, inner, tel = null_text_optimization(
        *args, num_inference_steps=STEPS, return_losses=True, return_inner_steps=True,
        telemetry=True, **kw)
    assert sorted(tel) == sorted(want[3])
    for k in ("nan_count", "inf_count"):
        assert tel[k].tolist() == np.asarray(want[3][k]).tolist()
    for k in ("abs_max", "mean"):
        np.testing.assert_allclose(tel[k].numpy(), np.asarray(want[3][k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    rec = decode_null_text_stats({"final_loss": losses, "inner_steps": inner,
                                  "latent_stats": tel})
    assert rec["latent"]["steps"] == STEPS and rec["latent"]["nan_total"] == 0
    off = null_text_optimization(*args, num_inference_steps=STEPS, **kw)
    assert torch.equal(emb, off)


def test_hybrid_null_text_telemetry_changes_no_output(null_text_setup):
    """"hybrid": the statistics of each outer step's last inner
    reconstruction (JAX's; its vmapped program takes too long to compile
    here to hold it against), one a step, the embeddings unchanged."""
    from tests.test_torch_nulltext import STEPS
    from tests.test_torch_parity import t
    from videop2p_tpu_torch.pipelines.inversion import null_text_optimization

    s = null_text_setup
    args = (s["pfn"], s["psched"], t(s["traj"]), t(s["cond"]), t(s["uncond"]))
    kw = dict(num_inference_steps=STEPS, null_text_mode="hybrid", hybrid_inner_steps=2)
    emb, tel = null_text_optimization(*args, telemetry=True, **kw)
    assert tel["abs_max"].shape == (STEPS,) and tel["nan_count"].tolist() == [0] * STEPS
    assert torch.equal(emb, null_text_optimization(*args, **kw))


def test_null_text_chunks_are_instrumented_programs(null_text_setup, tmp_path):
    """``outer_chunk``: each chunk is one "null_text_chunked" program call
    (JAX's label), with the same numbers as the unchunked run."""
    from tests.test_torch_nulltext import STEPS
    from tests.test_torch_parity import t
    from videop2p_tpu_torch.obs import RunLedger, read_ledger
    from videop2p_tpu_torch.pipelines.inversion import null_text_optimization

    s = null_text_setup
    args = (s["pfn"], s["psched"], t(s["traj"]), t(s["cond"]), t(s["uncond"]))
    kw = dict(num_inference_steps=STEPS, num_inner_steps=2, return_losses=True)
    whole = null_text_optimization(*args, **kw)
    path = str(tmp_path / "l.jsonl")
    with RunLedger(path, device="cpu", latency=True):
        chunked = null_text_optimization(*args, outer_chunk=2, **kw)
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])
    events = read_ledger(path)
    calls = [e for e in events if e["event"] == "program_call"]
    assert [c["program"] for c in calls] == ["null_text_chunked"] * 2
    timing = [e for e in events if e["event"] == "execute_timing"]
    assert [(e["program"], e["count"]) for e in timing] == [("null_text_chunked", 2)]
