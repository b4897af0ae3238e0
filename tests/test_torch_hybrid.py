"""The port's "hybrid" null-text mode against the JAX package's, on the CPU
with identical tiny-UNet weights, trajectory and embeddings, at dependent
weight 0 (no draw enters).

JAX runs at float32 matmul precision ("highest"). Each outer step starts
from the cond embedding and takes K Adam steps against the recorded
trajectory; Adam turns gradient differences into steps of about lr·sign(g),
so the embeddings are held within 2·lr_0 = 0.02 and the losses at 1e-4
relative, as the optimize-mode tests hold them, with an absolute floor of
1e-12 (the last outer step lands on x_0, where both losses sit at float32
rounding noise, ~1e-15, and have no relative meaning); ``inner_steps``
exactly.
Chunked equals unchunked bit for bit in the port.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_nulltext import EMB_BOUND, LOSS_RTOL, STEPS, setup  # noqa: F401
from tests.test_torch_parity import np32, t

LOSS_FLOOR = 1e-12


def _jax_hybrid(s, K, outer_chunk=None):
    from videop2p_tpu.pipelines import null_text_optimization as jax_null

    kw = dict(num_inference_steps=STEPS, null_text_mode="hybrid", hybrid_inner_steps=K,
              return_losses=True, return_inner_steps=True)
    with jax.default_matmul_precision("highest"):
        if outer_chunk:
            out = jax_null(s["jfn"], s["params"], s["jsched"], s["traj"], s["cond"],
                           s["uncond"], outer_chunk=outer_chunk, **kw)
        else:
            out = jax.jit(lambda p, tr, c, u: jax_null(
                s["jfn"], p, s["jsched"], tr, c, u, **kw))(
                s["params"], s["traj"], s["cond"], s["uncond"])
    return [np.asarray(x) for x in out]


def _port_hybrid(s, K, outer_chunk=None):
    from videop2p_tpu_torch.pipelines.inversion import null_text_optimization

    return null_text_optimization(
        s["pfn"], s["psched"], t(s["traj"]), t(s["cond"]), t(s["uncond"]),
        num_inference_steps=STEPS, null_text_mode="hybrid", hybrid_inner_steps=K,
        return_losses=True, return_inner_steps=True, outer_chunk=outer_chunk)


@pytest.mark.parametrize("K", [1, 3])
def test_hybrid_matches_jax(setup, K):
    want_emb, want_loss, want_inner = _jax_hybrid(setup, K)
    emb, loss, inner = _port_hybrid(setup, K)
    assert inner.tolist() == want_inner.tolist() == [K] * STEPS
    np.testing.assert_allclose(np32(loss), want_loss, rtol=LOSS_RTOL, atol=LOSS_FLOOR)
    assert emb.shape == want_emb.shape
    assert np.abs(np32(emb) - want_emb).max() <= EMB_BOUND
    # every outer step starts from the cond embedding: K = 1 moves each
    # element by at most lr_i (Adam's first step is lr·sign(g))
    if K == 1:
        lr0 = 1e-2
        assert np.abs(np32(emb) - setup["cond"][None]).max() <= lr0 * (1 + 1e-5)


def test_hybrid_chunked_equals_unchunked(setup):
    whole = _port_hybrid(setup, 2)
    for chunk in (1, 2):
        parts = _port_hybrid(setup, 2, outer_chunk=chunk)
        for a, b in zip(parts, whole):
            assert torch.equal(a, b)
    # JAX's chunked program against the port, as the unchunked one
    want_emb, want_loss, _ = _jax_hybrid(setup, 2, outer_chunk=2)
    np.testing.assert_allclose(np32(whole[1]), want_loss, rtol=LOSS_RTOL, atol=LOSS_FLOOR)
    assert np.abs(np32(whole[0]) - want_emb).max() <= EMB_BOUND


def test_official_edit_takes_hybrid_and_given_embeddings(setup):
    """``official_edit`` runs the hybrid null-text phase (3 inner steps an
    outer step), and with ``null_embeddings`` skips it and edits with them:
    the same output from the same embeddings."""
    from videop2p_tpu_torch.pipelines import official_edit

    s = setup
    cond = np.concatenate([s["cond"], s["cond"][:, ::-1]])
    out, stats = official_edit(s["pfn"], s["psched"], t(s["traj"]), t(cond),
                               t(s["uncond"]), num_inference_steps=STEPS,
                               null_text_mode="hybrid")
    assert stats["inner_steps"].tolist() == [3] * STEPS
    emb = _port_hybrid(s, 3)[0]
    again, none = official_edit(s["pfn"], s["psched"], t(s["traj"]), t(cond),
                                t(s["uncond"]), num_inference_steps=STEPS,
                                null_embeddings=emb)
    assert none is None
    assert torch.equal(out, again)
