"""The port's ring attention (``videop2p_tpu_torch/parallel/ring.py``) on
2, 3 and 4 spawned gloo ranks (``tests/torch_dist.py``) against dense
attention and against the JAX package's ring on forced host devices.

Every schedule ("overlap", "bidir", "serial") at every ring size: the
output within 1e-5 of float64 dense attention in float32 (the online
softmax in float32), the gradients through the ring's own backward (a
ring again: dK/dV travel with their blocks and return home) within 1e-5
of dense gradients, bf16 within the bf16 rounding of the output, local
blocks of 3 (odd halves for "bidir"); and the sends of a pass pinned:
overlap 2(n − 1), bidir 4(n − 1), serial 2n forward, the backward's K/V
n − 1 hops plus dK/dV n hops a stream, nothing else.
"""

import numpy as np
import pytest
import torch

from tests.torch_dist import frames_mesh, run_ranks

torch.set_num_threads(1)

VARIANTS = ("overlap", "bidir", "serial")
SIZES = (2, 3, 4)
B, H, S, D = 2, 3, 12, 8  # S splits into 6, 4 and 3 rows a rank


def _cases():
    rng = np.random.default_rng(0)
    cases = {}
    for n in SIZES:
        for variant in VARIANTS:
            for dtype in ("float32", "bfloat16"):
                q, k, v, do = (rng.normal(size=(B, H, S, D)).astype(np.float32)
                               for _ in range(4))
                cases[(n, variant, dtype)] = (q, k, v, do)
    return cases


def _ring_worker(rank, world, cases):
    from videop2p_tpu_torch.parallel.mesh import CommRecorder
    from videop2p_tpu_torch.parallel.ring import (
        make_ring_temporal_fn,
        ring_attention,
        ring_attention_sharded,
    )

    meshes = {n: frames_mesh(n) for n in SIZES}
    out = {}
    for (n, variant, dtype), (q, k, v, do) in cases.items():
        mesh = meshes[n]
        if mesh is None:
            continue
        per = S // n
        dt = getattr(torch, dtype)
        local = [torch.from_numpy(a[..., rank * per:(rank + 1) * per, :]).to(dt).requires_grad_(True)
                 for a in (q, k, v)]
        with CommRecorder() as fwd:
            o = ring_attention(*local, mesh, variant=variant)
        with CommRecorder() as bwd:
            o.backward(torch.from_numpy(do[..., rank * per:(rank + 1) * per, :]).to(dt))
        out[(n, variant, dtype)] = dict(
            out=o.detach().float().numpy(), dtype=str(o.dtype),
            grads=[t.grad.float().numpy() for t in local],
            fwd=dict(fwd.per_kind), bwd=dict(bwd.per_kind))
        if dtype == "float32" and variant == "overlap":
            with torch.no_grad():
                glob = ring_attention_sharded(*(torch.from_numpy(a) for a in (q, k, v)), mesh)
                temporal = make_ring_temporal_fn(mesh, variant="bidir")(*local)
            out[(n, "sharded")] = glob.numpy()
            out[(n, "temporal")] = temporal.float().numpy()
    return out


@pytest.fixture(scope="module")
def ring_runs():
    cases = _cases()
    return cases, run_ranks(_ring_worker, 4, cases)


def _dense(q, k, v, do):
    qt, kt, vt = (torch.from_numpy(a).double().requires_grad_(True) for a in (q, k, v))
    o = torch.softmax(qt @ kt.transpose(-1, -2) * D ** -0.5, dim=-1) @ vt
    o.backward(torch.from_numpy(do).double())
    return o.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


def _gathered(ranks, key, n, field, index=None):
    parts = [r[key][field] if index is None else r[key][field][index] for r in ranks[:n]]
    return np.concatenate(parts, axis=-2)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_ring_matches_dense_fp32_with_gradients(ring_runs, n, variant):
    cases, ranks = ring_runs
    key = (n, variant, "float32")
    want, want_grads = _dense(*cases[key])
    np.testing.assert_allclose(_gathered(ranks, key, n, "out"), want, atol=1e-5)
    for i in range(3):
        np.testing.assert_allclose(_gathered(ranks, key, n, "grads", i), want_grads[i],
                                   atol=1e-5)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_ring_bf16(ring_runs, n, variant):
    """bf16 in, bf16 out (float32 accumulators inside): within the bf16
    rounding of the dense output of the bf16-rounded inputs."""
    cases, ranks = ring_runs
    key = (n, variant, "bfloat16")
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in cases[key])
    want, want_grads = _dense(q, k, v, do)
    assert all(r[key]["dtype"] == "torch.bfloat16" for r in ranks[:n])
    np.testing.assert_allclose(_gathered(ranks, key, n, "out"), want, atol=2e-2)
    for i in range(3):
        np.testing.assert_allclose(_gathered(ranks, key, n, "grads", i), want_grads[i],
                                   atol=6e-2)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_ring_sends_pinned(ring_runs, n, variant):
    """Each rank's sends a pass, one ``collective-permute`` each and no
    other collective: JAX's pinned counts forward (test_comm.py's
    ``test_ring_variant_collective_counts_pinned``), and the backward's
    rotation (K/V n − 1 hops, dK/dV n hops, per stream; bidir runs two)."""
    _, ranks = ring_runs
    want_fwd = {"overlap": 2 * (n - 1), "bidir": 4 * (n - 1), "serial": 2 * n}[variant]
    streams = 2 if variant == "bidir" else 1
    for dtype in ("float32", "bfloat16"):
        for r in ranks[:n]:
            got = r[(n, variant, dtype)]
            assert set(got["fwd"]) == {"collective-permute"} == set(got["bwd"])
            assert got["fwd"]["collective-permute"]["count"] == want_fwd
            assert got["bwd"]["collective-permute"]["count"] == streams * (4 * n - 2)
    # every forward send carries a whole block (overlap/serial) or a half
    block = B * H * (S // n) * D * 4
    sent = ranks[0][(n, variant, "float32")]["fwd"]["collective-permute"]["bytes"]
    assert sent == {"overlap": 2 * (n - 1) * block, "serial": 2 * n * block,
                    "bidir": 2 * (n - 1) * block}[variant]


@pytest.mark.parametrize("n", SIZES)
def test_ring_sharded_forms(ring_runs, n):
    """``ring_attention_sharded`` (global tensors in, global out) and the
    UNet's temporal seam (``make_ring_temporal_fn``) compute the same
    attention."""
    cases, ranks = ring_runs
    q, k, v, do = cases[(n, "overlap", "float32")]
    want, _ = _dense(q, k, v, do)
    for r in ranks[:n]:
        np.testing.assert_allclose(r[(n, "sharded")], want, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([r[(n, "temporal")] for r in ranks[:n]], axis=-2),
                               want, atol=1e-5)


def test_ring_matches_jax_ring(ring_runs):
    """The port's ring on 4 ranks equals the JAX package's
    ``ring_attention_sharded`` on a (1, 4, 1) mesh of host devices, every
    schedule."""
    import jax

    from videop2p_tpu.parallel import make_mesh, ring_attention_sharded

    cases, ranks = ring_runs
    mesh = make_mesh((1, 4, 1), devices=jax.devices()[:4])
    for variant in VARIANTS:
        q, k, v, _ = cases[(4, variant, "float32")]
        with jax.default_matmul_precision("highest"):
            want = np.asarray(ring_attention_sharded(q, k, v, mesh, axis_name="frames",
                                                     variant=variant))
        np.testing.assert_allclose(_gathered(ranks, (4, variant, "float32"), 4, "out"), want,
                                   atol=1e-5)
