"""``UNet3DConfig.remat_policy`` in the port: JAX's ``jax.checkpoint_policies``
names, on the tiny UNet on the CPU in float32 with checkpointed blocks.

Each mapped policy gives the trainable gradients of full recompute (policy
None) bit for bit: saving a product's output instead of recomputing it
changes no arithmetic. The dots policies really save: the backward of a
loss then runs fewer matrix products than under full recompute, the
batch-free one keeps the batched products' (``bmm``) recompute, and
``everything_saveable`` recomputes none. Any other name raises and lists
the mapped names.
"""

import copy
import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tests.test_torch_parity import t
from tests.test_torch_tune import pair  # noqa: F401  (the fixture)

PRODUCTS = ("mm", "addmm", "bmm")


class _CountProducts(TorchDispatchMode):
    """Counts the matrix products dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.counts = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in PRODUCTS:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def _grads(pair, policy):
    """The trainable gradients of one loss with checkpointed blocks under
    ``policy``, and the products its backward ran."""
    from videop2p_tpu_torch.train import partition_params

    model = copy.deepcopy(pair["pmodel"])
    model.config = dataclasses.replace(model.config, gradient_checkpointing=True,
                                       remat_policy=policy, frame_attention="chunked")
    trainable, _ = partition_params(model)
    rng = np.random.default_rng(0)
    noisy = t(rng.normal(size=pair["latents"].shape))
    loss = model(noisy, torch.tensor([300]), t(pair["text"])).square().mean()
    with _CountProducts() as mode:
        grads = torch.autograd.grad(loss, list(trainable.values()))
    return grads, mode.counts


@pytest.fixture(scope="module")
def full_recompute(pair):
    return _grads(pair, None)


@pytest.mark.parametrize("policy", [
    "nothing_saveable", "dots_saveable", "checkpoint_dots",
    "dots_with_no_batch_dims_saveable", "checkpoint_dots_with_no_batch_dims",
    "everything_saveable"])
def test_policy_gives_full_recompute_gradients(pair, full_recompute, policy):
    from videop2p_tpu_torch.models.unet import REMAT_POLICIES

    want, full = full_recompute
    got, counts = _grads(pair, policy)
    assert len(got) == len(want) > 0
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    saved = REMAT_POLICIES[policy]
    if saved == ():
        assert counts == full
    elif saved is None:
        assert sum(counts.values()) < sum(full.values())
    else:
        for name in PRODUCTS:
            if name in saved:
                assert counts[name] < full[name], name
            else:
                assert counts[name] == full[name], name


def test_unknown_policy_raises():
    from videop2p_tpu_torch.models.unet import UNet3DConfig

    with pytest.raises(NotImplementedError, match="dots_with_no_batch_dims_saveable"):
        UNet3DConfig.tiny(remat_policy="save_only_these_names")
