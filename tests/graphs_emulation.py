"""Shared helper (no tests of its own) of the port's graphed-loop tests on
the CPU: the emulated runners of ``utils/cuda_graphs.py``.

A CUDA graph replays the kernels its capture recorded with the arguments
they had then. Where there is no card, :func:`emulated_runner_class` and
:func:`emulated_kept_class` keep ``StepGraphs``' and ``KeptRunner``'s own
policy (a variant's first step eager, its second "captured", later ones
"replayed"): a capture keeps the body with the Python values of the step
it was captured at, a replay runs that body again on the current buffers
under :class:`NoHostValues` — a Python-level branch or value the variant
key does not fix shows as a changed bit, and an op that reads a value to
the host or makes a tensor from one is recorded. On a mesh of gloo ranks
a replay issues the body's collectives again, in the captured order, as a
graph replays its NCCL collectives.
"""

from __future__ import annotations

from torch.utils._python_dispatch import TorchDispatchMode

# ops that read a device value to the host or make a tensor from a host value
FORBIDDEN = {"_local_scalar_dense", "item", "scalar_tensor", "lift_fresh",
             "lift_fresh_copy", "_copy_from"}


class NoHostValues(TorchDispatchMode):
    """Records every op that reads a value to the host or makes a tensor
    from a host value (by op: on the CPU every tensor is on the host)."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        return False

    def __init__(self, seen: list):
        super().__init__()
        self.seen = seen

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._overloadpacket.__name__
        if name in FORBIDDEN or (name == "_to_copy" and kwargs.get("device") is not None):
            self.seen.append(str(func))
        return func(*args, **kwargs)


def emulated_runner_class():
    from videop2p_tpu_torch.utils.cuda_graphs import StepGraphs, _Graph

    class Emulated(StepGraphs):
        """StepGraphs' policy on the CPU: a capture keeps the body with its
        step's Python values, a replay runs it again under
        :class:`NoHostValues`."""

        log: list = []

        def __init__(self, device, name=""):
            super().__init__(device, enabled=False, name=name)
            self.enabled = True
            self.forbidden: list = []
            self.keys: list = []
            Emulated.log.append(self)

        def run(self, key, body, *args):
            self.keys.append(key)
            return super().run(key, body, *args)

        def _warm(self, body, args):
            return body(*args)

        def _capture(self, body, args):
            return _Graph(lambda: body(*args), None, [])

        def _replay(self, entry):
            with NoHostValues(self.forbidden):
                return entry.graph()

    return Emulated


def emulated_kept_class():
    """KeptRunner's policy on the CPU, as :func:`emulated_runner_class`: a
    capture keeps the body of the call that captured it, a replay (in any
    later call) runs that body again, under :class:`NoHostValues`."""
    from videop2p_tpu_torch.utils.cuda_graphs import KeptRunner, _Graph

    class EmulatedKept(KeptRunner):
        def __init__(self, device="cpu", name="", key=None, agree=None):
            super().__init__(device, name=name, key=key, agree=agree)
            self.forbidden: list = []

        def _warm(self, body, args):
            return body(*args)

        def _capture(self, body, args):
            return _Graph(lambda: body(*args), None, [])

        def _replay(self, entry):
            with NoHostValues(self.forbidden):
                return entry.graph()

    return EmulatedKept
