"""Program analysis of the port's programs (port of
``videop2p_tpu/obs/introspect.py``).

The JAX package mines XLA's analyses of a compiled executable, built ahead
of time on abstract arguments and never run. The port has no compiler
between Python and the card, so it analyses the program's FIRST EXECUTED
CALL instead: :class:`ProgramAnalysis` runs that call under a counting
``TorchDispatchMode`` that sees every aten op, and each hand-written
kernel's wrapper reports its own launch (:func:`note_kernel`), since a
launch through ``ctypes`` is invisible to a dispatch mode. The record has
the JAX package's flat fields (``PROGRAM_METRICS`` plus ``hlo_fingerprint``
and ``hlo_histogram``; ``obs/history.py`` and the tools ``ledger_summary``,
``obs_diff`` and ``cost_report`` of both packages read them), plus
``analysis_s``. In the port they mean:

  * ``flops`` — what ``torch.utils.flop_counter``'s formulas count over the
    aten ops (matmuls, convolutions and their backwards, PyTorch's own
    attention ops), plus each hand kernel's work as PERF.md's bounds count
    it: 4·B·F·H·N·M·D for a forward frame attention, 8·… for the flash
    backward's dK/dV kernel and 6·… for its dQ kernel (each recomputes the
    scores), 0 for GroupNorm. A forward kernel reports exactly what its
    plain version's products count, so ``flops`` of a forward program is
    the same whichever frame-attention implementation runs;
  * ``transcendentals`` — the elements of ``exp``, ``log``, ``tanh``,
    ``sigmoid``, ``silu``, ``gelu`` and softmax, plus a kernel's own
    (B·F·H·N·M exponentials an attention kernel, the SiLU's elements a
    GroupNorm(+SiLU));
  * ``bytes_accessed`` — the bytes of every input and output of every aten
    op that is neither a view nor an uninitialized allocation (``empty``),
    plus each kernel launch's tensors. It depends on
    the implementation, as XLA's count does on its fusions: a kernel reads
    q, k, v once where the plain version writes and reads its scores;
  * ``argument_bytes`` — the distinct storages of the call's tensor
    arguments and of every tensor an op read that the call did not
    allocate (the weights a program closes over: JAX passes them as
    arguments); ``output_bytes`` — the distinct storages of the returned
    tensors; ``alias_bytes`` — those of them that are argument storages;
  * ``temp_bytes`` — on CUDA the call's peak allocation above its start
    (``torch.cuda.reset_peak_memory_stats`` / ``max_memory_allocated``;
    the device's peak counter is reset for the call, as the CLIs' phases
    reset it); on the CPU the peak of the live bytes the mode saw
    allocated (op outputs in fresh storages, freed when the last tensor it
    saw on that storage dies). Either way it includes the outputs;
  * ``generated_code_bytes`` — the bytes of the built kernel libraries
    (``ops/_build.py``) the call launched; 0 when it launched none (every
    CPU call);
  * ``peak_hbm_bytes`` — JAX's formula: arguments + outputs + temps +
    generated code − aliased bytes (an upper bound here, since
    ``temp_bytes`` holds the outputs too);
  * ``hlo_fingerprint`` — 16 hex digits of a sha256 over the sequence of
    (op or kernel name, input shapes, input dtypes). No data pointer or
    address enters it;
  * ``hlo_histogram`` — the count of each aten op (by overload packet, e.g.
    ``convolution``, ``mm``) and each kernel (by launcher name), sorted as
    JAX's ``instruction_histogram``; ``hlo_instructions`` its sum;
  * ``analysis_s`` — the seconds the mode's own bookkeeping took inside
    the call (the Python overhead the analysis adds to the first call).

Counts are of EXECUTED work: a Python loop's iterations are all counted,
where XLA counts a ``scan`` body once. A loop that exits on its data (the
null-text inner loop's early stop) counts the iterations it ran, so its
record follows the data. The record is the same across two analyses of one
program in one process or in two processes, but for ``analysis_s`` (and,
on CUDA, ``temp_bytes`` should the allocator's state differ): state a
program builds once and caches (the GroupNorm kernel's scratch) is made
outside the mode's sight.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import time
import weakref
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = [
    "PROGRAM_METRICS",
    "TRANSCENDENTAL_OPS",
    "ProgramAnalysis",
    "analyze_call",
    "call_device",
    "note_kernel",
    "analysis_active",
    "hidden_from_analysis",
    "instruction_histogram",
]

# the numeric metric keys a program_analysis record carries (the JAX
# package's names: the history rules and the JAX tools reference them)
PROGRAM_METRICS = (
    "flops",
    "transcendentals",
    "bytes_accessed",
    "argument_bytes",
    "output_bytes",
    "temp_bytes",
    "alias_bytes",
    "generated_code_bytes",
    "peak_hbm_bytes",
    "hlo_instructions",
)

# aten overload packets counted as transcendental, one per output element
TRANSCENDENTAL_OPS = frozenset({
    "exp", "exp_", "log", "log_", "tanh", "tanh_", "sigmoid", "sigmoid_",
    "silu", "silu_", "gelu", "gelu_", "_softmax", "softmax",
})

# ops that lift a constant the call made from Python data (``torch.tensor``)
# into the dispatcher: their input is an allocation of the call, not an
# argument
_LIFT_OPS = frozenset({"lift_fresh", "lift_fresh_copy", "lift"})

# allocations that write nothing (their bytes are not accessed)
_ALLOC_OPS = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided"})

# metadata queries that move nothing (flop_counter skips the same)
_METADATA_OPS = frozenset({
    "sym_is_contiguous", "is_contiguous", "is_strides_like_format",
    "is_non_overlapping_and_dense", "size", "sym_size", "stride", "sym_stride",
    "storage_offset", "sym_storage_offset", "numel", "sym_numel", "dim", "layout",
})


def instruction_histogram(counts: Dict[str, int]) -> Dict[str, int]:
    """Counts sorted descending, ties by name (JAX's order)."""
    return dict(sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])))


def _tensors(tree: Any) -> List[torch.Tensor]:
    """The tensors of a pytree; dataclass fields are walked too (a
    ``CachedSource`` or a controller is an argument of some programs)."""
    import dataclasses

    out: List[torch.Tensor] = []
    stack = [tree]
    seen = set()
    while stack:
        obj = stack.pop()
        if isinstance(obj, torch.Tensor):
            out.append(obj)
        elif isinstance(obj, (list, tuple)):
            stack.extend(obj)
        elif isinstance(obj, dict):
            stack.extend(obj.values())
        elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            if id(obj) in seen:
                continue
            seen.add(id(obj))
            stack.extend(getattr(obj, f.name) for f in dataclasses.fields(obj))
    return out


def _storage(t: torch.Tensor):
    """(device, base address) of a tensor's storage and its bytes, or None
    for a tensor with no data."""
    try:
        if t.numel() == 0:
            return None
        ptr = t.data_ptr() - t.storage_offset() * t.element_size()
        if ptr == 0:
            return None
        return (t.device.type, t.device.index, ptr), t.untyped_storage().nbytes()
    except Exception:  # noqa: BLE001 — a tensor with no storage (meta, sparse)
        return None


def _shape_sig(tensors: Iterable[torch.Tensor]) -> str:
    return ",".join(f"{tuple(t.shape)}:{str(t.dtype).replace('torch.', '')}"
                    for t in tensors)


class _CountingMode(TorchDispatchMode):
    """Observes every aten op of the call it wraps; never changes one."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # torch otherwise wraps __torch_dispatch__ in torch._dynamo.disable,
        # whose first call imports torch._dynamo (seconds in every process
        # that analyses a program); the port compiles nothing under the mode
        return False

    def __init__(self, analysis: "ProgramAnalysis"):
        super().__init__()
        self.analysis = analysis

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.analysis._observe_op(func, args, kwargs, out)
        return out


class ProgramAnalysis:
    """One call's analysis: use as a context manager around the call, then
    :meth:`record` with its arguments and outputs. The bookkeeping never
    raises into the call: a failure is kept in ``error`` and makes
    :meth:`record` raise afterwards."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = torch.device(device) if device is not None else None
        self.flops = 0
        self.transcendentals = 0
        self.bytes_accessed = 0
        self.counts: Dict[str, int] = {}
        self._hash = hashlib.sha256()
        self.own_s = 0.0
        self.error: Optional[str] = None
        self.sources: set = set()
        # storages the call allocated, and those it read from outside
        self._allocated: set = set()
        self._external: Dict[Any, int] = {}
        # CPU: live bytes of the allocated storages the mode saw
        self._cpu = self.device is None or self.device.type != "cuda"
        self._refs: Dict[Any, List[int]] = {}
        self._live = 0
        self._peak_live = 0
        self._cuda_start = 0
        self._mode = _CountingMode(self)

    # ---- bookkeeping ------------------------------------------------------

    def _free(self, key) -> None:
        ref = self._refs.get(key)
        if ref is None:
            return
        ref[1] -= 1
        if ref[1] == 0:
            self._live -= ref[0]

    def _note(self, name: str, inputs: Sequence[torch.Tensor],
              outputs: Sequence[torch.Tensor], *, flops: int, transcendentals: int,
              moves: bool) -> None:
        self.counts[name] = self.counts.get(name, 0) + 1
        self._hash.update(f"{name}|{_shape_sig(inputs)};".encode())
        self.flops += int(flops)
        self.transcendentals += int(transcendentals)
        in_keys = set()
        for t in inputs:
            st = _storage(t)
            if st is None:
                continue
            key, nbytes = st
            in_keys.add(key)
            if name in _LIFT_OPS:
                self._allocated.add(key)
            elif key not in self._allocated and key not in self._external:
                self._external[key] = nbytes
        for t in outputs:
            st = _storage(t)
            if st is None:
                continue
            key, nbytes = st
            if key not in in_keys:
                # a fresh storage (at an address freed earlier, perhaps one
                # an argument held)
                self._allocated.add(key)
            if not self._cpu or key not in self._allocated:
                continue
            # every tensor seen on an allocated storage (views included)
            # holds it live until the last of them dies
            ref = self._refs.get(key)
            if ref is None or ref[1] == 0:
                ref = self._refs[key] = [nbytes, 0]
                self._live += nbytes
                self._peak_live = max(self._peak_live, self._live)
            ref[1] += 1
            weakref.finalize(t, self._free, key)
        if moves:
            self.bytes_accessed += sum(t.numel() * t.element_size()
                                       for t in list(inputs) + list(outputs))

    def _observe_op(self, func, args, kwargs, out) -> None:
        t0 = time.perf_counter()
        try:
            packet = func._overloadpacket
            name = packet.__name__
            if name not in _METADATA_OPS:
                from torch.utils.flop_counter import flop_registry

                inputs = [t for t in tree_flatten((args, kwargs))[0]
                          if isinstance(t, torch.Tensor)]
                outputs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
                formula = flop_registry.get(packet)
                flops = formula(*args, **kwargs, out_val=out) if formula else 0
                trans = (outputs[0].numel() if name in TRANSCENDENTAL_OPS and outputs
                         else 0)
                self._note(name, inputs, outputs, flops=flops, transcendentals=trans,
                           moves=not (getattr(func, "is_view", False)
                                      or name in _ALLOC_OPS))
        except Exception as exc:  # noqa: BLE001 — never break the analysed call
            if self.error is None:
                self.error = f"{type(exc).__name__}: {exc}"
        self.own_s += time.perf_counter() - t0

    def _observe_kernel(self, name: str, source: str, inputs, outputs, flops: int,
                        transcendentals: int) -> None:
        t0 = time.perf_counter()
        try:
            self.sources.add(source)
            self._note(name, inputs, outputs, flops=flops, transcendentals=transcendentals,
                       moves=True)
        except Exception as exc:  # noqa: BLE001
            if self.error is None:
                self.error = f"{type(exc).__name__}: {exc}"
        self.own_s += time.perf_counter() - t0

    # ---- the call -----------------------------------------------------------

    def __enter__(self) -> "ProgramAnalysis":
        if not self._cpu:
            torch.cuda.reset_peak_memory_stats(self.device)
            self._cuda_start = torch.cuda.memory_allocated(self.device)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._mode.__exit__(*exc)

    def record(self, args: Any = (), outputs: Any = ()) -> Dict[str, Any]:
        """The flat ``program_analysis`` record of the call (module
        docstring); raises if the bookkeeping failed."""
        if self.error is not None:
            raise RuntimeError(f"program analysis failed: {self.error}")
        arg_storages: Dict[Any, int] = dict(self._external)
        for t in _tensors(args):
            st = _storage(t)
            if st is not None:
                arg_storages[st[0]] = st[1]
        out_storages: Dict[Any, int] = {}
        for t in _tensors(outputs):
            st = _storage(t)
            if st is not None:
                out_storages[st[0]] = st[1]
        arg = sum(arg_storages.values())
        out = sum(out_storages.values())
        alias = sum(n for k, n in out_storages.items() if k in arg_storages)
        if self._cpu:
            tmp = self._peak_live
        else:
            tmp = max(torch.cuda.max_memory_allocated(self.device) - self._cuda_start, 0)
        code = _library_bytes(self.sources)
        hist = instruction_histogram(self.counts)
        return {
            "flops": int(self.flops),
            "transcendentals": int(self.transcendentals),
            "bytes_accessed": int(self.bytes_accessed),
            "argument_bytes": int(arg),
            "output_bytes": int(out),
            "temp_bytes": int(tmp),
            "alias_bytes": int(alias),
            "generated_code_bytes": int(code),
            "peak_hbm_bytes": int(arg + out + tmp + code - alias),
            "hlo_fingerprint": self._hash.hexdigest()[:16],
            "hlo_instructions": sum(hist.values()),
            "hlo_histogram": hist,
            "analysis_s": round(self.own_s, 6),
        }


def _library_bytes(sources: Iterable[str]) -> int:
    """Bytes of the built libraries of these kernel sources."""
    if not sources:
        return 0
    from videop2p_tpu_torch.ops import _build

    total = 0
    for src in sorted(sources):
        try:
            total += os.path.getsize(_build._lib_path(src))
        except OSError:
            pass
    return total


def call_device(args: Any) -> torch.device:
    """The device of the call: its first CUDA tensor's, else the CPU."""
    for t in _tensors(args):
        if t.device.type == "cuda":
            return t.device
    return torch.device("cpu")


def analyze_call(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a :class:`ProgramAnalysis`;
    returns ``(output, record)``."""
    analysis = ProgramAnalysis(call_device((args, kwargs)))
    with analysis:
        out = fn(*args, **kwargs)
    return out, analysis.record((args, kwargs), out)


def _active() -> List[ProgramAnalysis]:
    try:
        from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

        stack = _get_current_dispatch_mode_stack()
    except Exception:  # noqa: BLE001 — a torch without the helper
        return []
    return [m.analysis for m in stack if isinstance(m, _CountingMode)]


def analysis_active() -> bool:
    """Whether a program analysis observes this thread's ops."""
    return bool(_active())


def note_kernel(name: str, source: str, inputs: Sequence[torch.Tensor],
                outputs: Sequence[torch.Tensor], *, flops: int = 0,
                transcendentals: int = 0) -> None:
    """A hand-written kernel's launch, reported by its wrapper where it
    launches: ``name`` (the launcher), ``source`` (its ``csrc`` file), the
    tensors it reads and writes, and its work. A no-op unless an analysis
    is active in this thread (the autograd engine's threads carry the
    mode along)."""
    for analysis in _active():
        analysis._observe_kernel(name, source, inputs, outputs, flops, transcendentals)


@contextlib.contextmanager
def hidden_from_analysis() -> Iterator[None]:
    """Ops inside the block are not seen by an active analysis: for state a
    wrapper builds once and caches, which would otherwise make a first
    analysis differ from a second."""
    if not _active():
        yield
        return
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        yield
