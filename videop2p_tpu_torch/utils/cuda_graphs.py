"""CUDA graphs of the port's step bodies: the counterpart of the JAX
package's single-dispatch programs (``ddim_inversion_captured``'s and the
cached edit's ``lax.scan``, ``null_text_optimization_fused``'s outer scan
with its inner ``while_loop``, the tuner's ``train_steps`` scan).

A hot loop of the port is written as "write step i's inputs into device
buffers, run the step body": the body reads every per-step value (the
timestep, the step index, the bias corrections, the noise) from those
buffers and writes its results into buffers in place, so one capture of a
body serves every step whose Python-level branches go the same way. That
branch pattern (a reuse schedule's full or shallow step, a gate window's
edge, the optimizer's accumulate or apply phase) is the body's variant key.

:class:`StepGraphs` runs a variant's first step eagerly on its own side
stream (the warm-up: lazily made per-stream state — cuBLAS workspaces,
GroupNorm's scratch — exists before the capture, which uses the same
stream; one side stream a thread, so that state is made once), captures
the variant at its second step (the capture runs no
kernel) and replays the graph from then on; a variant that occurs once is
never captured. Every graph of one runner shares one memory pool: the
variants replay one after another, and a step's outputs are consumed
before the next step runs. Captures take a process-wide lock and run in
``thread_local`` error mode (in-process fleet replicas and the data mesh's
``vmap`` threads share a card). A capture or replay failure raises; nothing
falls back to the eager loop.

The kernel wrappers count their launches in Python, which a replay does
not run: they count through :func:`count_launch`, which during a capture
records the count instead, and every replay adds what its capture
recorded. An instrumented program's analysed first call
(``obs/introspect.py``, whose counting mode sees ops as they dispatch and
so would miss every replay) is its warm-up: it runs the eager loop, and
the program's later calls replay graphs.

Without a runner's graphs (``enabled`` False: the CPU, where graphs do not
exist, a mesh, a program analysis, or a caller's ``cuda_graphs=False``)
:meth:`StepGraphs.run` calls the body: the eager loop, the oracle the
graphs are held against.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import torch

__all__ = ["StepGraphs", "StepInputs", "count_launch", "graphs_default",
           "collect_graph_stats", "resolve_graphs", "step_graphs", "index_step",
           "write_step"]

_local = threading.local()
# one capture at a time in the process, and the launch counts it records
_capture_lock = threading.Lock()
_recording: Optional[List[Tuple[Callable[[int], None], int]]] = None


def count_launch(add: Callable[[int], None], n: int = 1) -> None:
    """A kernel wrapper's launch count: ``add(n)`` now, or, when the launch
    went into a graph being captured (from the capturing thread or from
    the autograd engine's thread running its backward on the capture
    stream), recorded so that each replay of the graph calls ``add(n)``."""
    recording = _recording
    if recording is not None and torch.cuda.is_current_stream_capturing():
        recording.append((add, n))
    else:
        add(n)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    # float8 has no index_copy kernel: move its bytes
    return t.view(torch.uint8) if t.dtype.is_floating_point and t.element_size() == 1 else t


def index_step(x: torch.Tensor, index) -> torch.Tensor:
    """``x[index]`` along the leading axis for an int, or for a 0-d int64
    tensor on ``x``'s device gathered there: PyTorch reads a 0-d tensor
    index to the host (a sync, which a capture refuses)."""
    if isinstance(index, torch.Tensor):
        return _as_bytes(x).index_select(0, index.reshape(1))[0].view(x.dtype)
    return x[index]


def write_step(buffer: torch.Tensor, index: torch.Tensor, value: torch.Tensor) -> None:
    """``buffer[index] = value`` along the leading axis, ``index`` a 0-d
    int64 tensor on the buffer's device (no read to the host)."""
    _as_bytes(buffer).index_copy_(0, index.reshape(1), _as_bytes(value)[None])


def graphs_default(device) -> bool:
    """Whether a step loop on ``device`` runs as CUDA graphs by default: on
    a CUDA device outside any mesh. On a mesh (an active
    ``parallel/mesh.py`` mesh, or a process group of more than one rank)
    the loops stay eager: its gloo control group cannot be captured."""
    device = torch.device(device)
    if device.type != "cuda":
        return False
    from videop2p_tpu_torch.parallel.mesh import active_mesh

    if active_mesh() is not None:
        return False
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1)


def resolve_graphs(cuda_graphs: Optional[bool], device) -> bool:
    """A pipeline's ``cuda_graphs`` keyword: None → :func:`graphs_default`;
    True on a device without CUDA graphs raises."""
    if cuda_graphs is None:
        return graphs_default(device)
    if cuda_graphs and torch.device(device).type != "cuda":
        raise ValueError(f"cuda_graphs=True needs a CUDA device, got {device}")
    return bool(cuda_graphs)


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    """This thread's side stream on ``device``, made once: each stream a
    process touches keeps state of its own for good (a cuBLAS workspace,
    GroupNorm's scratch), so the runners of one thread share one. Two
    threads' warm-ups never share one (GroupNorm's scratch is a stream's)."""
    streams = getattr(_local, "streams", None)
    if streams is None:
        streams = _local.streams = {}
    stream = streams.get(device.index)
    if stream is None:
        stream = streams[device.index] = torch.cuda.Stream(device)
    return stream


def step_graphs(cuda_graphs: Optional[bool], device, name: str) -> "StepGraphs":
    """The runner of one program call on ``device``, graphed as
    :func:`resolve_graphs` decides, and eager inside a program analysis:
    what every graphed loop of the port opens (and closes when the call
    ends)."""
    from videop2p_tpu_torch.obs.introspect import analysis_active

    enabled = resolve_graphs(cuda_graphs, device) and not analysis_active()
    return StepGraphs(device, enabled=enabled, name=name)


@contextlib.contextmanager
def collect_graph_stats():
    """Collects the :meth:`StepGraphs.stats` of every runner this thread
    closes inside the block, in order, into the list it yields."""
    previous = getattr(_local, "stats", None)
    _local.stats = collected = []
    try:
        yield collected
    finally:
        _local.stats = previous


class StepInputs:
    """A loop's per-step integer inputs (timesteps, step indices): one
    (steps, columns) int64 table copied to the device once, and one row
    buffer that :meth:`load` fills with step i's row (one device copy, no
    value from the host). Each column is an attribute: a 0-d int64 view of
    the row buffer, at a fixed address a step body reads."""

    def __init__(self, columns: Dict[str, Any], device):
        names = list(columns)
        rows = zip(*(list(map(int, columns[n])) for n in names))
        self._table = torch.tensor(list(rows), dtype=torch.int64, device=device)
        self._row = torch.zeros(len(names), dtype=torch.int64, device=device)
        for k, name in enumerate(names):
            setattr(self, name, self._row[k])

    def load(self, i: int) -> None:
        """Writes step ``i``'s row into the buffer."""
        self._row.copy_(self._table[i])


class _Graph:
    __slots__ = ("graph", "out", "launches")

    def __init__(self, graph, out, launches):
        self.graph, self.out, self.launches = graph, out, launches


class StepGraphs:
    """The CUDA graphs of one program call's step bodies, keyed by variant
    (the module docstring). ``name`` labels the program in
    :meth:`stats`."""

    def __init__(self, device, *, enabled: bool, name: str = ""):
        self.device = torch.device(device)
        self.enabled = bool(enabled)
        self.name = name
        self._seen: set = set()
        self._graphs: Dict[Hashable, _Graph] = {}
        self.capture_s: Dict[Hashable, float] = {}
        self.eager_steps = 0
        self.replays = 0
        self._stream = None
        self._pool = None
        if self.enabled:
            if self.device.type != "cuda":
                raise ValueError(f"CUDA graphs need a CUDA device, got {self.device}")
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            self._stream = _side_stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()

    def run(self, key: Hashable, body: Callable[..., Any], *args) -> Any:
        """Step ``body(*args)`` of variant ``key``: eagerly the first time
        (and always without graphs), captured and replayed the second time,
        replayed after that. ``args`` are the Python values the variant's
        branches read (baked into its graph); every per-step value comes
        from the buffers the body reads. Returns the body's outputs, valid
        until the next step runs (:meth:`kept` copies what a loop keeps)."""
        if not self.enabled:
            return body(*args)
        entry = self._graphs.get(key)
        if entry is None:
            if key not in self._seen:
                self._seen.add(key)
                self.eager_steps += 1
                return self._warm(body, args)
            t0 = time.perf_counter()
            entry = self._graphs[key] = self._capture(body, args)
            self.capture_s[key] = time.perf_counter() - t0
        self.replays += 1
        return self._replay(entry)

    def kept(self, tree):
        """``tree`` (tensors, or dicts / lists / tuples of them) as a loop
        keeps it past the next step: cloned when it may be a graph's
        output, as it is otherwise."""
        if not self.enabled:
            return tree
        return _map_tensors(tree, lambda t: t.clone())

    def _warm(self, body, args):
        """A variant's first step: eagerly, on the side stream."""
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            out = body(*args)
        current.wait_stream(self._stream)
        return out

    def _replay(self, entry: "_Graph"):
        """One replay on the current stream, with its launch counts."""
        entry.graph.replay()
        for add, n in entry.launches:
            add(n)
        return entry.out

    def _capture(self, body, args) -> "_Graph":
        """A variant's capture on the side stream (the wrappers' launch
        counts recorded)."""
        graph = torch.cuda.CUDAGraph()
        recording: List[Tuple[Callable[[int], None], int]] = []
        current = torch.cuda.current_stream(self.device)
        global _recording
        with _capture_lock:
            self._stream.wait_stream(current)
            torch.cuda.synchronize(self.device)
            _recording = recording
            try:
                with torch.cuda.stream(self._stream):
                    graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                    try:
                        out = body(*args)
                    finally:
                        graph.capture_end()
            finally:
                _recording = None
        current.wait_stream(self._stream)
        return _Graph(graph, out, recording)

    def pool_bytes(self) -> Optional[int]:
        """Bytes the allocator reserves for this runner's graph pool (its
        segments in ``torch.cuda.memory_snapshot()``); None without graphs
        or where the snapshot does not name pools."""
        if not self.enabled or not self._graphs:
            return None
        pool = tuple(self._pool)
        total, named = 0, False
        for seg in torch.cuda.memory_snapshot():
            if "segment_pool_id" not in seg:
                continue
            named = True
            if tuple(seg["segment_pool_id"]) == pool:
                total += int(seg["total_size"])
        return total if named else None

    def stats(self) -> Dict[str, Any]:
        """The runner's record: graphs captured and each one's capture
        seconds, replays, eager steps, and the pool's bytes."""
        return {"program": self.name, "graphed": self.enabled,
                "graphs": len(self.capture_s), "eager_steps": self.eager_steps,
                "replays": self.replays,
                "capture_s": {repr(k): round(v, 4) for k, v in self.capture_s.items()},
                "pool_bytes": self.pool_bytes()}

    def close(self) -> None:
        """Drops the graphs and their pool (reported to an enclosing
        :func:`collect_graph_stats` first); the counts stay."""
        sink = getattr(_local, "stats", None)
        if sink is not None and self.enabled:
            sink.append(self.stats())
        self._graphs.clear()

    def __enter__(self) -> "StepGraphs":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _map_tensors(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree
