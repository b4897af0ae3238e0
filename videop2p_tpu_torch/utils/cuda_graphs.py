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
exist, a program analysis, ``VIDEOP2P_CUDA_GRAPHS=0``, or a caller's
``cuda_graphs=False``) :meth:`StepGraphs.run` calls the body: the eager
loop, the oracle the graphs are held against.

On a mesh (``parallel/mesh.py``) the step bodies are captured with the
NCCL collectives they reach (the sharded seams' all-reduces, all-gathers,
reduce-scatters and broadcasts, the frames ring's point-to-point exchange,
the device probe's gathers, the losses' and gradients' reductions): a
replay runs them in the order they were captured, which is the eager
loop's. Every rank runs the same loops with the same variant keys, so
every rank warms up, captures and replays the same variants at the same
steps, and the collectives each rank's device runs match. What runs on
the host stays out of the bodies: the gloo control channel
(``parallel/distributed.py``), the collective counters and the reads of a
value. A capture that reaches a collective of a group that is not NCCL's
raises (:func:`capturing`, ``parallel/mesh.py:note_collective``). The
collective counters count as the kernel wrappers' launch counters do,
recorded at the capture and added at each replay.

A :class:`StepGraphs` lives for one call (the run CLIs run each program
once). A served program keeps its graphs warm across requests, as JAX's
``ProgramSet`` keeps its compiled programs: a :class:`KeptRunner` outlives
the call and owns the buffers its step bodies read. A loop hands its
tensor arguments to :meth:`StepGraphs.inputs`, which for a kept runner
copies each leaf into the runner's buffer for it (the first call clones
them), and makes its working buffers with :meth:`StepGraphs.scratch`, made
once per runner; what the call returns that lies in those buffers goes out
through :meth:`StepGraphs.own`, a copy. So a graph captured during one
request replays the next request's values, and the runner holds none of a
finished request's tensors. :class:`RunnerCache` keeps a program set's
runners by key (the program's statics and the argument tree's structure)
and lends each to one call at a time; each runner warms up and captures on
a CUDA stream of its own, whose per-stream state (GroupNorm's scratch, the
cuBLAS workspace) its graphs bake in, so no other runner's eager step uses
it. The graphs of one cache share one memory pool: kept replays run on the
device's default stream, one after another, and a graph's outputs stay
allocated, so no other graph's temporaries land on them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
import weakref
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import torch

__all__ = ["KeptRunner", "RunnerCache", "StepGraphs", "StepInputs", "capturing", "count_launch",
           "graphs_default", "collect_graph_stats", "graph_stats_json", "parse_graph_stats",
           "release_cached_memory", "resolve_graphs", "step_graphs", "index_step", "write_step"]

_local = threading.local()
# one capture at a time in the process, and the launch counts it records
_capture_lock = threading.RLock()
_recording: Optional[List[Tuple[Callable[[int], None], int]]] = None
# the CUDA streams threads and kept runners hold, by (device index, handle):
# PyTorch hands out streams round-robin from a fixed pool, so a new stream
# object may be one already held
_streams_lock = threading.Lock()
_streams_held: set = set()
_STREAM_TRIES = 64


def capturing() -> bool:
    """Whether this thread's current stream is being captured by a
    :class:`StepGraphs` runner (the capturing thread, or the autograd
    engine's thread running a backward on the capture stream)."""
    return _recording is not None and torch.cuda.is_current_stream_capturing()


def count_launch(add: Callable[[int], None], n: int = 1) -> None:
    """A kernel wrapper's launch count: ``add(n)`` now, or, when the launch
    went into a graph being captured (:func:`capturing`), recorded so that
    each replay of the graph calls ``add(n)``."""
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
    a CUDA device, on one card and on a mesh alike, unless
    ``VIDEOP2P_CUDA_GRAPHS=0`` asks for the eager loops (a measurement's
    oracle in another process). Under a process group every group the
    bodies' collectives take (the active mesh's axes, else the world's)
    must be NCCL's: a gloo collective cannot be captured."""
    device = torch.device(device)
    if device.type != "cuda" or os.environ.get("VIDEOP2P_CUDA_GRAPHS", "1") == "0":
        return False
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return True
    from videop2p_tpu_torch.parallel.mesh import active_mesh

    mesh = active_mesh()
    groups = [None] if mesh is None else [g for g in mesh.groups.values() if g is not None]
    return all(dist.get_backend(g) == "nccl" for g in groups)


def resolve_graphs(cuda_graphs: Optional[bool], device) -> bool:
    """A pipeline's ``cuda_graphs`` keyword: None → :func:`graphs_default`
    (on a CUDA mesh: graphs, with the collectives captured in the step
    bodies, every rank deciding alike); True on a device without CUDA
    graphs raises."""
    if cuda_graphs is None:
        return graphs_default(device)
    if cuda_graphs and torch.device(device).type != "cuda":
        raise ValueError(f"cuda_graphs=True needs a CUDA device, got {device}")
    return bool(cuda_graphs)


def _claim_stream(device: torch.device) -> "torch.cuda.Stream":
    """A CUDA stream on ``device`` that no thread or kept runner holds,
    marked held; raises when the pool has none left."""
    with _streams_lock:
        for _ in range(_STREAM_TRIES):
            stream = torch.cuda.Stream(device)
            key = (device.index, stream.cuda_stream)
            if key not in _streams_held:
                _streams_held.add(key)
                return stream
    raise RuntimeError(f"no CUDA stream on {device} is free of a thread or a kept runner "
                       f"({len(_streams_held)} held): close program sets that are not used")


def _release_stream(device: torch.device, stream: "torch.cuda.Stream") -> None:
    with _streams_lock:
        _streams_held.discard((device.index, stream.cuda_stream))


# a kept runner's call leaves this much cached and unused at most before
# it is given back (each runner's stream caches its own warm-up's blocks)
_RELEASE_BYTES = 4 << 30


def release_cached_memory(min_bytes: int = 0) -> None:
    """Gives the allocator's cached, unused blocks back to the card, while
    no capture runs in the process (a warm-up's activations, cached for
    the stream that ran them, are otherwise held for good); nothing when
    fewer than ``min_bytes`` are cached unused on the current device."""
    if torch.cuda.memory_reserved() - torch.cuda.memory_allocated() < min_bytes:
        return
    with _capture_lock:
        torch.cuda.empty_cache()


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    """This thread's side stream on ``device``, made once: each stream a
    process touches keeps state of its own for good (a cuBLAS workspace,
    GroupNorm's scratch), so the per-call runners of one thread share one.
    Two threads' warm-ups never share one (GroupNorm's scratch is a
    stream's)."""
    streams = getattr(_local, "streams", None)
    if streams is None:
        streams = _local.streams = {}
    stream = streams.get(device.index)
    if stream is None:
        stream = streams[device.index] = _claim_stream(device)
    return stream


def step_graphs(cuda_graphs, device, name: str) -> "StepGraphs":
    """The runner of one program call on ``device``: the caller's own
    runner when ``cuda_graphs`` is one (a :class:`KeptRunner` lent by a
    :class:`RunnerCache`), else a new one graphed as :func:`resolve_graphs`
    decides, and eager inside a program analysis: what every graphed loop
    of the port opens (and finishes when the call ends)."""
    if isinstance(cuda_graphs, StepGraphs):
        return cuda_graphs
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


# the marker of the line a run CLI prints its runners' stats on
GRAPH_STATS_MARK = "cuda graphs: "


def graph_stats_json(stats: List[Dict[str, Any]]) -> str:
    """The runners' stats as the JSON a run CLI prints after
    :data:`GRAPH_STATS_MARK` (each program's graphs, replays and eager
    steps), which :func:`parse_graph_stats` reads back."""
    import json

    return json.dumps([{k: s.get(k) for k in ("program", "graphs", "replays", "eager_steps")}
                       for s in stats])


def parse_graph_stats(text: str) -> List[Dict[str, Any]]:
    """The stats of the first line of ``text`` (a run CLI's output) that
    carries them; [] when none does."""
    import json

    for line in text.splitlines():
        at = line.find(GRAPH_STATS_MARK + "[")
        if at >= 0:
            return json.loads(line[at + len(GRAPH_STATS_MARK):])
    return []


class StepInputs:
    """A loop's per-step integer inputs (timesteps, step indices): one
    (steps, columns) int64 table copied to the device once, and one row
    buffer that :meth:`load` fills with step i's row (one device copy, no
    value from the host). Each column is an attribute: a 0-d int64 view of
    the row buffer, at a fixed address a step body reads."""

    def __init__(self, columns: Dict[str, Any], device):
        names = list(columns)
        rows = zip(*(list(map(int, columns[n])) for n in names))
        self._set(names, torch.tensor(list(rows), dtype=torch.int64, device=device))

    def _set(self, names: List[str], table: torch.Tensor) -> None:
        self._names = names
        self._table = table
        self._row = torch.zeros(len(names), dtype=torch.int64, device=table.device)
        for k, name in enumerate(names):
            setattr(self, name, self._row[k])

    def load(self, i: int) -> None:
        """Writes step ``i``'s row into the buffer."""
        self._row.copy_(self._table[i])

    def clone(self) -> "StepInputs":
        """A copy with its own table and row buffer (a kept runner's)."""
        out = StepInputs.__new__(StepInputs)
        out._set(list(self._names), self._table.clone())
        return out

    def copy_(self, other: "StepInputs") -> int:
        """Takes ``other``'s table (the same columns and steps); returns the
        bytes copied."""
        if other._names != self._names or other._table.shape != self._table.shape:
            raise ValueError(f"step inputs {other._names} x {tuple(other._table.shape)} do not "
                             f"fit the kept {self._names} x {tuple(self._table.shape)}")
        self._table.copy_(other._table)
        return self._table.numel() * 8


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
            entry = self._graphs[key] = self._new_graph(key, body, args)
            self.capture_s[key] = time.perf_counter() - t0
        self.replays += 1
        return self._replay(entry)

    def inputs(self, name: str, tree):
        """The call's input ``tree`` (tensors, dataclasses, dicts, lists,
        tuples, :class:`StepInputs`) as the step bodies read it, by
        ``name``: as it is, for a runner of one call."""
        return tree

    def scratch(self, name: str, make: Callable[[], Any]):
        """A buffer (or a dict of them) the step bodies write, by ``name``:
        ``make()``, for a runner of one call."""
        return make()

    def own(self, tree):
        """``tree`` as the caller may keep it after the call: as it is, for
        a runner of one call (its buffers are the call's)."""
        return tree

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

    def _new_graph(self, key: Hashable, body, args) -> "_Graph":
        """Variant ``key``'s graph: :meth:`_capture`."""
        return self._capture(body, args)

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
        if not self.enabled or not self._graphs or self._pool is None:
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
        _report(self)
        self._graphs.clear()

    def finish(self) -> None:
        """The end of the loop's call: :meth:`close`."""
        self.close()

    def __enter__(self) -> "StepGraphs":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()


def _report(runner: "StepGraphs") -> None:
    sink = getattr(_local, "stats", None)
    if sink is not None and runner.enabled:
        sink.append(runner.stats())


class KeptRunner(StepGraphs):
    """The step graphs of one program kept across its calls, with the
    buffers its step bodies read (the module docstring). Lent to one call
    at a time (:class:`RunnerCache`); warms up and captures on a stream of
    its own. A variant is captured at its second step across calls,
    whichever thread runs it (a served mesh's ranks, whose calls run in
    threads of their own, then capture the same variants at the same
    steps); before a capture, the capturing thread's cuBLAS and cuDNN state
    on the runner's stream is made outside the graph
    (:func:`_prime_stream`). Inside a program analysis every step runs
    eagerly (the analysis counts dispatched ops) and counts as the
    variant's warm-up. :meth:`stats` reports the current call's captures,
    eager steps and replays; :attr:`totals` every call's. ``agree(label,
    error)`` (a served mesh's ranks:
    ``parallel/distributed.py:agree_on_capture``) takes each capture's
    outcome, None or the exception it raised, before the graph first
    replays, and raises when any rank's capture failed."""

    def __init__(self, device, *, name: str = "", key: Hashable = None,
                 pool: Optional[Callable[[], Any]] = None,
                 agree: Optional[Callable[[str, Optional[BaseException]], None]] = None):
        super().__init__(device, enabled=False, name=name)
        self.enabled = True
        self.key = key
        self._agree = agree
        self._inputs: Dict[str, Any] = {}
        self._scratch: Dict[str, Any] = {}
        self.calls = 0
        self.copy_in_bytes = 0
        self._mark = (0, 0, 0, 0)
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            self._stream = _claim_stream(self.device)
            self._pool_source = pool or torch.cuda.graph_pool_handle
            # a runner dropped without close() gives its stream back
            self._release = weakref.finalize(self, _release_stream, self.device, self._stream)

    def run(self, key: Hashable, body: Callable[..., Any], *args) -> Any:
        from videop2p_tpu_torch.obs.introspect import analysis_active

        if analysis_active():
            self._seen.add(key)
            self.eager_steps += 1
            return self._warm(body, args)
        return super().run(key, body, *args)

    def inputs(self, name: str, tree):
        """The runner's buffers for input ``name``, holding ``tree``'s
        values: clones of its tensors at the first call, then each leaf
        copied in place (``copy_``, no allocation). The tree's structure,
        shapes, dtypes and Python-level values must be the first call's:
        the runner's key promises it, and a mismatch raises."""
        have = self._inputs.get(name)
        if have is None:
            self._inputs[name] = have = _clone_tree(tree)
        else:
            self.copy_in_bytes += _copy_tree(have, tree, name)
        return have

    def scratch(self, name: str, make: Callable[[], Any]):
        if name not in self._scratch:
            self._scratch[name] = make()
        return self._scratch[name]

    def own(self, tree):
        return _map_tensors(tree, lambda t: t.clone())

    def begin_call(self) -> None:
        """A call starts: its stats count from here."""
        self.calls += 1
        self._mark = (len(self.capture_s), self.eager_steps, self.replays, self.copy_in_bytes)

    def stats(self) -> Dict[str, Any]:
        graphs, eager, replays, copied = self._mark
        new = list(self.capture_s.items())[graphs:]
        return {"program": self.name, "graphed": True, "kept": True, "calls": self.calls,
                "graphs": len(new), "eager_steps": self.eager_steps - eager,
                "replays": self.replays - replays,
                "capture_s": {repr(k): round(v, 4) for k, v in new},
                "copy_in_bytes": self.copy_in_bytes - copied,
                "graphs_kept": len(self._graphs), "pool_bytes": self.pool_bytes()}

    @property
    def totals(self) -> Dict[str, Any]:
        """Every call's captures, eager steps, replays and copied-in bytes."""
        return {"calls": self.calls, "graphs": len(self.capture_s),
                "eager_steps": self.eager_steps, "replays": self.replays,
                "copy_in_bytes": self.copy_in_bytes}

    def _new_graph(self, key: Hashable, body, args) -> "_Graph":
        if self._agree is None:
            return super()._new_graph(key, body, args)
        label = f"{self.name} variant {key!r}"
        try:
            graph = super()._new_graph(key, body, args)
        except BaseException as e:
            self._agree(label, e)
            raise
        self._agree(label, None)
        return graph

    def _capture(self, body, args) -> "_Graph":
        """A capture into the pool this runner's graphs hold, or, when it
        holds none, the one ``pool`` gives (a pool id is reused only while
        a graph holds the pool)."""
        with _capture_lock:
            if not self._graphs:
                self._pool = self._pool_source()
            _prime_stream(self.device, self._stream)
            return super()._capture(body, args)

    def _replay(self, entry: "_Graph"):
        """One replay on the device's default stream (ordered after the
        caller's): the graphs of one runner cache share a pool, which is
        safe while their replays never overlap."""
        if self._stream is None:
            return super()._replay(entry)
        current = torch.cuda.current_stream(self.device)
        default = torch.cuda.default_stream(self.device)
        if current == default:
            return super()._replay(entry)
        default.wait_stream(current)
        with torch.cuda.stream(default):
            out = super()._replay(entry)
        current.wait_stream(default)
        return out

    def finish(self) -> None:
        """The end of one call: its stats reported; the graphs and buffers
        stay. A call that ran steps eagerly on the runner's stream leaves
        their activations cached for that stream alone: past
        ``_RELEASE_BYTES`` cached unused, they go back to the card."""
        _report(self)
        if self._stream is not None and self.eager_steps > self._mark[1]:
            release_cached_memory(_RELEASE_BYTES)

    def close(self) -> None:
        """Frees the graphs, their pool and the buffers, and gives the
        stream back (after the card has finished with them)."""
        if self._stream is not None:
            torch.cuda.synchronize(self.device)
        self._graphs.clear()
        self._inputs.clear()
        self._scratch.clear()
        self._seen.clear()
        if self._stream is not None:
            self._release()
            self._stream = None


def _prime_stream(device: torch.device, stream: "torch.cuda.Stream") -> None:
    """Makes this thread's per-stream library state on ``stream`` (its
    cuBLAS and cuBLASLt handles' workspaces, its cuDNN handle) with small
    products in both float dtypes, once a thread and stream: a capture must
    not be the first to make it (a thread that warmed the variant up has
    made it already; another thread may capture it on a later call)."""
    primed = getattr(_local, "primed", None)
    if primed is None:
        primed = _local.primed = set()
    if (device.index, stream.cuda_stream) in primed:
        return
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream), torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.ones((16, 16), dtype=dtype, device=device)
            torch.mm(a, a)
            torch.addmm(a[0], a, a)
            torch.baddbmm(a[None], a[None], a[None])
            torch.nn.functional.conv2d(torch.ones((1, 16, 4, 4), dtype=dtype, device=device),
                                       torch.ones((16, 16, 3, 3), dtype=dtype, device=device),
                                       padding=1)
    torch.cuda.synchronize(device)
    primed.add((device.index, stream.cuda_stream))


class RunnerCache:
    """A program set's kept runners by key, each lent to one call at a
    time: a call whose key's runners are all out gets a new one (two
    threads never replay one graph at once). At most ``max_runners`` are
    kept: the least recently returned idle one is closed to make room, and
    one returned over the bound is closed. ``make(key, name)`` builds a
    runner (:class:`KeptRunner` by default, given ``agree``). On a served
    mesh every rank's cache lends, makes and evicts alike: its calls run
    in the same order on every rank."""

    def __init__(self, device, max_runners: int = 8,
                 make: Optional[Callable[[Hashable, str], KeptRunner]] = None,
                 agree: Optional[Callable[[str, Optional[BaseException]], None]] = None):
        self.device = torch.device(device)
        self.max_runners = int(max_runners)
        self._agree = agree
        self._make = make or self._new_runner
        self._pool = None
        self._members: "weakref.WeakSet[KeptRunner]" = weakref.WeakSet()
        self._lock = threading.Lock()
        self._idle: List[KeptRunner] = []  # least recently returned first
        self._out: Dict[int, int] = {}  # id of a lent runner -> the generation it was lent in
        self._generation = 0
        self.made = 0

    @contextlib.contextmanager
    def checkout(self, key: Hashable, name: str):
        """Lends the runner of ``key`` (a new one when none is idle) for
        one call; yields it."""
        evict: List[KeptRunner] = []
        with self._lock:
            runner = next((r for r in reversed(self._idle) if r.key == key), None)
            if runner is not None:
                self._idle.remove(runner)
            else:
                while self._idle and len(self._idle) + len(self._out) >= self.max_runners:
                    evict.append(self._idle.pop(0))
        for old in evict:
            old.close()
        if runner is None:
            runner = self._make(key, name)
            self.made += 1
        with self._lock:
            self._out[id(runner)] = self._generation
        runner.begin_call()
        try:
            yield runner
        finally:
            with self._lock:
                lent_in = self._out.pop(id(runner))
                keep = (lent_in == self._generation
                        and len(self._idle) + len(self._out) < self.max_runners)
                if keep:
                    self._idle.append(runner)
            if not keep:
                runner.close()

    def _new_runner(self, key: Hashable, name: str) -> KeptRunner:
        """A runner whose graphs go into the cache's one pool (its runners'
        replays run one after another on the device's default stream)."""
        runner = KeptRunner(self.device, name=name, key=key, pool=self._capture_pool,
                            agree=self._agree)
        self._members.add(runner)
        return runner

    def _capture_pool(self):
        """The cache's pool while a runner's graph holds it, else a new one
        (PyTorch refuses a pool id whose graphs are all gone). Called under
        the capture lock."""
        if self._pool is None or not any(r._graphs and r._pool == self._pool
                                         for r in list(self._members)):
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def runners(self) -> List[KeptRunner]:
        """The idle runners."""
        with self._lock:
            return list(self._idle)

    def totals(self) -> Dict[str, Any]:
        """The idle runners' :attr:`KeptRunner.totals` summed, their count,
        the runners made so far and the pools' bytes."""
        runners = self.runners()
        out = {"runners": len(runners), "made": self.made, "calls": 0, "graphs": 0,
               "eager_steps": 0, "replays": 0, "copy_in_bytes": 0, "pool_bytes": 0}
        pools = {}
        for r in runners:
            for k, v in r.totals.items():
                out[k] += v
            if r._pool is not None:
                pools[tuple(r._pool)] = r.pool_bytes() or 0
        out["pool_bytes"] = sum(pools.values())
        return out

    def close(self) -> None:
        """Closes the idle runners, and each lent one when it comes back;
        later calls make new ones."""
        with self._lock:
            idle, self._idle = self._idle, []
            self._generation += 1
        for runner in idle:
            runner.close()


def _map_tensors(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def _clone_tree(tree):
    """A copy of an input tree with every tensor cloned (dataclasses by
    their init fields, :class:`StepInputs` by its table)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, StepInputs):
        return tree.clone()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _clone_tree(getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree


def _copy_tree(dst, src, path: str) -> int:
    """Copies ``src``'s tensors into ``dst``'s (the same structure, shapes,
    dtypes and Python-level values, else ValueError); returns the bytes."""
    if isinstance(dst, torch.Tensor):
        if not isinstance(src, torch.Tensor) or src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"kept input {path}: {_describe(src)} does not fit the runner's "
                             f"{_describe(dst)}")
        dst.copy_(src)
        return dst.numel() * dst.element_size()
    if isinstance(dst, StepInputs):
        if not isinstance(src, StepInputs):
            raise ValueError(f"kept input {path}: {_describe(src)} is not step inputs")
        return dst.copy_(src)
    if dataclasses.is_dataclass(dst) and not isinstance(dst, type):
        if type(src) is not type(dst):
            raise ValueError(f"kept input {path}: {_describe(src)} is not a {type(dst).__name__}")
        return sum(_copy_tree(getattr(dst, f.name), getattr(src, f.name), f"{path}.{f.name}")
                   for f in dataclasses.fields(dst) if f.init)
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(src) != set(dst):
            raise ValueError(f"kept input {path}: keys {sorted(src) if isinstance(src, dict) else src}"
                             f" are not the runner's {sorted(dst)}")
        return sum(_copy_tree(dst[k], src[k], f"{path}[{k!r}]") for k in dst)
    if isinstance(dst, (list, tuple)):
        if type(src) is not type(dst) or len(src) != len(dst):
            raise ValueError(f"kept input {path}: {_describe(src)} is not the runner's "
                             f"{_describe(dst)}")
        return sum(_copy_tree(d, v, f"{path}[{i}]") for i, (d, v) in enumerate(zip(dst, src)))
    if isinstance(src, (torch.Tensor, StepInputs)) or src != dst:
        raise ValueError(f"kept input {path}: {src!r} is not the runner's {dst!r}")
    return 0


def _describe(x) -> str:
    if isinstance(x, torch.Tensor):
        return f"tensor {tuple(x.shape)} {x.dtype}"
    if isinstance(x, (list, tuple)):
        return f"{type(x).__name__} of {len(x)}"
    return type(x).__name__
