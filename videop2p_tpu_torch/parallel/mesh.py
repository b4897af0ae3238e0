"""Process mesh, collectives and the sharded seams of the UNet (port of
``videop2p_tpu/parallel/mesh.py``).

The JAX package is declarative: it puts ``NamedSharding``s on the latents
and the parameters and GSPMD inserts every collective. PyTorch has no
GSPMD, so here every operation that crosses a shard issues its collective
itself, through the differentiable wrappers of this module, each of which
counts what it sends (:class:`CommRecorder`, read by ``obs/comm.py``).

One process per GPU (``torchrun``), the processes laid out on a
``(dp, sp, tp)`` grid, row-major as JAX's ``make_mesh`` reshapes its
devices:

  * ``data``   — the batch/video axis (single-clip flows keep it at 1);
  * ``frames`` — the frame axis: rank ``s`` of a frames group holds frames
    ``[s·F/sp, (s+1)·F/sp)`` of every latent tensor;
  * ``tensor`` — the attention heads and the feed-forward's hidden
    features (Megatron: column-parallel ``to_q/k/v`` / ``proj_geglu``,
    row-parallel ``to_out`` / ``proj_out``).

Gradients follow two conventions at once. Over ``frames`` every rank's loss
is its frames' share of the global loss and the wrappers' backwards carry
the cross-rank terms: a replicated parameter's gradient is the all-reduced
sum of the ranks' gradients (:func:`reduce_frame_grads`). Over ``tensor``
every rank holds the whole loss (Megatron's ``f``/``g`` pair): a
replicated parameter's gradient is already whole on every tensor rank.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from videop2p_tpu_torch.utils import cuda_graphs as _graphs

__all__ = [
    "AXIS_DATA",
    "AXIS_FRAMES",
    "AXIS_TENSOR",
    "TP_COLLECTIVES",
    "Mesh",
    "make_mesh",
    "check_world",
    "warm_collectives",
    "active_mesh",
    "set_active_mesh",
    "CommRecorder",
    "all_reduce",
    "broadcast_first",
    "gather_frames",
    "frames_slice",
    "frames_draw",
    "global_mean",
    "reduce_frame_grads",
    "param_shardings",
    "shard_state_dict",
    "gather_state_dict",
    "gather_tensor",
    "shard_tensor",
    "sharded_square_sum",
    "shard_unet",
    "make_megatron_out_dot",
    "make_sharded_frame_attention_fn",
    "make_sharded_group_norm_fn",
    "pooled_group_norm",
    "make_kv_gather_fn",
    "make_head_mean_fn",
    "make_tensor_copy_fn",
]

AXIS_DATA = "data"
AXIS_FRAMES = "frames"
AXIS_TENSOR = "tensor"
AXES = (AXIS_DATA, AXIS_FRAMES, AXIS_TENSOR)

# how the row-parallel output projections reduce their partial sums on a
# tensor-parallel mesh: "gspmd" all-reduces the full result (what GSPMD
# inserts in the JAX package), "psum_scatter" reduce-scatters it over the
# token axis and all-gathers it back (the JAX package's explicit seam)
TP_COLLECTIVES = ("gspmd", "psum_scatter")


@dataclasses.dataclass
class Mesh:
    """A ``(dp, sp, tp)`` grid of processes and this process's place in it.

    ``shape`` maps each axis to its size (JAX's ``Mesh.shape``), ``coords``
    to this rank's index along it; ``groups`` holds the process group of
    each axis through this rank (None for a single plain process, where
    every collective is the identity) and ``ranks`` the global ranks of that
    group in axis order."""

    shape: Dict[str, int]
    rank: int
    coords: Dict[str, int]
    groups: Dict[str, Optional[object]]
    ranks: Dict[str, List[int]]
    device: torch.device
    device_mesh: Optional[object] = None
    axis_names: Tuple[str, ...] = AXES

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n

    def group(self, axis: str):
        return self.groups[axis]

    def spec(self) -> str:
        return ",".join(str(self.shape[a]) for a in self.axis_names)

    def __repr__(self) -> str:
        return f"Mesh({self.spec()}, rank={self.rank}, coords={self.coords})"


def check_world(shape: Sequence[int]) -> None:
    """Raise unless ``shape`` multiplies to the world size: a mesh never
    runs on fewer (or more) ranks than it names."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(
            f"mesh shape {shape} needs {n} processes, have {world}: launch one "
            f"process per GPU with torchrun --nproc_per_node {n}")


def make_mesh(shape: Tuple[int, ...] = (1, 1, 1),
              axis_names: Tuple[str, ...] = AXES,
              device: Optional[torch.device] = None) -> Mesh:
    """The mesh of ``shape`` over the processes of the initialized process
    group (``initialize_distributed``). The shape must multiply to the world
    size: a mesh never runs on fewer ranks than it names. Without a process
    group only a mesh of one process exists."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match the axes {axis_names}")
    check_world(shape)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.is_initialized() and dist.get_backend() == "nccl"
                  else torch.device("cpu"))
    sizes = dict(zip(axis_names, shape))
    if not dist.is_initialized():
        return Mesh(shape=sizes, rank=0, coords={a: 0 for a in axis_names},
                    groups={a: None for a in axis_names},
                    ranks={a: [0] for a in axis_names}, device=device,
                    axis_names=tuple(axis_names))
    from torch.distributed.device_mesh import init_device_mesh

    rank = dist.get_rank()
    dm = init_device_mesh(device.type, shape, mesh_dim_names=tuple(axis_names))
    coords, groups, ranks = {}, {}, {}
    rem = rank
    for i, a in enumerate(axis_names):
        stride = 1
        for s in shape[i + 1:]:
            stride *= s
        coords[a] = rem // stride
        rem %= stride
        groups[a] = dm.get_group(a)
        ranks[a] = list(dist.get_process_group_ranks(groups[a]))
    return Mesh(shape=sizes, rank=rank, coords=coords, groups=groups, ranks=ranks,
                device=device, device_mesh=dm, axis_names=tuple(axis_names))


# the element counts (float32) warm_collectives sends each collective at:
# NCCL picks its protocol by size and builds a protocol's connections at
# its first use, so one small and one large message each
_WARM_NUMELS = (1, 1 << 20)


def warm_collectives(mesh: Mesh) -> float:
    """Every kind of collective a step body issues, on the group of each
    sharded axis, before any program runs: an all-reduce, a broadcast, an
    all-gather and a reduce-scatter (the tensor axis' row-parallel seams,
    the frames axis' gathers), and on the frames axis one exchange each way
    around the ring; then the world group's all-gather and all-reduce (the
    device probe's), each at :data:`_WARM_NUMELS`. NCCL builds a group's
    communicator and a pair's point-to-point connections at their first
    use, so no program's first call pays for them and no CUDA graph capture
    is the first to use them (each step variant's first step, eager, then
    issues each of its collectives at its own size before the variant is
    captured). Also creates the host control channel's gloo group
    (``parallel/distributed.py:control_group``), which a served mesh's
    rank 0 drives the other ranks through. Not counted by a
    :class:`CommRecorder` (no program's traffic). Returns the seconds it
    took (0.0 without a process group)."""
    if not dist.is_initialized():
        return 0.0
    t0 = time.perf_counter()
    for numel in _WARM_NUMELS:
        for axis in mesh.axis_names:
            group = mesh.group(axis)
            n = _size(group)
            if n == 1:
                continue
            whole = torch.zeros(numel * n, device=mesh.device)
            part = torch.zeros(numel, device=mesh.device)
            dist.all_reduce(whole, group=group)
            dist.broadcast(whole, src=mesh.ranks[axis][0], group=group)
            dist.all_gather(list(whole.chunk(n)), part, group=group)
            dist.reduce_scatter(part, list(whole.chunk(n)), group=group)
            if axis == AXIS_FRAMES:
                ranks, i = mesh.ranks[axis], mesh.coords[axis]
                for step in (1, -1):
                    buf = torch.empty_like(part)
                    for req in dist.batch_isend_irecv([
                            dist.P2POp(dist.isend, part, ranks[(i + step) % n], group),
                            dist.P2POp(dist.irecv, buf, ranks[(i - step) % n], group)]):
                        req.wait()
        world = dist.get_world_size()
        if world > 1:
            part = torch.zeros(numel, device=mesh.device)
            dist.all_gather([torch.empty_like(part) for _ in range(world)], part)
            dist.all_reduce(part, op=dist.ReduceOp.MAX)
    from videop2p_tpu_torch.parallel.distributed import control_group

    control_group()
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    return time.perf_counter() - t0


_ACTIVE: List[Mesh] = []


def active_mesh() -> Optional[Mesh]:
    """The mesh the pipelines' global reductions and draws read (set by
    ``cli/common.py:setup_mesh``); None on a single device."""
    return _ACTIVE[-1] if _ACTIVE else None


def set_active_mesh(mesh: Optional[Mesh]) -> None:
    """Make ``mesh`` the active one (None clears it)."""
    _ACTIVE.clear()
    if mesh is not None:
        _ACTIVE.append(mesh)


def _frames(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.shape[AXIS_FRAMES]


# ------------------------------------------------ collective accounting --

_RECORDERS: List["CommRecorder"] = []
_REC_LOCK = threading.Lock()


class CommRecorder:
    """Counts the collectives this process issues while it is active, by
    kind (the XLA names ``obs/comm.py`` uses) and by bytes — the bytes of
    each collective's result on this rank, as JAX's ``collective_summary``
    counts an HLO instruction's result shape. ``sequence`` keeps the
    ordered (kind, bytes) list, whose digest is the record's fingerprint."""

    def __init__(self):
        self.per_kind: Dict[str, Dict[str, int]] = {}
        self.sequence: List[Tuple[str, int]] = []

    def add(self, kind: str, nbytes: int) -> None:
        slot = self.per_kind.setdefault(kind, {"count": 0, "bytes": 0})
        slot["count"] += 1
        slot["bytes"] += int(nbytes)
        self.sequence.append((kind, int(nbytes)))

    def count(self, kind: Optional[str] = None) -> int:
        if kind is None:
            return sum(s["count"] for s in self.per_kind.values())
        return self.per_kind.get(kind, {}).get("count", 0)

    def bytes(self, kind: Optional[str] = None) -> int:
        if kind is None:
            return sum(s["bytes"] for s in self.per_kind.values())
        return self.per_kind.get(kind, {}).get("bytes", 0)

    def fingerprint(self) -> str:
        h = hashlib.sha256(repr(self.sequence).encode())
        return h.hexdigest()[:16]

    def __enter__(self) -> "CommRecorder":
        with _REC_LOCK:
            _RECORDERS.append(self)
        return self

    def __exit__(self, *exc) -> None:
        with _REC_LOCK:
            if self in _RECORDERS:
                _RECORDERS.remove(self)


def _note(kind: str, nbytes: int) -> None:
    for rec in list(_RECORDERS):
        rec.add(kind, nbytes)


def note_collective(kind: str, nbytes: int, group=None) -> None:
    """One collective this process issues on ``group`` (None: the world's
    group); every wrapper calls it where it issues one. Inside a CUDA graph
    capture (``utils/cuda_graphs.py``) the group must be NCCL's — a gloo
    collective cannot be captured, and raises here — and the count is
    recorded for the graph: each replay adds it, so a recorder counts a
    replayed step's collectives as it counts an eager step's."""
    if _graphs.capturing():
        backend = dist.get_backend(group)
        if backend != "nccl":
            raise RuntimeError(
                f"a CUDA graph capture reached a {kind} on a {backend} group: only NCCL "
                "collectives are captured in a step body (the gloo control channel runs "
                "between calls); run this loop with cuda_graphs=False")
    _graphs.count_launch(lambda n: _note(kind, nbytes), 1)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    note_collective("all-reduce", _nbytes(t), group)
    dist.all_reduce(t, group=group)
    return t


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(_size(group))]
    out_bytes = _nbytes(t) * len(parts)
    note_collective("all-gather", out_bytes, group)
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = _size(group)
    chunks = [c.contiguous() for c in t.chunk(n, dim=dim)]
    out = torch.empty_like(chunks[0])
    note_collective("reduce-scatter", _nbytes(out), group)
    dist.reduce_scatter(out, chunks, group=group)
    return out


class _AllReduce(torch.autograd.Function):
    """Sum over a group; the backward sums the gradients over it too (every
    rank's loss depends on the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.clone().contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone().contiguous(), ctx.group), None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, differentiable; ``x`` itself for a
    group of one."""
    if _size(group) == 1:
        return x
    return _AllReduce.apply(x, group)


class _BroadcastFirst(torch.autograd.Function):
    """Group rank 0's tensor on every rank; the backward sums the gradients
    onto rank 0 (the others' inputs did not reach the output)."""

    @staticmethod
    def forward(ctx, x, group, src: int, is_src: bool):
        ctx.group, ctx.is_src = group, is_src
        y = x.clone().contiguous()
        note_collective("collective-broadcast", _nbytes(y), group)
        dist.broadcast(y, src=src, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce_(g.clone().contiguous(), ctx.group)
        if not ctx.is_src:
            g = torch.zeros_like(g)
        return g, None, None, None


def broadcast_first(x: torch.Tensor, mesh: Mesh, axis: str = AXIS_FRAMES) -> torch.Tensor:
    """``x`` of the first rank of this rank's ``axis`` group, on every rank
    of it (the frame-0 K/V of the sharded frame attention)."""
    group = mesh.group(axis)
    if _size(group) == 1:
        return x
    return _BroadcastFirst.apply(x, group, mesh.ranks[axis][0], mesh.coords[axis] == 0)


class _AllGather(torch.autograd.Function):
    """Concatenation over a group along ``dim``; the backward reduce-scatters
    (every rank's loss reads every slice)."""

    @staticmethod
    def forward(ctx, x, group, dim: int):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g.contiguous(), ctx.group, ctx.dim), None, None


def gather_frames(x: torch.Tensor, mesh: Optional[Mesh] = None, dim: int = 1, *,
                  axis: str = AXIS_FRAMES) -> torch.Tensor:
    """The global tensor from every rank's frame block (differentiable);
    ``x`` itself without a mesh or on one rank of frames."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None or mesh.shape[axis] == 1:
        return x
    return _AllGather.apply(x, mesh.group(axis), dim % x.dim())


def frames_slice(x: torch.Tensor, mesh: Optional[Mesh] = None, dim: int = 1) -> torch.Tensor:
    """This rank's frame block of a global tensor (frames ``[s·F/sp,
    (s+1)·F/sp)``); ``x`` itself without a mesh."""
    mesh = mesh if mesh is not None else active_mesh()
    sp = _frames(mesh)
    if sp == 1:
        return x
    f = x.shape[dim]
    if f % sp:
        raise ValueError(f"the frames axis {sp} must divide the frame count {f}")
    per = f // sp
    return x.narrow(dim, mesh.coords[AXIS_FRAMES] * per, per)


def frames_draw(draw: Callable[[Tuple[int, ...]], torch.Tensor],
                local_shape: Sequence[int], dim: int = 1) -> torch.Tensor:
    """A random draw of a frame-sharded tensor: ``draw(shape)`` of the
    GLOBAL shape on every rank (one generator, the same state everywhere),
    then this rank's frames, so the sharded run draws what the unsharded
    one does and the generators stay in step. A loop draws outside its step
    bodies, into the buffer a body reads (a graph would replay one draw):
    inside a capture it raises."""
    if _graphs.capturing():
        raise RuntimeError("frames_draw inside a CUDA graph capture: draw before the step "
                           "body, into the buffer it reads")
    mesh = active_mesh()
    sp = _frames(mesh)
    if sp == 1:
        return draw(tuple(local_shape))
    full = list(local_shape)
    full[dim] *= sp
    return frames_slice(draw(tuple(full)), mesh, dim)


class _GlobalSum(torch.autograd.Function):
    """Sum over the frames group whose backward is the identity: each rank
    backpropagates its own share of a global loss."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_(x.clone().contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """``torch.mean(x)`` over the frames of every rank for a frame-sharded
    ``x`` (the null-text and Stage-1 losses): the value is the global mean
    on every rank, its gradient this rank's share of it. Without a sharded
    frames axis it is ``torch.mean(x)``."""
    mesh = active_mesh()
    sp = _frames(mesh)
    if sp == 1:
        return torch.mean(x)
    local = x.sum() / (x.numel() * sp)
    return _GlobalSum.apply(local, mesh.group(AXIS_FRAMES))


@torch.no_grad()
def reduce_frame_grads(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Gradients of replicated parameters summed over the frames group (one
    flat all-reduce); the list unchanged without a sharded frames axis."""
    grads = list(grads)
    mesh = active_mesh()
    if _frames(mesh) == 1 or not grads:
        return grads
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    _all_reduce_(flat, mesh.group(AXIS_FRAMES))
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view(g.shape).to(g.dtype))
        i += g.numel()
    return out


def sharded_square_sum(x: torch.Tensor) -> torch.Tensor:
    """A sum of squares of tensor-split parameters' gradients summed over
    the active mesh's ``tensor`` group (the global clip norm counts each
    split parameter once)."""
    mesh = active_mesh()
    if mesh is None or mesh.shape[AXIS_TENSOR] == 1:
        return x
    return _all_reduce_(torch.as_tensor(x, dtype=torch.float32).clone(),
                        mesh.group(AXIS_TENSOR))


# -------------------------------------------------- tensor parallelism --


class _CopyToTensor(torch.autograd.Function):
    """Megatron's ``f``: the identity, whose backward sums the gradient over
    the tensor group (each rank's column shard sees a part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone().contiguous(), ctx.group), None


class _ReduceFromTensor(torch.autograd.Function):
    """Megatron's ``g``: the partial sums of a row-parallel product reduced
    over the tensor group — an all-reduce, or with ``scatter`` a
    reduce-scatter over the token axis and an all-gather back — whose
    backward is the identity."""

    @staticmethod
    def forward(ctx, x, group, scatter: bool, tok: int):
        x = x.contiguous()
        if scatter:
            return _all_gather(_reduce_scatter(x, group, tok), group, tok)
        return _all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def make_tensor_copy_fn(mesh: Mesh) -> Optional[Callable]:
    """The column-parallel entry (Megatron's ``f``) over ``tensor``; None
    for a tensor axis of one."""
    group = mesh.group(AXIS_TENSOR)
    if _size(group) == 1:
        return None
    return lambda x: _CopyToTensor.apply(x, group)


def make_megatron_out_dot(mesh: Mesh, tp_collectives: str = "gspmd") -> Optional[Callable]:
    """The row-parallel output projection of the ``row_parallel_dot`` seam:
    ``dot(x, weight, bias)`` multiplies the local input features by the
    local rows of the weight, reduces the partial sums over ``tensor`` and
    adds the bias once. ``"gspmd"`` all-reduces the full result;
    ``"psum_scatter"`` reduce-scatters it over the token axis (each rank
    receives 1/tp of the bytes) and all-gathers it back — where the token
    axis does not divide by tp it all-reduces, as the JAX seam falls back
    to the plain dot. None for a tensor axis of one."""
    if tp_collectives not in TP_COLLECTIVES:
        raise ValueError(f"tp_collectives must be one of {TP_COLLECTIVES}, "
                         f"got {tp_collectives!r}")
    group = mesh.group(AXIS_TENSOR)
    tp = _size(group)
    if tp == 1:
        return None

    def dot(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]):
        w = weight if weight.dtype == x.dtype else weight.to(x.dtype)
        part = F.linear(x, w)
        tok = part.dim() - 2
        scatter = (tp_collectives == "psum_scatter" and part.dim() >= 2
                   and part.shape[tok] % tp == 0)
        y = _ReduceFromTensor.apply(part, group, scatter, tok)
        if bias is not None:
            y = y + (bias if bias.dtype == y.dtype else bias.to(y.dtype))
        return y

    dot.tp_collectives = tp_collectives
    return dot


def make_head_mean_fn(mesh: Mesh) -> Optional[Callable]:
    """The head-mean of attention maps whose heads are split evenly over
    ``tensor`` (the ``attn_store`` maps LocalBlend reads): the local heads'
    sum all-reduced, over every rank's heads. None for a tensor axis of
    one."""
    group = mesh.group(AXIS_TENSOR)
    tp = _size(group)
    if tp == 1:
        return None

    def mean(probs: torch.Tensor) -> torch.Tensor:
        s = probs.float().sum(dim=1)
        return (_all_reduce_(s, group) / (probs.shape[1] * tp)).to(probs.dtype)

    return mean


# ------------------------------------------------------------- params --


def _tensor_rule(path: Sequence[str]) -> Optional[int]:
    """JAX's ``param_shardings`` rule on a flax path: the sharded dimension
    of a 2-D kernel, as the flax kernel's (in, out) index — 1 (column
    parallel, ``P(None, "tensor")``), 0 (row parallel, ``P("tensor",
    None)``) — or None (replicated)."""
    keys = [str(p) for p in path]
    joined = "/".join(keys)
    if "attn" in joined or "ff" in joined:
        if any(k in ("to_out", "proj_out") for k in keys):
            return 0
        if any(k in ("to_q", "to_k", "to_v", "proj_geglu", "proj_in") for k in keys):
            return 1
    return None


def param_shardings(mesh: Mesh, unet, *, tensor_parallel: bool = False
                    ) -> Dict[str, Optional[int]]:
    """{UNet parameter name: the torch dimension split over ``tensor``, or
    None (replicated)} by JAX's own path rule on the flax path of each
    parameter (``models/convert.py:unet_jax_paths``). Only 2-D kernels
    shard, as in JAX: a flax (in, out) kernel is a torch (out, in) weight,
    so JAX's column-parallel ``P(None, "tensor")`` is torch dimension 0 and
    its row-parallel ``P("tensor", None)`` dimension 1. Default: everything
    replicated."""
    from videop2p_tpu_torch.models.convert import unet_jax_paths

    specs: Dict[str, Optional[int]] = {}
    for name, path in unet_jax_paths(unet).items():
        jax_dim = _tensor_rule(path) if tensor_parallel and path[-1] == "kernel" else None
        specs[name] = None if jax_dim is None else 1 - jax_dim
    return specs


def _is_geglu(name: str) -> bool:
    return ".net.0.proj." in f".{name}"


def _shard_tensor(name: str, t: torch.Tensor, dim: int, tp: int, index: int) -> torch.Tensor:
    """``t``'s slice ``index`` of ``tp`` along ``dim``. GEGLU's
    ``proj_geglu`` concatenates the ``h`` half and the ``gate`` half along
    its output features: each rank takes the matching slice of BOTH halves,
    so the local ``chunk(2)`` pairs them as the whole one does."""
    if _is_geglu(name) and dim == 0:
        h, gate = t.chunk(2, dim=0)
        return torch.cat([h.chunk(tp, dim=0)[index], gate.chunk(tp, dim=0)[index]], dim=0)
    if t.shape[dim] % tp:
        raise ValueError(f"{name}: dimension {dim} of {tuple(t.shape)} does not split "
                         f"over tensor {tp}")
    return t.chunk(tp, dim=dim)[index]


def _split_dims(specs: Dict[str, Optional[int]], tensors) -> Dict[str, int]:
    """{name: dim} of every split tensor of ``specs``, with the bias of
    each column-parallel weight, which follows its output features (JAX
    keeps 1-D biases replicated and GSPMD slices them; here the local
    product needs its slice)."""
    dims = {k: d for k, d in specs.items() if d is not None}
    dims.update({name[:-len("weight")] + "bias": 0 for name, d in specs.items()
                 if d == 0 and name.endswith(".weight")
                 and name[:-len("weight")] + "bias" in tensors})
    return dims


def shard_state_dict(state_dict: Dict[str, torch.Tensor], specs: Dict[str, Optional[int]],
                     mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This tensor rank's slices of a whole state dict (the ``specs`` of
    :func:`param_shardings`; a column-parallel weight's bias follows it)."""
    dims = _split_dims(specs, state_dict)
    return {name: shard_tensor(name, t, dims.get(name), mesh)
            for name, t in state_dict.items()}


def gather_state_dict(module, mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """The whole state dict of a UNet sharded by :func:`shard_unet`: every
    tensor-split parameter all-gathered over ``tensor`` (GEGLU's halves put
    back in place). A collective: every rank receives it, rank 0 writes
    it."""
    dims = getattr(module, "tp_shard_dims", None) or {}
    return {name: gather_tensor(name, t, dims.get(name), mesh)
            for name, t in module.state_dict().items()}


@torch.no_grad()
def gather_tensor(name: str, t: torch.Tensor, dim: Optional[int],
                  mesh: Optional[Mesh]) -> torch.Tensor:
    """The whole tensor of a parameter (or of optimizer state shaped like
    it) split over ``tensor`` along ``dim`` (None: replicated, returned as
    it is). A collective over the tensor group."""
    if dim is None or mesh is None or mesh.shape[AXIS_TENSOR] == 1:
        return t
    tp = mesh.shape[AXIS_TENSOR]
    parts = [torch.empty_like(t) for _ in range(tp)]
    note_collective("all-gather", _nbytes(t) * tp, mesh.group(AXIS_TENSOR))
    dist.all_gather(parts, t.contiguous(), group=mesh.group(AXIS_TENSOR))
    if _is_geglu(name) and dim == 0:
        halves = [p.chunk(2, dim=0) for p in parts]
        return torch.cat([h for h, _ in halves] + [g for _, g in halves], dim=0)
    return torch.cat(parts, dim=dim)


def shard_tensor(name: str, t: torch.Tensor, dim: Optional[int],
                 mesh: Optional[Mesh]) -> torch.Tensor:
    """This tensor rank's slice of a whole tensor split along ``dim`` (the
    inverse of :func:`gather_tensor`; None: ``t`` itself)."""
    if dim is None or mesh is None or mesh.shape[AXIS_TENSOR] == 1:
        return t
    return _shard_tensor(name, t, dim, mesh.shape[AXIS_TENSOR], mesh.coords[AXIS_TENSOR])


@torch.no_grad()
def shard_unet(unet, mesh: Mesh) -> Dict[str, int]:
    """Slice a whole UNet's tensor-parallel parameters in place to this
    tensor rank's shards (``param_shardings`` with ``tensor_parallel``) and
    make its attention modules count their local heads. Each sharded
    parameter keeps its ``nn.Parameter`` (its data replaced), so a train
    state built afterwards holds the shards. Returns and records on the
    module ``tp_shard_dims``: {name: dim} of the sharded tensors."""
    from videop2p_tpu_torch.models.attention import ControlledAttention, FrameAttention

    tp = mesh.shape[AXIS_TENSOR]
    if tp == 1:
        unet.tp_shard_dims = {}
        return {}
    params = dict(unet.named_parameters())
    dims = _split_dims(param_shardings(mesh, unet, tensor_parallel=True), params)
    local = shard_state_dict({k: p.data for k, p in params.items()}, dims, mesh)
    for name, d in dims.items():
        params[name].data = local[name].clone()
        params[name].tp_shard_dim = d
    for m in unet.modules():
        if isinstance(m, (ControlledAttention, FrameAttention)):
            if m.heads % tp:
                raise ValueError(f"{m.heads} heads do not split over tensor {tp}")
            m.heads //= tp
            m.tp_size = tp
    unet.tp_shard_dims = dims
    return dims


# ------------------------------------------------------ sharded seams --


def make_sharded_frame_attention_fn(mesh: Mesh, impl: str = "auto") -> Callable:
    """The frame attention of the ``frame_attention_fn`` seam on a mesh:
    frame 0 lives on frames-rank 0, so its K/V are broadcast over the
    frames group (the backward sums their gradients back onto it), then the
    port's ``make_frame_attention_fn(impl)`` — the hand kernel on a CUDA
    tensor — runs on this rank's frames and heads. Softmax rows are per
    query, so the frame split is exact."""
    from videop2p_tpu_torch.ops.attention import make_frame_attention_fn

    inner = make_frame_attention_fn(impl)

    def fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        k = broadcast_first(k, mesh)
        v = broadcast_first(v, mesh)
        return inner(q, k, v)

    fn.mesh, fn.impl = mesh, impl
    return fn


def _pooled_group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                       num_groups: int, eps: float, act: str, group) -> torch.Tensor:
    """The plain version of :func:`pooled_group_norm`, differentiable: each
    rank's per-(sample, group) Σx and Σx² all-reduced (f32), then JAX's
    E[x²] − E[x]² (``group_norm_reference``)."""
    n, rows, c = x.shape
    g = num_groups
    xf = x.float().reshape(n, rows, g, c // g)
    stats = torch.stack([xf.sum(dim=(1, 3)), (xf * xf).sum(dim=(1, 3))])
    stats = all_reduce(stats, group)
    count = rows * (c // g) * _size(group)
    mean = (stats[0] / count)[:, None, :, None]
    var = (stats[1] / count)[:, None, :, None] - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y.reshape(n, rows, c) * scale.float() + bias.float()
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


class _PooledGroupNorm(torch.autograd.Function):
    """The GroupNorm kernel in two launches around the all-reduce of the
    statistics; the backward recomputes through :func:`_pooled_group_norm`
    (its all-reduces included), as the fused kernel's recomputes through
    its plain version."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups: int, eps: float, act: str, group):
        from videop2p_tpu_torch.ops.groupnorm import group_norm_apply, group_norm_stats

        ctx.save_for_backward(x, scale, bias)
        ctx.config = dict(num_groups=num_groups, eps=eps, act=act, group=group)
        sums = group_norm_stats(x, num_groups=num_groups)
        if _size(group) > 1:
            _all_reduce_(sums, group)
        return group_norm_apply(x, sums, scale, bias, num_groups=num_groups, eps=eps,
                                act=act, shards=_size(group))

    @staticmethod
    def backward(ctx, grad_out):
        from videop2p_tpu_torch.ops._autograd import recompute_grads

        def plain(x, scale, bias):
            return _pooled_group_norm(x, scale, bias, **ctx.config)

        return recompute_grads(plain, ctx.saved_tensors, ctx.needs_input_grad[:3],
                               grad_out) + (None,) * 4


def pooled_group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                      num_groups: int, eps: float, act: str, group) -> torch.Tensor:
    """GroupNorm(+SiLU) of a (N, rows, C) slab whose rows are split over
    ``group`` (each rank holds ``rows`` of them): on a CUDA tensor the
    GroupNorm kernel's statistics launch, an all-reduce of the (N, G, 2)
    sums over ``group`` and its apply launch; on a CPU tensor the plain
    version. Differentiable in x, scale and bias. A group of one (None) runs
    both launches with no collective."""
    if x.device.type == "cpu":
        return _pooled_group_norm(x, scale, bias, num_groups=num_groups, eps=eps, act=act,
                                  group=group)
    return _PooledGroupNorm.apply(x, scale, bias, num_groups, float(eps), act, group)


def make_sharded_group_norm_fn(mesh: Mesh) -> Callable:
    """GroupNorm(+SiLU) for the ``group_norm_fn`` seam on a mesh, chosen by
    the kind of site: a per-frame slab (the transformer's entry norm, frames
    folded into the samples) and any slab on a frames axis of one is whole
    on this rank, so it goes to ``fused_group_norm``, one launch of the
    kernel on a CUDA tensor; a frame-pooled slab (the resnet norms,
    ``conv_norm_out``) over a sharded frames axis all-reduces its partial
    statistics between the kernel's two staged launches
    (:func:`pooled_group_norm`), where JAX's wrapper leaves those sites to
    the two-pass math GSPMD partitions."""
    from videop2p_tpu_torch.ops.groupnorm import fused_group_norm

    group = mesh.group(AXIS_FRAMES)

    def fn(x2, scale, bias, *, num_groups: int, eps: float, act: str, pooled: bool):
        if pooled and _size(group) > 1:
            return pooled_group_norm(x2, scale, bias, num_groups=num_groups, eps=eps,
                                     act=act, group=group)
        return fused_group_norm(x2, scale, bias, num_groups=num_groups, eps=eps, act=act)

    fn.mesh = mesh
    return fn


def make_kv_gather_fn(mesh: Mesh) -> Optional[Callable]:
    """The controlled temporal sites' K/V over every frame: (B·N, H, F/sp,
    D) → (B·N, H, F, D), all-gathered over ``frames`` (differentiable). Each
    rank keeps its own query rows, so its maps are (B·N, H, F/sp, F): the
    capture trees and the edit read this rank's rows. None on one rank of
    frames."""
    if mesh.shape[AXIS_FRAMES] == 1:
        return None

    def gather(k: torch.Tensor, v: torch.Tensor):
        return gather_frames(k, mesh, dim=-2), gather_frames(v, mesh, dim=-2)

    return gather

