"""Distributed observability: collective-communication accounting and
per-device telemetry of a mesh run (port of ``videop2p_tpu/obs/comm.py``).

  * **Collective accounting** — JAX mines the optimized HLO of a compiled
    sharded program (``collective_summary``). The port has no HLO: every
    collective goes through a wrapper of ``parallel/mesh.py`` /
    ``parallel/ring.py``, which reports its kind and bytes to the active
    :class:`~videop2p_tpu_torch.parallel.mesh.CommRecorder`.
    :func:`comm_analysis_record` turns what a program's FIRST call issued
    into the ``comm_analysis`` event (the convention of
    ``program_analysis``: the executed first call). So counts and bytes are
    per executed call on this rank — a collective inside a loop counts
    every trip, where JAX's static count takes a ``scan`` body once — and
    bytes are each collective's result bytes on this rank, JAX's
    convention. The kinds are XLA's names: ``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``collective-permute`` (a ring send),
    ``collective-broadcast`` (the frame-0 K/V).

  * **Per-device telemetry and divergence** — :func:`make_device_probe`
    builds a probe the edit loops call after each step (the
    ``device_probe=`` seam of ``pipelines/sampling.py:edit_sample``): each
    rank's abs-max / mean / NaN / inf of its LOCAL shard, gathered over the
    world into ``(world,)`` channels, and the divergence — the max abs
    difference of the probed tensor across the mesh axes it is meant to be
    replicated over (every rank compared with its group's rank 0), maxed
    over the world. :func:`replica_divergence` is the standalone form
    (Stage 1 applies it to the tuned parameters). Divergence must be 0.0.

Imports torch only (and the port's own modules).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from videop2p_tpu_torch.obs.telemetry import latent_stats
from videop2p_tpu_torch.parallel.mesh import CommRecorder, Mesh, note_collective

__all__ = [
    "COLLECTIVE_KINDS",
    "COMM_ANALYSIS_FIELDS",
    "DEVICE_TELEMETRY_FIELDS",
    "comm_analysis_record",
    "sharding_strs",
    "make_device_probe",
    "replica_divergence",
    "tree_replica_divergence",
    "split_device_stats",
    "summarize_device_stats",
]

# the collective families (JAX's tuple, in XLA's names)
COLLECTIVE_KINDS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "collective-permute",
    "all-to-all",
    "collective-broadcast",
)

# schema-stable field sets: every comm_analysis / device_telemetry ledger
# event carries at least these (JAX's)
COMM_ANALYSIS_FIELDS = (
    "num_partitions",
    "collective_count",
    "collective_bytes",
    "per_kind",
    "arg_shardings",
    "out_shardings",
    "hlo_fingerprint",
)
DEVICE_TELEMETRY_FIELDS = (
    "devices",
    "divergence_max",
    "divergence_final",
    "per_device_abs_max_peak",
    "per_device_nan_total",
)

# the latents' layout: batch over data, frames over frames (JAX's
# latent_sharding); the probe's divergence axes are the others
LATENT_SPEC = ("data", "frames")


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [t for t in (getattr(tree, f, None) for f in getattr(
        tree, "__dataclass_fields__", ())) for t in _tensors(t)]


def sharding_strs(tree) -> List[str]:
    """Each tensor leaf's layout as this rank holds it: ``local(<shape>)``.
    JAX renders the ``PartitionSpec`` of a global array; the port's
    arguments are already the local shards (a frame-sharded latent holds
    F/sp frames), so their shapes are the explicit counterpart."""
    return [f"local{tuple(t.shape)}" for t in _tensors(tree)]


def comm_analysis_record(recorder: CommRecorder, *, mesh: Optional[Mesh] = None,
                         args=None, out=None) -> Dict[str, Any]:
    """The ``comm_analysis`` record of what ``recorder`` saw: the partition
    count (the mesh's processes), per-kind counts and bytes (plus the
    flattened ``<kind>_count`` / ``<kind>_bytes`` keys the regression rules
    target), the arguments' and outputs' layouts and a fingerprint of the
    ordered (kind, bytes) sequence."""
    per_kind = {k: dict(v) for k, v in recorder.per_kind.items()}
    rec: Dict[str, Any] = {
        "num_partitions": 1 if mesh is None else mesh.size,
        "collective_count": recorder.count(),
        "collective_bytes": recorder.bytes(),
        "per_kind": per_kind,
        "hlo_fingerprint": recorder.fingerprint(),
        "arg_shardings": sharding_strs(args),
        "out_shardings": sharding_strs(out),
    }
    if mesh is not None:
        rec["mesh"] = mesh.spec()
    for kind, slot in per_kind.items():
        flat = kind.replace("-", "_")
        rec[f"{flat}_count"] = slot["count"]
        rec[f"{flat}_bytes"] = slot["bytes"]
    return rec


# --------------------------------------------------------------- probes --


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _gather_world(x: torch.Tensor) -> torch.Tensor:
    """(world, *x.shape): every rank's ``x`` in rank order."""
    if _world() == 1:
        return x[None]
    parts = [torch.empty_like(x) for _ in range(_world())]
    note_collective("all-gather", x.numel() * x.element_size() * len(parts))
    dist.all_gather(parts, x.contiguous())
    return torch.stack(parts)


def _max_world(x: torch.Tensor) -> torch.Tensor:
    if _world() == 1:
        return x
    x = x.clone()
    note_collective("all-reduce", x.numel() * x.element_size())
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return x


def _group_divergence(x: torch.Tensor, mesh: Mesh, axes: Sequence[str]) -> torch.Tensor:
    """Max abs difference of ``x`` between this rank and the rank 0 of its
    group along each of ``axes`` (float32 scalar, this rank's view)."""
    div = torch.zeros((), dtype=torch.float32, device=x.device)
    xf = x.detach().float().contiguous()
    for axis in axes:
        group = mesh.group(axis)
        if group is None or mesh.shape[axis] == 1:
            continue
        ref = xf.clone()
        note_collective("collective-broadcast", ref.numel() * ref.element_size())
        dist.broadcast(ref, src=mesh.ranks[axis][0], group=group)
        div = torch.maximum(div, (xf - ref).abs().amax() if xf.numel() else div)
    return div


def make_device_probe(mesh: Mesh, *, latent_spec: Sequence[str] = LATENT_SPEC,
                      divergence_axes: Optional[Sequence[str]] = None) -> Callable:
    """Per-device telemetry probe of a tensor laid out as ``latent_spec``
    (default the latents' ``("data", "frames")``) on ``mesh``.

    ``probe(x)`` returns ``device_abs_max`` / ``device_mean`` /
    ``device_nan_count`` / ``device_inf_count``, each ``(world,)`` in rank
    order (``probe.device_ids``), of each rank's LOCAL ``x``, and
    ``divergence``: the max abs difference of ``x`` across
    ``divergence_axes`` — by default every >1-sized axis the spec does not
    split, along which the tensor must be replicated — maxed over the
    world; 0.0 when there is none."""
    if divergence_axes is None:
        divergence_axes = tuple(a for a in mesh.axis_names
                                if a not in latent_spec and mesh.shape[a] > 1)
    divergence_axes = tuple(divergence_axes)

    def probe(x: torch.Tensor) -> Dict[str, torch.Tensor]:
        stats = latent_stats(x)
        keys = ("abs_max", "mean", "nan_count", "inf_count")
        local = torch.stack([stats[k].float() for k in keys])
        every = _gather_world(local)
        out = {f"device_{k}": (every[:, i] if k in ("abs_max", "mean")
                               else every[:, i].to(torch.int32))
               for i, k in enumerate(keys)}
        out["divergence"] = _max_world(_group_divergence(x, mesh, divergence_axes))
        return out

    probe.device_ids = list(range(mesh.size))
    probe.divergence_axes = divergence_axes
    return probe


def replica_divergence(x: torch.Tensor, mesh: Mesh, *, axes: Sequence[str]) -> torch.Tensor:
    """Max abs difference of ``x`` across the ranks of ``axes`` it is meant
    to be replicated over, maxed over the world — 0.0 iff every replica
    holds the same values (a float32 scalar, the same on every rank). A
    collective: every rank of the mesh calls it."""
    return _max_world(_group_divergence(x, mesh, tuple(axes)))


def tree_replica_divergence(tree, mesh: Mesh, *, axes: Sequence[str]) -> torch.Tensor:
    """Worst-case :func:`replica_divergence` over a tree's tensor leaves
    (one collective each, in the tree's order)."""
    leaves = [t for t in _tensors(tree) if t.numel()]
    if not leaves or not tuple(axes):
        return torch.zeros((), dtype=torch.float32)
    return torch.stack([replica_divergence(t, mesh, axes=axes).cpu() for t in leaves]).max()


# ------------------------------------------------------------- decoders --


def split_device_stats(stats: Dict) -> Tuple[Dict, Dict]:
    """Split a telemetry tree into (plain per-step stats, device-probe
    channels) — the ledger writes them as separate events."""
    dev = {k: v for k, v in stats.items() if k.startswith("device_") or k == "divergence"}
    rest = {k: v for k, v in stats.items() if k not in dev}
    return rest, dev


def summarize_device_stats(stats: Dict, device_ids: Optional[Sequence[int]] = None
                           ) -> Dict[str, Any]:
    """Ledger-sized summary of the device-probe channels (JAX's): per-device
    abs-max peaks and NaN/inf totals over the steps, the divergence
    extremes. Degenerate inputs summarize to zeros rather than raising."""
    host = {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v,
                          np.float64) for k, v in stats.items()}
    rec: Dict[str, Any] = {}

    def per_device(key):
        v = host.get(key)
        if v is None or v.size == 0:
            return None
        return v.reshape(-1, v.shape[-1]) if v.ndim > 1 else v[None]

    am = per_device("device_abs_max")
    rec["devices"] = int(am.shape[-1]) if am is not None else 0
    rec["per_device_abs_max_peak"] = (
        [round(float(v), 6) for v in am.max(axis=0)] if am is not None else [])
    mean = per_device("device_mean")
    if mean is not None:
        rec["per_device_mean_final"] = [round(float(v), 6) for v in mean[-1]]
    for key, out in (("device_nan_count", "per_device_nan_total"),
                     ("device_inf_count", "per_device_inf_total")):
        v = per_device(key)
        rec[out] = [int(t) for t in v.sum(axis=0)] if v is not None else []
    rec["nan_total"] = int(sum(rec["per_device_nan_total"]))
    dv = host.get("divergence")
    if dv is not None and dv.size:
        flat = dv.reshape(-1)
        rec["divergence_max"] = float(flat.max())
        rec["divergence_final"] = float(flat[-1])
    else:
        rec["divergence_max"] = 0.0
        rec["divergence_final"] = 0.0
    if device_ids is not None:
        rec["device_ids"] = [int(i) for i in device_ids]
    return rec
