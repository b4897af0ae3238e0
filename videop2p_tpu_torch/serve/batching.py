"""Micro-batching for concurrent edit requests (port of
``videop2p_tpu/serve/batching.py``).

Requests are *compatible* when one edit function serves them all: the same
program set (checkpoint, geometry, steps) and the same structure of the
``(CachedSource, cond, uncond, ControlContext, anchor)`` argument tree —
which fields hold tensors, their shapes, dtypes and devices, and the static
(non-tensor) controller and capture fields. :func:`compat_key` derives that
identity deterministically from the tree (:func:`tree_flatten`), never from
object ids.

:func:`plan_batches` is the pure grouping rule (deterministic — submit
order in, batch plan out), kept apart from the engine's threads. JAX pads a
group to a power-of-two bucket so that XLA compiles one program per bucket;
the port's programs are eager Python, so it has nothing to compile and
dispatches exactly the real members (a padded slot would be a whole edit
thrown away).

Dispatch modes:

  * ``"scan"`` (the one the port serves) — one dispatch whose members run
    one after another through the SAME edit function a singleton runs, so
    a batch's results are bit-identical to its members' singletons (the
    counterpart of JAX's ``lax.map``). The batch saves no device time over
    its singletons. :func:`stack_items` therefore keeps the members' trees
    as they are: stacking them on a new leading axis, as JAX does, would
    copy every capture (gigabytes at SD-1.5 width and 50 steps) for a loop
    that indexes it straight back out.
  * ``"vmap"`` — the JAX package's vectorized, data-mesh-sharded dispatch;
    it waits for the multi-GPU serving port (ROADMAP Queue 1 item 13's rest)
    and raises.
"""

from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = [
    "Batch",
    "compat_key",
    "plan_batches",
    "stack_items",
    "tree_flatten",
    "tree_tensors",
    "unstack_outputs",
]


def tree_flatten(tree: Any, path: str = "") -> Tuple[List[Tuple[str, torch.Tensor]], List[str]]:
    """``(tensor leaves, structure)`` of an argument tree: dataclasses by
    field, dicts by sorted key, lists and tuples by position; a tensor is a
    leaf (with its path), anything else is a static part of the structure
    (its path and ``repr``)."""
    leaves: List[Tuple[str, torch.Tensor]] = []
    structure: List[str] = []

    def walk(node: Any, p: str) -> None:
        if isinstance(node, torch.Tensor):
            leaves.append((p, node))
            structure.append(f"{p}:tensor")
        elif dataclasses.is_dataclass(node) and not isinstance(node, type):
            structure.append(f"{p}:{type(node).__name__}")
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name), f"{p}.{f.name}")
        elif isinstance(node, dict):
            structure.append(f"{p}:dict")
            for k in sorted(node):
                walk(node[k], f"{p}[{k!r}]")
        elif isinstance(node, (list, tuple)):
            structure.append(f"{p}:{type(node).__name__}{len(node)}")
            for i, v in enumerate(node):
                walk(v, f"{p}[{i}]")
        else:
            structure.append(f"{p}={node!r}")

    walk(tree, path)
    return leaves, structure


def tree_tensors(tree: Any) -> List[torch.Tensor]:
    """Every tensor leaf of an argument tree."""
    return [leaf for _, leaf in tree_flatten(tree)[0]]


def compat_key(args_tree: Any, extra: Tuple = ()) -> str:
    """Deterministic batching-compatibility key of a request's argument
    tree: its structure (the static fields of ControlContext / CachedSource
    included) plus every tensor leaf's shape, dtype and device, plus the
    ``extra`` statics the caller serves it with (step count, guidance scale,
    program-set identity)."""
    leaves, structure = tree_flatten(args_tree)
    parts = [repr(extra), "|".join(structure)]
    for p, leaf in leaves:
        parts.append(f"{p}:{tuple(leaf.shape)}:{leaf.dtype}:{leaf.device}")
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


@dataclass
class Batch:
    """One planned dispatch: ``items`` in submit order."""

    key: str
    items: List[Any]


def plan_batches(
    items: Sequence[Any],
    *,
    max_batch: int = 4,
    key_fn: Callable[[Any], str] = lambda item: item.compat,
    order: str = "first_seen",
    arrival_fn: Optional[Callable[[Any], Any]] = None,
) -> List[Batch]:
    """Group ``items`` by compatibility key into dispatch batches.

    Deterministic: groups form in first-seen-key order, items keep their
    submit order inside a group, and groups split into chunks of at most
    ``max_batch``.

    ``order`` picks the DISPATCH order of the planned chunks:

      * ``"first_seen"`` (default) — chunks dispatch in first-seen-key
        order;
      * ``"oldest"`` — chunks dispatch by the arrival of their OLDEST
        member (``arrival_fn`` per item; defaults to position in
        ``items``), stable-sorted.
    """
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if order not in ("first_seen", "oldest"):
        raise ValueError(f"order must be 'first_seen' or 'oldest', got {order!r}")
    arrivals = {id(item): (arrival_fn(item) if arrival_fn is not None else i)
                for i, item in enumerate(items)}
    groups: Dict[str, List[Any]] = {}
    seen: List[str] = []
    for item in items:
        k = key_fn(item)
        if k not in groups:
            groups[k] = []
            seen.append(k)
        groups[k].append(item)
    batches: List[Batch] = []
    for k in seen:
        group = groups[k]
        for start in range(0, len(group), max_batch):
            batches.append(Batch(key=k, items=group[start:start + max_batch]))
    if order == "oldest":
        batches.sort(key=lambda b: min(arrivals[id(i)] for i in b.items))
    return batches


def stack_items(arg_trees: Sequence[Any]) -> List[Any]:
    """The members' argument trees for one scan dispatch, checked to share
    one structure (the compat key guarantees it)."""
    trees = list(arg_trees)
    if not trees:
        raise ValueError("cannot stack an empty batch")
    if len({compat_key(t) for t in trees}) != 1:
        raise ValueError("cannot stack argument trees of different structures")
    return trees


def unstack_outputs(outputs: Tuple[torch.Tensor, ...], n: int) -> List[Tuple[torch.Tensor, ...]]:
    """Split a batched output tuple (each leaf with a leading batch axis)
    back into ``n`` per-request tuples."""
    return [tuple(leaf[i] for leaf in outputs) for i in range(n)]
