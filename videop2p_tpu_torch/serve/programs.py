"""ProgramSet: build the edit programs of one spec ONCE and keep them warm
(port of ``videop2p_tpu/serve/programs.py``).

A :class:`ProgramSet` holds what the one-shot CLI rebuilds per invocation —
the models, the scheduler, the capture budget — behind one object keyed by
a :class:`ProgramSpec` (checkpoint identity, geometry, step count), so every
request after the first reuses it.

A "program" here is a Python callable over the port's pipeline functions,
kept in the set's bounded cache under the JAX package's labels
(``vae_encode``, ``vae_decode``, ``sample_decode``, ``serve_invert``,
``serve_edit[_s{n}][_r..][_stu]``; a
scan batch calls its members' ``serve_edit`` program in turn, so the JAX
package's ``serve_edit_b{n}_scan`` has no counterpart) and wrapped by :func:`~videop2p_tpu_torch.obs.ledger.instrumented_program`, so the run
ledger sees each call, each miss (a program built into the cache) and, with
execute timing on, each call's latency after ``torch.cuda.synchronize``.
The controller (:class:`~videop2p_tpu_torch.control.controllers.
ControlContext`) and the capture (:class:`~videop2p_tpu_torch.pipelines.
cached.CachedSource`) are arguments of the programs, never baked into them,
so two requests with the same controller structure but other prompts,
equalizers or clips run the same program.

On a card (``utils/cuda_graphs.py:graphs_default``: one card, a served
mesh's every rank, each data-mesh replica) the programs' step loops (the
capture walk, the cached edit, the live loop of :meth:`ProgramSet.sample`)
run on kept runners (``utils/cuda_graphs.py:KeptRunner``): CUDA graphs
that stay warm across requests, as JAX's compiled programs do; on a served
mesh their NCCL collectives are captured with them, and every rank's
runners capture the same variants at the same steps of the same calls. The set keeps them in a
bounded :class:`~videop2p_tpu_torch.utils.cuda_graphs.RunnerCache` keyed
by the program's statics (its cache key) and the argument tree's
``serve/batching.py:compat_key``, the JAX jit cache's key; each request's
tensors are copied into the runner's buffers before its steps replay.
:meth:`ProgramSet.warm` runs the request path's step loops twice there,
so that every step variant of it is captured before the first request.

The UNet is built with ``frame_attention="auto"``: on the card every
forward of the inversion and the edit runs the fused frame-attention kernel
at its N ≥ 1024 sites and the GroupNorm kernel at all 61. Every program
runs under ``torch.no_grad`` whatever thread calls it (grad mode is
thread-local), on the set's device.

A spec whose ``mesh`` shards the model (sp or tp > 1) builds the set over
the process mesh of a ``torchrun`` launch, one set per rank (JAX's
model-parallel branch): the UNet is built "auto" as on one GPU (at sp > 1
the mesh's sharded frame attention takes its place and resolves "auto"
too; at sp = 1 the fused kernel runs on the local heads), the programs
take and keep each rank's frames (``encode`` keeps this rank's
latents; the decodes gather the clip first, and ``src_err`` is the whole
clip's). JAX's refusals hold: no ``quant_mode`` and no student on such a
mesh. JAX serves such a set from one controller; here rank 0 drives the
others: a set built under a process group (``needs_leader``) is served
through :meth:`ProgramSet.leader`, which the engine makes on rank 0 and
closes with itself, every call of which runs on every rank in the same
order (``parallel/distributed.py:ControlChannel``), the objects it returns
staying on their ranks (rank 0 holds its own and a key to the others');
the other ranks run :meth:`ProgramSet.follow` until rank 0 closes.

A data mesh (dp > 1, sp = tp = 1) is one process, as JAX's: the set keeps
a replica of the models on each of the first dp devices (``cuda:0`` ..
``cuda:dp-1``; on the CPU, dp CPU replicas), copied from replica 0, and
``edit_decode_batch(dispatch="vmap")`` splits a batch over them as JAX's
``_shard_batch`` does.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import threading
import time
import weakref
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from videop2p_tpu_torch.obs.ledger import instrumented_program

__all__ = ["ProgramSpec", "ProgramSet", "ProgramCache", "LeaderProgramSet", "MASK_TH"]

# the Stage-2 working-point constant (cli/run_videop2p.py uses the same)
MASK_TH = (0.3, 0.3)

# bounded per-set program cache: (name, statics) -> instrumented callable
_PROGRAMS_MAX = 32
# bounded per-set kept runners (each holds its buffers and graphs; one pool)
_RUNNERS_MAX = 8
_GRAPH_MODES = ("kept", "per_call", "off")

_DTYPES = {"fp16": torch.bfloat16, "bf16": torch.bfloat16,
           "fp32": torch.float32, "no": torch.float32}


@dataclass(frozen=True)
class ProgramSpec:
    """Everything that determines a program set's identity (the JAX
    package's fields).

    The engine and the store key on :meth:`fingerprint`, which uses the
    checkpoint's CONTENT identity: re-tuning a checkpoint in place gives a
    new fingerprint, never a warm program over stale weights. ``mesh``,
    ``ring_variant`` and ``tp_collectives`` are the multi-GPU knobs (the
    module docstring)."""

    checkpoint: Optional[str] = None
    width: int = 512
    video_len: int = 8
    steps: int = 50
    guidance_scale: float = 7.5
    tiny: bool = False
    mixed_precision: str = "fp32"
    seed: int = 0
    mesh: Optional[str] = None
    ring_variant: str = "overlap"
    tp_collectives: str = "gspmd"
    # serving is the cached fast path: no null-text backward, so no remat
    gradient_checkpointing: bool = False
    # quant_mode quantizes the UNet weights when the set is built (it cannot
    # vary per request); reuse_schedule is the default cross-step
    # deep-feature reuse (per-request values are admitted against the
    # warmed list). Both are in the fingerprint: their outputs differ
    quant_mode: str = "off"
    reuse_schedule: str = "off"
    # consistency-distilled few-step student (train/distill.py): in the
    # fingerprint by content; the inversion is always the teacher's
    student_ckpt: Optional[str] = None

    def resolved(self) -> "ProgramSpec":
        """The tiny-width rule the CLI applies: the tiny VAE downsamples
        2×, not 8× — keep latents at the tiny UNet's 8×8 working point."""
        if self.tiny and self.width == 512:
            return replace(self, width=16)
        return self

    def fingerprint(self) -> str:
        """Content-addressed identity: ``utils/inv_cache.py``'s key over
        every field (the checkpoint and student by content) and
        ``impl="torch"``, so the port's keys never collide with the JAX
        package's."""
        from videop2p_tpu_torch.utils.inv_cache import content_fingerprint, inversion_cache_key

        spec = self.resolved()
        return inversion_cache_key(
            kind="program_spec", impl="torch",
            checkpoint=(content_fingerprint(spec.checkpoint)
                        if spec.checkpoint else "<random-init>"),
            student_ckpt=(content_fingerprint(spec.student_ckpt)
                          if spec.student_ckpt else "<none>"),
            **{k: getattr(spec, k) for k in (
                "width", "video_len", "steps", "guidance_scale", "tiny",
                "mixed_precision", "seed", "mesh", "ring_variant",
                "tp_collectives", "gradient_checkpointing",
                "quant_mode", "reuse_schedule",
            )},
        )


def _to_device(tree: Any, device) -> Any:
    """A copy of an argument tree (tensors, dataclasses, dicts, lists,
    tuples) with every tensor on ``device``; modules are deep-copied there."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, torch.nn.Module):
        return copy.deepcopy(tree).to(device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return replace(tree, **{f.name: _to_device(getattr(tree, f.name), device)
                                for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree


def _runner_cache(device, served_mesh: bool = False):
    """A set's kept runners; on a served mesh each capture's outcome is
    agreed by every rank before its graph replays (a capture that failed
    on one rank fails the call on all of them)."""
    from videop2p_tpu_torch.parallel.distributed import agree_on_capture
    from videop2p_tpu_torch.utils.cuda_graphs import RunnerCache

    return RunnerCache(device, max_runners=_RUNNERS_MAX,
                       agree=agree_on_capture if served_mesh else None)


class ProgramSet:
    """Warm, instrumented programs for one :class:`ProgramSpec` on one
    device (CUDA unless a CPU device is given), on each rank of a
    model-parallel mesh, or over the replicas of a data mesh (the module
    docstring). ``bundle`` replaces the models ``build_models`` would make
    (its modules on ``device``). ``graphs``: "kept" (the default) runs the
    step loops on kept runners where :meth:`keeps_graphs` allows, "per_call"
    on the loops' own runners of one call (graphs captured anew every
    request), "off" eagerly."""

    def __init__(self, spec: ProgramSpec, *, bundle: Any = None, device="cuda",
                 graphs: str = "kept"):
        from videop2p_tpu_torch.cli.common import build_models, parse_mesh, setup_mesh
        from videop2p_tpu_torch.models.convert import quantize_unet_params
        from videop2p_tpu_torch.models.quant import validate_quant_mode
        from videop2p_tpu_torch.pipelines.reuse import validate_reuse_schedule
        from videop2p_tpu_torch.pipelines.sampling import make_unet_fn

        self.spec = spec = spec.resolved()
        if graphs not in _GRAPH_MODES:
            raise ValueError(f"graphs must be one of {_GRAPH_MODES}, got {graphs!r}")
        self.graphs = graphs
        quant_mode = validate_quant_mode(spec.quant_mode)
        dp, sp, tp = parse_mesh(spec.mesh)
        model_parallel = sp > 1 or tp > 1
        if quant_mode != "off" and model_parallel:
            raise ValueError(
                f"quant_mode={quant_mode!r} is not supported on a model-parallel mesh: "
                "the quantized weights would need their own sharding rules; serve "
                "quantized sets on one GPU")
        if spec.student_ckpt and model_parallel:
            raise ValueError(
                "student_ckpt is not supported on a model-parallel mesh: the mesh "
                "shards the teacher's UNet only; serve student sets on one GPU")
        validate_reuse_schedule(spec.reuse_schedule, spec.steps)
        if spec.mixed_precision not in _DTYPES:
            raise ValueError(f"mixed_precision must be one of {sorted(_DTYPES)}")
        self.dtype = _DTYPES[spec.mixed_precision]
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is available; "
                               "pass device='cpu' (--device cpu) to serve on the CPU")
        if dp > 1 and not model_parallel:
            # a data mesh: the first dp devices of this process
            have = torch.cuda.device_count() if self.device.type == "cuda" else dp
            if dp > have:
                raise ValueError(
                    f"mesh {spec.mesh!r}: a data mesh of dp={dp} replicas needs {dp} "
                    f"devices, this process sees {have}")
            if self.device.type == "cuda":
                self.device = torch.device("cuda", 0)
        if model_parallel:
            from videop2p_tpu_torch.parallel.distributed import initialize_distributed

            initialize_distributed(self.device.type)
            if self.device.type == "cuda":
                self.device = torch.device("cuda", torch.cuda.current_device())
        # full float32 products and convolutions, as the CLI runs them
        # (cuDNN's default for float32 convolutions is TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if bundle is None:
            bundle = build_models(spec.checkpoint, tiny=spec.tiny, dtype=self.dtype,
                                  device=self.device, seed=spec.seed, frame_attention="auto",
                                  gradient_checkpointing=spec.gradient_checkpointing)
        self.bundle = bundle
        # built on the ranks of a process group (a torchrun launch, whatever
        # its mesh): an engine serves it through leader() on rank 0
        self.needs_leader = torch.distributed.is_available() and torch.distributed.is_initialized()
        self.mesh = None
        if model_parallel:
            self.mesh = setup_mesh(bundle, spec.mesh, spec.video_len, spec.ring_variant,
                                   spec.tp_collectives, device=self.device)
        self.student_unet = None
        self.student_head = None
        if spec.student_ckpt:
            # the student is the teacher's frozen majority plus the
            # distilled subset and its time head, restored against the
            # full-precision teacher; quantization (below) then applies to
            # both UNets alike
            from videop2p_tpu_torch.train.distill import load_student

            params, self.student_head = load_student(spec.student_ckpt, bundle.unet,
                                                     bundle.unet.config)
            self.student_unet = copy.deepcopy(bundle.unet)
            self.student_unet.load_state_dict(params)
        if quant_mode != "off":
            quantize_unet_params(bundle.unet, quant_mode)
            if self.student_unet is not None:
                quantize_unet_params(self.student_unet, quant_mode)
        self.unet_fn = make_unet_fn(bundle.unet)
        self.student_fn = (make_unet_fn(self.student_unet)
                           if self.student_unet is not None else None)
        self.scheduler = bundle.make_scheduler()
        self._programs: Dict[Tuple, Callable] = {}
        self._lock = threading.Lock()
        self._misses = 0
        self._runners = _runner_cache(self.device, served_mesh=self.needs_leader)
        # a served mesh's rank-synchronous calls: seconds per program
        self.call_seconds: Dict[str, float] = {}
        self.warmed: Optional[Dict[str, Any]] = None
        # the data mesh's replicas, this set first (one entry without one)
        self.replicas: List["ProgramSet"] = [self]
        if dp > 1 and not model_parallel:
            for r in range(1, dp):
                dev = torch.device("cuda", r) if self.device.type == "cuda" else self.device
                self.replicas.append(self._replica(dev))

    def _replica(self, device: torch.device) -> "ProgramSet":
        """A copy of this set's models and student on ``device``, with an
        empty program cache (a data mesh's replica)."""
        from videop2p_tpu_torch.pipelines.sampling import make_unet_fn

        rep = copy.copy(self)
        rep.device = device
        rep.bundle = replace(self.bundle, **{name: _to_device(getattr(self.bundle, name), device)
                                             for name in ("unet", "vae", "text_encoder")})
        rep.unet_fn = make_unet_fn(rep.bundle.unet)
        rep.student_unet = (_to_device(self.student_unet, device)
                            if self.student_unet is not None else None)
        rep.student_head = _to_device(self.student_head, device)
        rep.student_fn = make_unet_fn(rep.student_unet) if rep.student_unet is not None else None
        rep.scheduler = rep.bundle.make_scheduler()
        rep._programs, rep._lock, rep._misses = {}, threading.Lock(), 0
        rep._runners = _runner_cache(device)
        rep.replicas = [rep]
        return rep

    # ---- program cache ---------------------------------------------------

    @property
    def cache_misses(self) -> int:
        """Programs built into the caches (a miss), every replica's; the
        engine, chip_smoke and the tests read it to show that a warm set
        serves without building anything."""
        return sum(r._misses for r in self.replicas)

    def sync(self) -> None:
        """Wait for the card(s) (nothing on the CPU)."""
        for r in self.replicas:
            if r.device.type == "cuda":
                torch.cuda.synchronize(r.device)

    def _program(self, key: Tuple, label: str, fn: Callable) -> Callable:
        with self._lock:
            prog = self._programs.get(key)
            if prog is None:
                self._misses += 1
                while len(self._programs) >= _PROGRAMS_MAX:
                    self._programs.pop(next(iter(self._programs)))

                def no_grad_fn(*args, **kwargs):
                    with torch.no_grad():
                        return fn(*args, **kwargs)

                prog = self._programs[key] = instrumented_program(
                    no_grad_fn, program=label, sync=self._sync_own)
        return prog

    def _sync_own(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def keeps_graphs(self) -> bool:
        """Whether the programs' step loops run on kept runners: ``graphs``
        "kept" and CUDA graphs by default on the set's device
        (``utils/cuda_graphs.py:graphs_default``: a card, on one card or on
        a mesh of NCCL groups). On a served mesh every rank's set keeps
        them: rank 0's calls and its followers' run in the same order, so
        every rank's cache lends, captures and replays alike."""
        from videop2p_tpu_torch.utils.cuda_graphs import graphs_default

        return self.graphs == "kept" and graphs_default(self.device)

    @contextlib.contextmanager
    def _runner(self, statics: Tuple, args: Any, name: str):
        """The runner of one call of the program of ``statics`` on
        ``args``: a kept runner lent for the call (keyed by the statics and
        the tree's compat key); else None (the loop's own default) or, with
        ``graphs`` "off", False (the eager loop)."""
        if not self.keeps_graphs():
            yield False if self.graphs == "off" else None
            return
        from videop2p_tpu_torch.serve.batching import compat_key

        with self._runners.checkout((statics, compat_key(args)), name) as runner:
            yield runner

    def runner_stats(self) -> Dict[str, Any]:
        """The kept runners of every replica: how many, the runners made so
        far, their calls, graphs captured, eager steps, replays, bytes
        copied in and their pools' bytes, summed."""
        out: Dict[str, Any] = {}
        for r in self.replicas:
            for k, v in r._runners.totals().items():
                out[k] = out.get(k, 0) + v
        return out

    # ---- host-side helpers ----------------------------------------------

    def encode_prompts(self, prompts: Sequence[str]) -> torch.Tensor:
        from videop2p_tpu_torch.cli.common import encode_prompts

        with torch.no_grad():
            return encode_prompts(self.bundle, list(prompts), self.device)

    def controller(self, prompts: Sequence[str], *, is_word_swap: bool = False,
                   cross_replace_steps: float = 0.2, self_replace_steps: float = 0.5,
                   blend_word: Optional[Sequence[str]] = None,
                   eq_params: Optional[Dict] = None,
                   mask_th: Tuple[float, float] = MASK_TH,
                   steps: Optional[int] = None):
        """The CLI's controller, bound to the spec's step count; ``steps``
        overrides it for a timestep-subset (few-step) edit, whose gates live
        in subset-step space."""
        from videop2p_tpu_torch.control.controllers import make_controller

        blend_words = ((blend_word[0],), (blend_word[1],)) if blend_word else None
        return make_controller(
            list(prompts), self.bundle.tokenizer,
            int(steps) if steps else self.spec.steps,
            is_replace_controller=bool(is_word_swap),
            cross_replace_steps=cross_replace_steps,
            self_replace_steps=self_replace_steps, blend_words=blend_words,
            equalizer_params=dict(eq_params) if eq_params else None,
            mask_th=mask_th, device=self.device)

    def encode_uncond(self) -> torch.Tensor:
        """The empty prompt's (L, D) embedding (the unconditional stream)."""
        return self.encode_prompts([""])[0]

    def frames_to_video(self, frames: np.ndarray) -> torch.Tensor:
        """(F, H, W, 3) uint8 frames → the (1, F, H, W, 3) [-1, 1] float32
        tensor the encode program takes."""
        return torch.as_tensor(np.asarray(frames), dtype=torch.float32,
                               device=self.device)[None] / 127.5 - 1.0

    def latents_from_host(self, latents: np.ndarray) -> torch.Tensor:
        """Host latents of the whole clip (a persisted trajectory's entry)
        → this set's device; on a mesh, this rank's frames."""
        from videop2p_tpu_torch.parallel.mesh import frames_slice

        return frames_slice(torch.as_tensor(np.asarray(latents), device=self.device),
                            self.mesh).contiguous()

    def trajectory_to_host(self, trajectory: torch.Tensor) -> np.ndarray:
        """A capture-inversion's trajectory as the one-GPU host array (on a
        mesh gathered over the frames first: the store's disk entry is the
        one-GPU entry)."""
        from videop2p_tpu_torch.parallel.mesh import gather_frames

        return gather_frames(trajectory, self.mesh, dim=2).cpu().numpy()

    # ---- programs --------------------------------------------------------

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        """VAE encode at the posterior mean (inversion fidelity; no random
        draw) — the ``vae_encode`` program; on a mesh, of this rank's
        frames of the whole ``video``."""
        from videop2p_tpu_torch.models.vae import encode_video
        from videop2p_tpu_torch.parallel.mesh import frames_slice

        prog = self._program(("vae_encode",), "vae_encode",
                             lambda vid: encode_video(self.bundle.vae,
                                                      frames_slice(vid, self.mesh)).float())
        return prog(video)

    def _decode01(self, latents: torch.Tensor) -> torch.Tensor:
        """The [0, 1] video of the whole clip (on a mesh every rank gathers
        the frames first)."""
        from videop2p_tpu_torch.models.vae import decode_video
        from videop2p_tpu_torch.parallel.mesh import gather_frames

        return (decode_video(self.bundle.vae, gather_frames(latents, self.mesh)).float()
                + 1.0) / 2.0

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents → the [0, 1] video — the ``vae_decode`` program."""
        prog = self._program(("vae_decode",), "vae_decode", self._decode01)
        return prog(latents)

    def sample(self, x_t: torch.Tensor, cond: torch.Tensor, uncond: torch.Tensor, *,
               steps: Optional[int] = None,
               guidance_scale: Optional[float] = None) -> torch.Tensor:
        """Uncontrolled CFG sampling from ``x_t`` then the VAE decode, as one
        program keyed on ``(steps, guidance)`` (the UI's inference tab) —
        label ``sample_decode``. Returns the [0, 1] videos; equal bit for bit
        to :meth:`decode` of the ``edit_sample`` latents (the same calls in
        the same order)."""
        from videop2p_tpu_torch.pipelines.sampling import edit_sample

        steps = int(steps or self.spec.steps)
        guidance = float(self.spec.guidance_scale if guidance_scale is None
                         else guidance_scale)

        statics = ("sample_decode", steps, guidance)

        def fn(x, cond, uncond):
            with self._runner(statics, (x, cond, uncond), "live_edit") as runner:
                out = edit_sample(self.unet_fn, self.scheduler, x, cond, uncond,
                                  num_inference_steps=steps, guidance_scale=guidance,
                                  cuda_graphs=runner)
            return self._decode01(out)

        prog = self._program(statics, "sample_decode", fn)
        return prog(x_t, cond, uncond)

    def capture_plan(self, ctx, latents: torch.Tensor, cond_src: torch.Tensor):
        """The CLI's cached-mode capture decision for this spec: the gate
        windows of the controller and the escalating maps budget (bf16 →
        1-byte temporal maps). Returns ``(cross_len, self_window,
        temporal_maps_dtype)``; raises when even 1-byte maps exceed the
        budget (the engine has no live-source fallback)."""
        from videop2p_tpu_torch.pipelines.cached import capture_windows
        from videop2p_tpu_torch.pipelines.fast import (
            CACHED_MAPS_BUDGET_GB,
            capture_bytes,
            choose_cached_maps,
        )

        cross_len, self_window = capture_windows(ctx, self.spec.steps)
        budget_gb = float(os.environ.get("VIDEOP2P_CACHED_MAPS_BUDGET_GB",
                                         CACHED_MAPS_BUDGET_GB))
        fits, tm_dtype, map_gb = choose_cached_maps(
            lambda dt: capture_bytes(self.bundle.unet,
                                     (latents.shape[0], self.spec.video_len, *latents.shape[2:]),
                                     cond_src.shape[-2], cross_len=cross_len,
                                     self_window=self_window, temporal_maps_dtype=dt),
            sp=1 if self.mesh is None else self.mesh.shape["frames"], budget_gb=budget_gb)
        if not fits:
            raise RuntimeError(
                f"cached-source capture needs {map_gb:.1f} GiB even with 1-byte "
                f"temporal maps (budget {budget_gb:.1f} GiB) — shrink the geometry "
                "or raise VIDEOP2P_CACHED_MAPS_BUDGET_GB")
        return cross_len, self_window, tm_dtype

    def invert_capture(self, latents: torch.Tensor, cond_src: torch.Tensor, ctx):
        """Capture-inversion of the source clip: ``(trajectory,
        CachedSource)``, the store-able products. One program per (windows,
        blend, storage dtype); the controller's tensors never enter it, so
        every clip with the same capture plan runs it. The inversion is
        always the teacher's."""
        statics, loop = self._invert_loop(latents, cond_src, ctx)
        return self._program(statics, "serve_invert", loop)(latents, cond_src)

    def _invert_loop(self, latents: torch.Tensor, cond_src: torch.Tensor, ctx):
        """``(statics, loop)``: the capture inversion of this request's
        capture plan, ``loop(x, c)`` on the set's runner of those statics."""
        from videop2p_tpu_torch.pipelines.inversion import ddim_inversion_captured

        cross_len, self_window, tm_dtype = self.capture_plan(ctx, latents, cond_src)
        capture_blend = ctx is not None and ctx.blend is not None
        statics = ("serve_invert", cross_len, self_window, capture_blend,
                   None if tm_dtype is None else str(tm_dtype))

        def loop(x, c):
            with self._runner(statics, (x, c), "capture_inversion") as runner:
                return ddim_inversion_captured(
                    self.unet_fn, self.scheduler, x, c, num_inference_steps=self.spec.steps,
                    cross_len=cross_len, self_window=self_window, capture_blend=capture_blend,
                    temporal_maps_dtype=tm_dtype, cuda_graphs=runner)

        return statics, loop

    def step_plan(self, steps: Optional[int] = None):
        """``(steps, positions)`` of a per-request step count: positions
        None at the spec's base count, else the exact timestep-subset
        positions (the few-step edit runs from the SAME base-steps
        inversion)."""
        steps = int(steps) if steps else self.spec.steps
        if steps == self.spec.steps:
            return steps, None
        if not 1 <= steps <= self.spec.steps:
            raise ValueError(
                f"steps={steps} outside [1, {self.spec.steps}] (the spec's base step "
                "count — inversions are captured at the base grid)")
        return steps, tuple(int(p) for p in self.scheduler.subset_positions(
            self.spec.steps, steps))

    def _edit_fn(self, steps: Optional[int] = None,
                 positions: Optional[Tuple[int, ...]] = None,
                 reuse: Optional[str] = None, student: bool = False):
        """One request's edit + decode, shared verbatim by the singleton
        program and every batched variant: what makes a scan batch
        bit-identical to its singletons. ``student`` runs the edit with the
        distilled UNet and its time head over the same capture replay, so
        ``src_err`` keeps its 0.0 contract."""
        loop = self._edit_loop(steps, positions, reuse, student)

        def fn(cached, cond_all, uncond, ctx, anchor):
            out = loop(cached, cond_all, uncond, ctx)
            # stream 0 must be the exact inversion reconstruction: compare
            # it with the ANCHOR stored with the products (the encoded
            # source latents) — 0.0 exactly when the replay is intact (on a
            # mesh each rank's frames against its own anchor, then the
            # whole clip's maximum)
            src_err = (out[:1] - anchor).abs().max().float()
            if self.mesh is not None:
                from videop2p_tpu_torch.parallel.mesh import gather_frames

                src_err = gather_frames(src_err.reshape(1), self.mesh, dim=0).max()
            videos01 = self._decode01(out)
            return videos01, src_err

        return fn

    def _edit_loop(self, steps: Optional[int] = None,
                   positions: Optional[Tuple[int, ...]] = None,
                   reuse: Optional[str] = None, student: bool = False):
        """The edit program's loop: ``loop(cached, cond_all, uncond, ctx)``
        → the edited latents, on the set's runner of its statics."""
        from videop2p_tpu_torch.pipelines.sampling import edit_sample

        guidance = self.spec.guidance_scale
        steps = int(steps) if steps else self.spec.steps
        head = self.student_head if student else None
        if student and head is None:
            raise ValueError("student edit requested but the spec has no student_ckpt — "
                             "build the ProgramSet with ProgramSpec.student_ckpt set")
        unet_fn = self.student_fn if student else self.unet_fn
        statics = self._edit_statics(steps, reuse, student)

        def loop(cached, cond_all, uncond, ctx):
            with self._runner(statics, (cached, cond_all, uncond, ctx), "cached_edit") as runner:
                return edit_sample(unet_fn, self.scheduler, cached.src_latents[0], cond_all,
                                   uncond, num_inference_steps=steps, guidance_scale=guidance,
                                   ctx=ctx, source_uses_cfg=False, cached_source=cached,
                                   step_positions=positions, reuse_schedule=reuse,
                                   student_head=head, cuda_graphs=runner)

        return loop

    def _edit_statics(self, steps: int, reuse: Optional[str], student: bool) -> Tuple:
        return ("serve_edit", steps, self.spec.guidance_scale, reuse, student)

    def _resolve_reuse(self, reuse: Optional[str], steps: int) -> str:
        """Per-call reuse schedule: None defers to the spec's default;
        validated against THIS call's step count."""
        from videop2p_tpu_torch.pipelines.reuse import validate_reuse_schedule

        return validate_reuse_schedule(self.spec.reuse_schedule if reuse is None else reuse,
                                       steps)

    def _suffix(self, steps: int, reuse: str, student: bool) -> str:
        from videop2p_tpu_torch.pipelines.reuse import reuse_label

        suffix = "" if steps == self.spec.steps else f"_s{steps}"
        rl = reuse_label(reuse)
        if rl:
            suffix += f"_r{rl}"
        return suffix + ("_stu" if student else "")

    def edit_decode(self, cached, cond_all, uncond, ctx, anchor, *,
                    steps: Optional[int] = None, reuse: Optional[str] = None,
                    student: bool = False):
        """One request: the cached-source controlled edit + VAE decode as
        one dispatch. Returns ``(videos01 (P, F, H, W, 3), src_err)``.
        ``steps`` below the spec's runs the timestep-subset path from the
        same products (the controller must be built for that step count);
        ``reuse`` a deep-feature reuse schedule (None: the spec's);
        ``student`` the distilled student."""
        steps, positions = self.step_plan(steps)
        reuse = self._resolve_reuse(reuse, steps)
        if positions is not None and ctx is not None:
            from videop2p_tpu_torch.pipelines.cached import check_subset_windows

            check_subset_windows(ctx, cached, positions, steps)
        prog = self._program(
            self._edit_statics(steps, reuse, student),
            "serve_edit" + self._suffix(steps, reuse, student),
            self._edit_fn(steps, positions, reuse, student))
        return prog(cached, cond_all, uncond, ctx, anchor)

    def edit_decode_batch(self, members, *, dispatch: str = "scan",
                          steps: Optional[int] = None, reuse: Optional[str] = None,
                          student: bool = False):
        """Compatible requests (``serve/batching.py:stack_items``) → one
        dispatch. Returns the videos and src_err stacked on a leading batch
        axis, on this set's device.

        ``"scan"``: each member runs through the singleton's program in
        turn, so each result is bit-identical to its singleton's and a
        batch needs no program of its own to warm. ``"vmap"`` (JAX's
        data-mesh dispatch): the members split over the data mesh's
        replicas as JAX's ``_shard_batch`` splits the batch axis —
        contiguous chunks when dp divides the batch, else every member on
        replica 0 — and the chunks run at once, one thread per replica
        (under its device), each member through that replica's singleton
        program: each result is its singleton's bits on the same device.
        Without a data mesh "vmap" is "scan"."""
        if dispatch not in ("scan", "vmap"):
            raise ValueError(f"dispatch must be 'scan' or 'vmap', got {dispatch!r}")
        members = list(members)
        kw = dict(steps=steps, reuse=reuse, student=student)
        chunks = self._shard_members(len(members)) if dispatch == "vmap" else [
            list(range(len(members)))]
        outs: List[Any] = [None] * len(members)
        errors: List[BaseException] = []

        def run(replica: "ProgramSet", idx: List[int]) -> None:
            import contextlib

            try:
                with (torch.cuda.device(replica.device) if replica.device.type == "cuda"
                      else contextlib.nullcontext()):
                    for i in idx:
                        args = (members[i] if replica is self
                                else _to_device(members[i], replica.device))
                        videos, err = replica.edit_decode(*args, **kw)
                        outs[i] = (videos.to(self.device), err.to(self.device))
            except BaseException as e:  # noqa: BLE001 — raised after the join
                errors.append(e)

        threads = [threading.Thread(target=run, args=(self.replicas[r], idx),
                                    name=f"vmap-replica{r}", daemon=True)
                   for r, idx in enumerate(chunks) if idx and r > 0]
        for t in threads:
            t.start()
        run(self, chunks[0])
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])

    def _shard_members(self, n: int) -> List[List[int]]:
        """Member indices per replica: ``n / dp`` contiguous members each
        when dp divides ``n``, else all of them on replica 0 (JAX's
        ``_shard_batch`` replicates such a batch)."""
        dp = len(self.replicas)
        if dp == 1 or n % dp:
            return [list(range(n))] + [[] for _ in range(dp - 1)]
        per = n // dp
        return [list(range(r * per, (r + 1) * per)) for r in range(dp)]

    # ---- warmup ----------------------------------------------------------

    def warm(self, prompts: Sequence[str] = ("a video", "an edited video"), *,
             controller_kwargs: Optional[Dict] = None, step_buckets: Sequence[int] = (),
             reuse_schedules: Sequence[str] = (),
             student_steps: Sequence[int] = ()) -> Dict[str, Any]:
        """Run every request-path program once, on zeros: encode →
        invert-capture → edit + decode, plus the few-step
        (``step_buckets``), reuse and student variants asked for; the
        kernels build on the first call. Where the set keeps runners
        (:meth:`keeps_graphs`) their step loops run a second time (without
        the decode): a step variant seen once in a call is captured at its
        second call, so a compatible request then captures nothing and runs
        no step eagerly. Returns the summary ``/healthz`` reports
        (``steps``, ``reuse`` and ``student`` are the warmed lists the
        engine admits per-request values against; ``quant`` the set's one
        quant mode; ``runners`` the kept runners' totals, where kept)."""
        t0 = time.perf_counter()
        spec = self.spec
        kw = dict(controller_kwargs or {})
        ctx = self.controller(prompts, **kw)
        frames = np.zeros((spec.video_len, spec.width, spec.width, 3), np.uint8)
        latents = self.encode(self.frames_to_video(frames))
        cond_src = self.encode_prompts(prompts[:1])
        cond_all = self.encode_prompts(prompts)
        uncond = self.encode_prompts([""])[0]
        if student_steps and self.student_head is None:
            raise ValueError("student_steps given but the spec has no student_ckpt — "
                             "nothing to warm the student buckets with")
        # the edits of the request path: (controller, edit_decode keywords)
        edits = [(ctx, {})]
        warmed_steps = {spec.steps}
        for s in map(int, step_buckets):
            if s not in warmed_steps:
                edits.append((self.controller(prompts, steps=s, **kw), {"steps": s}))
                warmed_steps.add(s)
        warmed_reuse = {self._resolve_reuse(None, spec.steps)}
        for r in reuse_schedules:
            r = self._resolve_reuse(str(r), spec.steps)
            if r not in warmed_reuse:
                edits.append((ctx, {"reuse": r}))
                warmed_reuse.add(r)
        warmed_student: set = set()
        for s in map(int, student_steps):
            if s not in warmed_student:
                ctx_s = self.controller(prompts, steps=s, **kw) if s != spec.steps else ctx
                edits.append((ctx_s, {"steps": s, "student": True}))
                warmed_student.add(s)
        _, cached = self.invert_capture(latents, cond_src, ctx)
        src_err = None
        for c, ekw in edits:
            _, err = self.edit_decode(cached, cond_all, uncond, c, latents, **ekw)
            src_err = err if src_err is None else src_err
        if self.keeps_graphs():
            # the step loops once more (no decode): a step variant seen once
            # above is captured now
            with torch.no_grad():
                _, cached = self._invert_loop(latents, cond_src, ctx)[1](latents, cond_src)
                for c, ekw in edits:
                    steps, positions = self.step_plan(ekw.get("steps"))
                    self._edit_loop(steps, positions, self._resolve_reuse(ekw.get("reuse"), steps),
                                    ekw.get("student", False))(cached, cond_all, uncond, c)
        self.sync()
        if self.device.type == "cuda":
            # the warm-up's activations (the decode's above all) go back to
            # the card: processes that share it serve from what they keep
            from videop2p_tpu_torch.utils.cuda_graphs import release_cached_memory

            release_cached_memory()
        self.warmed = {
            "seconds": round(time.perf_counter() - t0, 3),
            "prompts": list(prompts),
            "steps": sorted(warmed_steps),
            "reuse": sorted(warmed_reuse),
            "quant": spec.quant_mode,
            "student": sorted(warmed_student),
            "src_err": float(src_err),
        }
        if self.keeps_graphs():
            self.warmed["runners"] = self.runner_stats()
        if len(self.replicas) > 1:
            # the data mesh's other replicas build the same programs, at once
            self._warm_replicas(prompts, controller_kwargs=controller_kwargs,
                                step_buckets=step_buckets, reuse_schedules=reuse_schedules,
                                student_steps=student_steps)
            self.warmed["seconds"] = round(time.perf_counter() - t0, 3)
            self.warmed["replicas"] = len(self.replicas)
        return self.warmed

    def _warm_replicas(self, prompts, **kw) -> None:
        errors: List[BaseException] = []

        def run(replica: "ProgramSet") -> None:
            import contextlib

            try:
                with (torch.cuda.device(replica.device) if replica.device.type == "cuda"
                      else contextlib.nullcontext()):
                    replica.warm(prompts, **kw)
            except BaseException as e:  # noqa: BLE001 — raised after the join
                errors.append(e)

        threads = [threading.Thread(target=run, args=(r,), daemon=True)
                   for r in self.replicas[1:]]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    # ---- a model-parallel mesh served from rank 0 ------------------------

    def leader(self) -> "LeaderProgramSet":
        """Rank 0's view of a set built on every rank of a ``torchrun``
        world (the module docstring): the set the engine calls."""
        return LeaderProgramSet(self)

    def _prepare_call(self, objects: "_Objects", desc: Tuple) -> Callable[[], Any]:
        """One rank-synchronous call's host step on this rank: apply rank
        0's frees, resolve the arguments to this rank's objects; returns
        the call's device work, which keeps what it returns under the
        call's keys."""
        op, args, kwargs, base, frees = desc
        objects.free(frees)
        if op == _PING:
            return lambda: None
        if op not in _MIRRORED:
            raise ValueError(f"{op!r} is not a rank-synchronous program of the set")
        fn = getattr(self, op)
        args, kwargs = objects.resolve(args), objects.resolve(kwargs)

        def work():
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.sync()
            self.call_seconds[op] = self.call_seconds.get(op, 0.0) + time.perf_counter() - t0
            objects.register(base, out)
            return out

        return work

    def host_phases(self) -> List[Dict[str, Any]]:
        """This rank's ``host_phase`` records of the rank-synchronous calls
        it ran: each program's seconds in all, after its device work
        (``serve_<program>``); none outside a served mesh."""
        from videop2p_tpu_torch.parallel.distributed import host_phase_record

        return [host_phase_record(f"serve_{op}", s) for op, s in sorted(self.call_seconds.items())]

    def abandon(self, reason: str) -> None:
        """Nothing to mark in one process (a leader's channel breaks)."""

    def close(self) -> None:
        """Frees the kept runners' graphs, pools and buffers (every
        replica's; a later call keeps new ones). A leader releases its
        followers."""
        for r in self.replicas:
            r._runners.close()

    def follow(self) -> Dict[str, Any]:
        """Ranks > 0 of a served mesh: run rank 0's calls until it closes;
        returns the calls run, the objects still held at the end (rank 0
        sends how many it holds: the two agree when every free reached
        this rank) and, where the set keeps runners, their totals; then
        frees the runners, as rank 0 does when it closes."""
        from videop2p_tpu_torch.parallel.distributed import ControlChannel

        objects = _Objects(weak=False)
        stats: Dict[str, int] = {}

        def on_stop(desc) -> None:
            _, frees, leader_live = desc
            objects.free(frees)
            stats.update(live=len(objects.table), leader_live=int(leader_live))

        try:
            stats["calls"] = ControlChannel().follow(
                lambda desc: self._prepare_call(objects, desc), on_stop)
            if self.keeps_graphs():
                stats["runners"] = self.runner_stats()
        finally:
            # rank 0 closed its set's runners with the channel: so does
            # this rank
            self.close()
        return stats


# the programs and host helpers rank 0 runs on every rank of a served mesh
_MIRRORED = frozenset((
    "controller", "encode_prompts", "encode_uncond", "frames_to_video", "latents_from_host",
    "trajectory_to_host", "encode", "decode", "sample", "invert_capture", "edit_decode",
    "edit_decode_batch", "warm", "host_phases"))
_PING = "__ping__"
# an idle leader pings its followers this often: a follower waits for the
# next call inside a collective, which times out after TIMEOUT
_HEARTBEAT_S = 60.0


@dataclass(frozen=True)
class _Ref:
    """An object of an earlier rank-synchronous call, by its key."""

    key: Tuple[int, int]


def _keyable(x: Any) -> bool:
    return isinstance(x, torch.Tensor) or (dataclasses.is_dataclass(x)
                                           and not isinstance(x, type))


class _Objects:
    """The objects rank-synchronous calls returned on this rank, by key:
    held by a follower until rank 0 frees them, weakly by rank 0 (its
    caller holds them)."""

    def __init__(self, weak: bool):
        self.table: Any = weakref.WeakValueDictionary() if weak else {}

    def resolve(self, tree: Any) -> Any:
        if isinstance(tree, _Ref):
            try:
                return self.table[tree.key]
            except KeyError:
                raise KeyError(f"object {tree.key} of an earlier call is not on this rank "
                               "(freed, or never made)") from None
        if isinstance(tree, dict):
            return {k: self.resolve(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.resolve(v) for v in tree)
        return tree

    def register(self, base: int, out: Any) -> None:
        for i, item in enumerate(out if isinstance(out, tuple) else (out,)):
            if _keyable(item):
                self.keep((base, i), item)

    def keep(self, key: Tuple[int, int], item: Any) -> None:
        self.table[key] = item

    def free(self, keys) -> None:
        for k in keys:
            self.table.pop(tuple(k), None)


class _LeaderObjects(_Objects):
    """Rank 0's table: besides the weak one, each object's key by identity,
    and the keys of the objects its caller dropped, to free on every rank
    with the next call."""

    def __init__(self):
        super().__init__(weak=True)
        self.keys: Dict[int, Tuple[int, int]] = {}
        self._dropped: List[Tuple[int, int]] = []
        self._lock = threading.Lock()

    def keep(self, key, item) -> None:
        super().keep(key, item)
        with self._lock:
            self.keys[id(item)] = key
        weakref.finalize(item, self._drop, id(item), key)

    def _drop(self, ident: int, key) -> None:
        with self._lock:
            if self.keys.get(ident) == key:
                del self.keys[ident]
            self._dropped.append(key)

    def take_dropped(self) -> List[Tuple[int, int]]:
        with self._lock:
            out, self._dropped = self._dropped, []
        return out

    def refs(self, tree: Any) -> Any:
        """``tree`` with each object of an earlier call replaced by its key;
        any other tensor or dataclass cannot cross to the other ranks."""
        if _keyable(tree):
            with self._lock:
                key = self.keys.get(id(tree))
            if key is None or self.table.get(key) is not tree:
                raise TypeError(
                    f"a {type(tree).__name__} argument that no rank-synchronous call of "
                    "the set made: on a mesh every tensor a program takes comes from the "
                    "set's own calls (e.g. latents_from_host for host latents)")
            return _Ref(key)
        if isinstance(tree, dict):
            return {k: self.refs(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.refs(v) for v in tree)
        return tree


class LeaderProgramSet:
    """Rank 0's :class:`ProgramSet` on a served mesh: each program and host
    helper the engine calls (:data:`_MIRRORED`) runs on every rank through
    the host control channel, one call at a time in issue order (behind
    one lock); everything else is rank 0's set's. What a call returns on
    rank 0 is what the one-GPU set returns (the decodes gather the clip);
    the other ranks keep their own under the call's keys until rank 0's
    objects are dropped. A failure in a call's host step (no rank entered
    a collective) leaves the ranks in step. Anything else breaks the
    channel: a failure in any rank's device work (a rank may have left
    the others' collectives unmatched; a failed CUDA graph capture fails
    the call on every rank before any rank replays the graph:
    ``parallel/distributed.py:agree_on_capture``), a failed exchange (a timeout, a
    dead peer), a call abandoned mid-way (the engine's watchdog). Every
    later call then raises at once, and :meth:`close` stops the followers
    once no call runs."""

    # the engine serves this set as it is
    needs_leader = False

    def __init__(self, programs: ProgramSet):
        from videop2p_tpu_torch.parallel.distributed import ControlChannel, process_index

        if process_index() != 0:
            raise RuntimeError(f"rank {process_index()} cannot lead the mesh: rank 0 "
                               "drives it, the other ranks run ProgramSet.follow()")
        self.local = programs
        self.channel = ControlChannel()
        self.objects = _LeaderObjects()
        self._call_lock = threading.Lock()
        self._next = 0
        self._broken: Optional[str] = None
        self._closed = False
        self._last = time.monotonic()
        self._beat = threading.Thread(target=self._heartbeat, name="mesh-heartbeat",
                                      daemon=True)
        self._beat.start()

    def __getattr__(self, name: str) -> Any:
        local = self.__dict__.get("local")
        if local is None:
            raise AttributeError(name)
        if name in _MIRRORED:
            return lambda *args, **kwargs: self.call(name, *args, **kwargs)
        return getattr(local, name)

    def live(self) -> int:
        """Objects of earlier calls rank 0 still holds (each rank holds its
        counterpart)."""
        return len(self.objects.table)

    def host_phases(self) -> List[Dict[str, Any]]:
        """Every rank's ``host_phase`` records of the calls so far (one
        more rank-synchronous call, whose values all reach rank 0)."""
        return [rec for recs in self.call("host_phases", gather=True) for rec in recs]

    def abandon(self, reason: str) -> None:
        """Mark the channel broken (a call was abandoned mid-way: the ranks'
        collectives can no longer be matched)."""
        self._broken = reason

    def call(self, op: str, *args, gather: bool = False, **kwargs) -> Any:
        """Run ``op`` of the set on every rank; rank 0's result (with
        ``gather``, every rank's in rank order)."""
        if self._closed:
            raise RuntimeError("the mesh's rank-synchronous channel is closed")
        if self._broken is not None:
            raise RuntimeError(f"the mesh's rank-synchronous channel is broken ({self._broken}); "
                               "restart the mesh")
        with self._call_lock:
            if self._broken is not None:
                raise RuntimeError(f"the mesh's rank-synchronous channel is broken "
                                   f"({self._broken}); restart the mesh")
            return self._lead(op, args, kwargs, gather)

    def _lead(self, op: str, args: Tuple, kwargs: Dict, gather: bool = False) -> Any:
        from videop2p_tpu_torch.parallel.distributed import RankCallError

        desc = (op, self.objects.refs(args), self.objects.refs(kwargs), self._next,
                self.objects.take_dropped())
        self._next += 1
        try:
            return self.channel.lead(desc, lambda d: self.local._prepare_call(self.objects, d),
                                     gather=gather)
        except RankCallError as e:
            if e.step != "prepare":
                self._broken = f"{op} failed in its device work: {e}"
            raise
        except BaseException as e:
            self._broken = f"{op}'s exchange failed: {type(e).__name__}: {e}"
            raise
        finally:
            self._last = time.monotonic()

    def _heartbeat(self) -> None:
        while not self._closed:
            time.sleep(_HEARTBEAT_S / 4)
            if (self._closed or self._broken is not None
                    or time.monotonic() - self._last < _HEARTBEAT_S):
                continue
            if self._call_lock.acquire(blocking=False):
                try:
                    if not self._closed:
                        self._lead(_PING, (), {})
                except Exception as e:  # noqa: BLE001 — the next call raises it
                    self._broken = f"heartbeat failed: {e}"
                finally:
                    self._call_lock.release()

    def close(self, timeout_s: float = 60.0) -> None:
        """Release the followers (with rank 0's last frees and how many
        objects it still holds). Raises when a call still runs after
        ``timeout_s`` (the followers then stop at their collective
        timeout)."""
        if self._closed:
            return
        if not self._call_lock.acquire(timeout=timeout_s):
            self._closed = True
            raise RuntimeError(
                f"a rank-synchronous call still runs after {timeout_s} s: the followers "
                "were not released and stop at their collective timeout")
        try:
            self._closed = True
            self.channel.stop(self.objects.take_dropped(), self.live())
        finally:
            self._call_lock.release()
            # every rank frees its kept runners' graphs and pools: the
            # followers when stop() releases them
            self.local.close()


class ProgramCache:
    """Bounded spec-keyed cache of :class:`ProgramSet` instances (one warm
    set per checkpoint / geometry / steps key) on one device."""

    def __init__(self, max_sets: int = 4, *, device="cuda"):
        self.max_sets = int(max_sets)
        self.device = device
        self._sets: Dict[str, ProgramSet] = {}

    def get(self, spec: ProgramSpec) -> ProgramSet:
        key = spec.fingerprint()
        ps = self._sets.get(key)
        if ps is None:
            while len(self._sets) >= self.max_sets:
                self._sets.pop(next(iter(self._sets))).close()
            ps = self._sets[key] = ProgramSet(spec, device=self.device)
        return ps

    def __len__(self) -> int:
        return len(self._sets)
