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
latents; the decodes gather the clip first). JAX's refusals hold: no
``quant_mode`` and no student on such a mesh. A data-only mesh (dp > 1,
JAX's ``batch_dispatch="vmap"`` serving) and the serving engine over a
mesh wait for ROADMAP Queue 1 item 13's rest.
"""

from __future__ import annotations

import copy
import os
import threading
import time
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from videop2p_tpu_torch.obs.ledger import instrumented_program

__all__ = ["ProgramSpec", "ProgramSet", "ProgramCache", "MASK_TH"]

# the Stage-2 working-point constant (cli/run_videop2p.py uses the same)
MASK_TH = (0.3, 0.3)

# bounded per-set program cache: (name, statics) -> instrumented callable
_PROGRAMS_MAX = 32

_DTYPES = {"fp16": torch.bfloat16, "bf16": torch.bfloat16,
           "fp32": torch.float32, "no": torch.float32}


@dataclass(frozen=True)
class ProgramSpec:
    """Everything that determines a program set's identity (the JAX
    package's fields).

    The engine and the store key on :meth:`fingerprint`, which uses the
    checkpoint's CONTENT identity: re-tuning a checkpoint in place gives a
    new fingerprint, never a warm program over stale weights. ``mesh``,
    ``ring_variant`` and ``tp_collectives`` are the multi-GPU knobs: a
    :class:`ProgramSet` takes a model-parallel mesh; the serving engine
    serves their defaults only (ROADMAP Queue 1 item 13's rest)."""

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


def check_single_device(spec: ProgramSpec) -> None:
    """Raise for a spec the serving engine would serve over several GPUs
    (ROADMAP Queue 1 item 13's rest: the engine's mesh, its sharded
    schedules and the data-mesh dispatch)."""
    if spec.mesh not in (None, "", "1,1,1"):
        raise NotImplementedError(
            f"mesh {spec.mesh!r}: multi-GPU serving is not ported (ROADMAP Queue 1 "
            "item 13's rest)")
    if spec.ring_variant != "overlap" or spec.tp_collectives != "gspmd":
        raise NotImplementedError(
            f"ring_variant={spec.ring_variant!r} / tp_collectives={spec.tp_collectives!r}: "
            "sharded serving schedules are not ported (ROADMAP Queue 1 item 13's rest)")


class ProgramSet:
    """Warm, instrumented programs for one :class:`ProgramSpec` on one
    device (CUDA unless a CPU device is given), or on each rank of a
    model-parallel mesh (the module docstring). ``bundle`` replaces the
    models ``build_models`` would make (its modules on ``device``)."""

    def __init__(self, spec: ProgramSpec, *, bundle: Any = None, device="cuda"):
        from videop2p_tpu_torch.cli.common import build_models, parse_mesh, setup_mesh
        from videop2p_tpu_torch.models.convert import quantize_unet_params
        from videop2p_tpu_torch.models.quant import validate_quant_mode
        from videop2p_tpu_torch.pipelines.reuse import validate_reuse_schedule
        from videop2p_tpu_torch.pipelines.sampling import make_unet_fn

        self.spec = spec = spec.resolved()
        quant_mode = validate_quant_mode(spec.quant_mode)
        dp, sp, tp = parse_mesh(spec.mesh)
        model_parallel = sp > 1 or tp > 1
        if dp > 1:
            raise NotImplementedError(
                f"mesh {spec.mesh!r}: a data mesh (batched dispatch over dp GPUs) is not "
                "ported (ROADMAP Queue 1 item 13's rest)")
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
        # programs built into the cache (a miss); chip_smoke and the tests
        # read it to show a warm set serves without building anything
        self.cache_misses = 0
        self.warmed: Optional[Dict[str, Any]] = None

    # ---- program cache ---------------------------------------------------

    def sync(self) -> None:
        """Wait for the card (nothing on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _program(self, key: Tuple, label: str, fn: Callable) -> Callable:
        with self._lock:
            prog = self._programs.get(key)
            if prog is None:
                self.cache_misses += 1
                while len(self._programs) >= _PROGRAMS_MAX:
                    self._programs.pop(next(iter(self._programs)))

                def no_grad_fn(*args, **kwargs):
                    with torch.no_grad():
                        return fn(*args, **kwargs)

                prog = self._programs[key] = instrumented_program(
                    no_grad_fn, program=label, sync=self.sync)
        return prog

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

    def frames_to_video(self, frames: np.ndarray) -> torch.Tensor:
        """(F, H, W, 3) uint8 frames → the (1, F, H, W, 3) [-1, 1] float32
        tensor the encode program takes."""
        return torch.as_tensor(np.asarray(frames), dtype=torch.float32,
                               device=self.device)[None] / 127.5 - 1.0

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

        def fn(x, cond, uncond):
            out = edit_sample(self.unet_fn, self.scheduler, x, cond, uncond,
                              num_inference_steps=steps, guidance_scale=guidance)
            return self._decode01(out)

        prog = self._program(("sample_decode", steps, guidance), "sample_decode", fn)
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
        from videop2p_tpu_torch.pipelines.inversion import ddim_inversion_captured

        cross_len, self_window, tm_dtype = self.capture_plan(ctx, latents, cond_src)
        capture_blend = ctx is not None and ctx.blend is not None
        statics = ("serve_invert", cross_len, self_window, capture_blend,
                   None if tm_dtype is None else str(tm_dtype))
        prog = self._program(statics, "serve_invert", lambda x, c: ddim_inversion_captured(
            self.unet_fn, self.scheduler, x, c, num_inference_steps=self.spec.steps,
            cross_len=cross_len, self_window=self_window, capture_blend=capture_blend,
            temporal_maps_dtype=tm_dtype))
        return prog(latents, cond_src)

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
        from videop2p_tpu_torch.pipelines.sampling import edit_sample

        guidance = self.spec.guidance_scale
        steps = int(steps) if steps else self.spec.steps
        head = self.student_head if student else None
        if student and head is None:
            raise ValueError("student edit requested but the spec has no student_ckpt — "
                             "build the ProgramSet with ProgramSpec.student_ckpt set")
        unet_fn = self.student_fn if student else self.unet_fn

        def fn(cached, cond_all, uncond, ctx, anchor):
            out = edit_sample(unet_fn, self.scheduler, cached.src_latents[0], cond_all, uncond,
                              num_inference_steps=steps, guidance_scale=guidance, ctx=ctx,
                              source_uses_cfg=False, cached_source=cached,
                              step_positions=positions, reuse_schedule=reuse,
                              student_head=head)
            # stream 0 must be the exact inversion reconstruction: compare
            # it with the ANCHOR stored with the products (the encoded
            # source latents) — 0.0 exactly when the replay is intact (on a
            # mesh this rank's frames against its own anchor)
            src_err = (out[:1] - anchor).abs().max().float()
            videos01 = self._decode01(out)
            return videos01, src_err

        return fn

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
            ("serve_edit", steps, self.spec.guidance_scale, reuse, student),
            "serve_edit" + self._suffix(steps, reuse, student),
            self._edit_fn(steps, positions, reuse, student))
        return prog(cached, cond_all, uncond, ctx, anchor)

    def edit_decode_batch(self, members, *, dispatch: str = "scan",
                          steps: Optional[int] = None, reuse: Optional[str] = None,
                          student: bool = False):
        """Compatible requests (``serve/batching.py:stack_items``) → one
        dispatch: each member runs through the singleton's program in turn,
        so each result is bit-identical to its singleton's and a batch needs
        no program of its own to warm. Returns the videos and src_err
        stacked on a leading batch axis. ``"vmap"`` (JAX's data-mesh
        dispatch) raises."""
        if dispatch == "vmap":
            raise NotImplementedError(
                "batch_dispatch 'vmap' shards a batch over a data mesh: multi-GPU "
                "serving is not ported (ROADMAP Queue 1 item 13's rest)")
        if dispatch != "scan":
            raise ValueError(f"dispatch must be 'scan' or 'vmap', got {dispatch!r}")
        outs = [self.edit_decode(*member, steps=steps, reuse=reuse, student=student)
                for member in members]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])

    # ---- warmup ----------------------------------------------------------

    def warm(self, prompts: Sequence[str] = ("a video", "an edited video"), *,
             controller_kwargs: Optional[Dict] = None, step_buckets: Sequence[int] = (),
             reuse_schedules: Sequence[str] = (),
             student_steps: Sequence[int] = ()) -> Dict[str, Any]:
        """Run every request-path program once, on zeros: encode →
        invert-capture → edit + decode, plus the few-step
        (``step_buckets``), reuse and student variants asked for; the
        kernels build on the first call. Returns the summary ``/healthz``
        reports (``steps``, ``reuse`` and ``student`` are the warmed lists
        the engine admits per-request values against; ``quant`` the set's
        one quant mode)."""
        t0 = time.perf_counter()
        spec = self.spec
        kw = dict(controller_kwargs or {})
        ctx = self.controller(prompts, **kw)
        frames = np.zeros((spec.video_len, spec.width, spec.width, 3), np.uint8)
        latents = self.encode(self.frames_to_video(frames))
        _, cached = self.invert_capture(latents, self.encode_prompts(prompts[:1]), ctx)
        cond_all = self.encode_prompts(prompts)
        uncond = self.encode_prompts([""])[0]
        args = (cached, cond_all, uncond, ctx, latents)
        _, src_err = self.edit_decode(*args)
        warmed_steps = {spec.steps}
        for s in map(int, step_buckets):
            if s not in warmed_steps:
                ctx_s = self.controller(prompts, steps=s, **kw)
                self.edit_decode(cached, cond_all, uncond, ctx_s, latents, steps=s)
                warmed_steps.add(s)
        warmed_reuse = {self._resolve_reuse(None, spec.steps)}
        for r in reuse_schedules:
            r = self._resolve_reuse(str(r), spec.steps)
            if r not in warmed_reuse:
                self.edit_decode(*args, reuse=r)
                warmed_reuse.add(r)
        if student_steps and self.student_head is None:
            raise ValueError("student_steps given but the spec has no student_ckpt — "
                             "nothing to warm the student buckets with")
        warmed_student: set = set()
        for s in map(int, student_steps):
            if s not in warmed_student:
                ctx_s = self.controller(prompts, steps=s, **kw) if s != spec.steps else ctx
                self.edit_decode(cached, cond_all, uncond, ctx_s, latents, steps=s,
                                 student=True)
                warmed_student.add(s)
        self.sync()
        self.warmed = {
            "seconds": round(time.perf_counter() - t0, 3),
            "prompts": list(prompts),
            "steps": sorted(warmed_steps),
            "reuse": sorted(warmed_reuse),
            "quant": spec.quant_mode,
            "student": sorted(warmed_student),
            "src_err": float(src_err),
        }
        return self.warmed


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
                self._sets.pop(next(iter(self._sets)))
            ps = self._sets[key] = ProgramSet(spec, device=self.device)
        return ps

    def __len__(self) -> int:
        return len(self._sets)
