"""On-card smoke test of the PyTorch/CUDA port (``videop2p_tpu_torch``).

Phases, each of which must pass (any failure exits non-zero):

1. probe the device (``torch.cuda.is_available()``) and print the card's
   name and power limit as ``nvidia-smi`` reports them;
2. build the CUDA kernels from ``videop2p_tpu_torch/ops/csrc`` (one ``nvcc``
   per source, all in parallel);
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes of the main path, in float32 and bfloat16 — frame attention,
   GroupNorm, and both wrappers of the flash kernel — and time the kernel,
   the plain version and one PyTorch library call computing the same
   function;
4. run a small edit (tiny model, 32² latents, so the attention kernels run
   at their 1024-token sites) on the card and on the CPU from the same
   weights, cached-source and live-source, and compare the edited latents;
5. run the main path — ``videop2p_tpu_torch.cli.run_videop2p.main``, the
   cached-source fast edit (``--fast``) — at SD-1.5 width with seeded random
   weights, 512², 8 frames, the rabbit-jump prompts, refine controller,
   equalizer and LocalBlend, for ``--steps`` DDIM steps, with every
   kernel's launch count set to 0 just before and read just after; print
   the cached-maps decision; assert the launch counts, finite output of
   shape (2, 8, 512, 512, 3) and src_err = max|edited[0] − x_0| == 0.0;
6. the same edit with ``--live_source`` (the live-source path), launch
   counts asserted;
7. the same cached edit under ``frame_attention="flash_rect"`` and
   ``"flash"`` (same seed, same weights): the flash kernel launched
   10 × 2 × steps times and the fused kernel not at all, src_err == 0.0;
   the edited latents' distance to the ``"auto"`` edit is printed, and in
   float32 at the default 4 steps or fewer held within 2e-3 (guidance 7.5
   and LocalBlend's thresholded mask amplify per-call differences with the
   steps, so a longer run only prints it);
8. one UNet forward of the cached edit's batch (refine controller on
   captured base maps) under ``"auto"``, ``"flash_rect"`` and ``"flash"``
   against the same forward in float32 through the plain version
   (``"chunked"``), from the same weights and inputs: in float32 within
   1e-4·max|ref|; in bfloat16 a sanity bound, at most 2 × the distance of
   the bfloat16 plain version's forward (the per-kernel checks of phase 3
   are what hold the kernels in bfloat16);
9. with ``--profile``, trace one edit-batch UNet forward of the cached edit
   with ``torch.profiler`` for each ``--frame_attention`` implementation and
   print device time by kernel and the busy share.

Prints the ``{"kernels": [...]}`` line, then the card line, then, last,
``{"ok": true, "device": {...}}``.

Run:  python3 chip_smoke.py [--steps 4] [--mixed_precision fp32|bf16]
                             [--profile [--frame_attention auto flash_rect flash]]
                             [--out PATH.json]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM at its full 700 W (NVIDIA data sheet):
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # fp32 CUDA cores; bf16 dense tensor cores

# the rabbit-jump edit (configs/rabbit-jump-p2p.yaml)
RABBIT = dict(
    pretrained_model_path="./outputs/rabbit-jump",
    image_path="./data/rabbit",
    prompt="a rabbit is jumping on the grass",
    prompts=["a rabbit is jumping on the grass",
             "a origami rabbit is jumping on the grass"],
    blend_word=["rabbit", "rabbit"],
    eq_params={"words": ["origami"], "values": [2]},
    save_name="origami",
    is_word_swap=False,
)

# Limits of kernel vs plain version (max |Δ|). The plain version runs in
# float32 on the kernel's own inputs (bf16 inputs upcast exactly). float32:
# the two differ only in summation order (online vs one-pass softmax; split
# vs single statistics reduction). bfloat16: the kernels accumulate in f32
# and round once on output, which costs at most half a bf16 ulp; the limit
# is 2^-7·max|ref|, one to two bf16 ulps at the largest output.
ATTN_TOL_F32 = 1e-4
GN_TOL_F32 = 2e-4
BF16_REL_TOL = 2.0 ** -7
# the small edit on the card against the same edit on the CPU, and the
# flash variants of the main path against its "auto" edit (float32, at most
# E2E_GATE_STEPS steps: the edit amplifies per-call differences with the steps)
E2E_TOL = 2e-3
E2E_GATE_STEPS = 4
# one cached edit-batch UNet forward under a kernel against the same forward
# in float32 through the plain version: float32 within this times max|ref|;
# bfloat16 (a sanity bound, not a correctness gate: any two bf16
# implementations differ by rounding) within this multiple of the bf16 plain
# version's own distance
FWD_REL_TOL_F32 = 1e-4
BF16_FWD_RATIO = 2.0
# frame-attention sites with N >= 1024 tokens per UNet forward at 512² (the
# 64² and 32² levels) and GroupNorm sites; one forward per inversion step
# and one per edit step
ATTN_SITES = 10
GN_SITES = 61
GN_LAUNCHES_PER_CALL = 3  # partial sums, statistics, apply
# the device kernels of each ported kernel, by name prefix (profile)
KERNEL_NAMES = {"frame_attention": ("frame_attention_kernel",),
                "group_norm": ("gn_partial_kernel", "gn_stats_kernel", "gn_apply_kernel"),
                "flash_attention": ("flash_fwd_wmma_bf16_kernel", "flash_fwd_fma_f32_kernel")}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def limit(dtype, ref: torch.Tensor, f32_tol: float) -> float:
    if dtype == torch.float32:
        return f32_tol
    return BF16_REL_TOL * ref.abs().max().item()


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_attention(gen, dtype, b, f, h, n, d, timed: bool) -> dict:
    import torch.nn.functional as F
    from videop2p_tpu_torch.ops import attention as fa

    dev = "cuda"
    # the head-split views FrameAttention hands the kernel
    q = torch.randn(b, f, n, h, d, generator=gen, device=dev).to(dtype).transpose(2, 3)
    k = torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
    v = torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
    out = fa.fused_frame_attention(q, k, v)
    ref = fa.chunked_frame_attention(q.float(), k.float(), v.float())
    err = (out.float() - ref).abs().max().item()
    tol = limit(dtype, ref, ATTN_TOL_F32)
    rec = {"shape": [b, f, h, n, d], "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err, "tol": tol}
    print(f"  frame_attention {rec['shape']} {rec['dtype']}: max|d| {err:.3e} "
          f"(limit {tol:.3e})", flush=True)
    if not (err <= tol and torch.isfinite(out).all()):
        raise AssertionError(f"frame attention kernel disagrees: {rec}")
    if timed:
        itemsize = torch.finfo(dtype).bits // 8
        m = f * n
        nbytes = b * h * (2 * m + 2 * n) * d * itemsize
        flops = 4.0 * b * h * m * n * d
        # the library call on the same fold: (B, H, F·N, D) against (B, H, N, D)
        q4 = q.transpose(1, 2).reshape(b, h, m, d).contiguous()
        k4, v4 = k.contiguous(), v.contiguous()
        rec["ms"] = time_ms(lambda: fa.fused_frame_attention(q, k, v))
        rec["plain_ms"] = time_ms(lambda: fa.chunked_frame_attention(q, k, v), iters=2)
        rec["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4))
        rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops, dtype)
        print(f"    kernel {rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, "
              f"sdpa {rec['library_ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms "
              f"({rec['bound_by']})", flush=True)
    return rec


def check_flash(gen, dtype, b, f, h, n, d, timed: bool) -> list:
    """Both wrappers of the flash kernel against their plain versions."""
    import torch.nn.functional as F
    from videop2p_tpu_torch.ops import attention as fa

    dev = "cuda"
    q = torch.randn(b, f, n, h, d, generator=gen, device=dev).to(dtype).transpose(2, 3)
    k = torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
    v = torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
    recs = []
    for name in ("flash_rect_frame_attention", "flash_frame_attention"):
        kernel = getattr(fa, name)
        plain = getattr(fa, name + "_reference")
        out = kernel(q, k, v)
        ref = plain(q.float(), k.float(), v.float())
        err = (out.float() - ref).abs().max().item()
        tol = limit(dtype, ref, ATTN_TOL_F32)
        del ref
        rec = {"wrapper": name, "shape": [b, f, h, n, d],
               "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err, "tol": tol}
        print(f"  {name} {rec['shape']} {rec['dtype']}: max|d| {err:.3e} "
              f"(limit {tol:.3e})", flush=True)
        if not (err <= tol and torch.isfinite(out).all()):
            raise AssertionError(f"flash kernel disagrees: {rec}")
        if timed:
            itemsize = torch.finfo(dtype).bits // 8
            m = f * n
            nbytes = b * h * (2 * m + 2 * n) * d * itemsize
            flops = 4.0 * b * h * m * n * d
            q4 = q.transpose(1, 2).reshape(b, h, m, d).contiguous()
            k4, v4 = k.contiguous(), v.contiguous()
            rec["ms"] = time_ms(lambda: kernel(q, k, v))
            rec["plain_ms"] = time_ms(lambda: plain(q, k, v), iters=2)
            rec["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4))
            rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops, dtype)
            print(f"    kernel {rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, "
                  f"sdpa {rec['library_ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms "
                  f"({rec['bound_by']})", flush=True)
        recs.append(rec)
    return recs


def check_group_norm(gen, dtype, n, rows, c, eps, act, timed: bool) -> dict:
    import torch.nn.functional as F
    from videop2p_tpu_torch.ops import groupnorm as gn

    dev = "cuda"
    x = (torch.randn(n, rows, c, generator=gen, device=dev) * 2.0 + 0.5).to(dtype)
    scale = torch.randn(c, generator=gen, device=dev) * 0.2 + 1.0
    bias = torch.randn(c, generator=gen, device=dev) * 0.1
    kw = dict(num_groups=32, eps=eps, act=act)
    out = gn.fused_group_norm(x, scale, bias, **kw)
    ref = gn.group_norm_reference(x.float(), scale, bias, **kw)
    err = (out.float() - ref).abs().max().item()
    tol = limit(dtype, ref, GN_TOL_F32)
    rec = {"shape": [n, rows, c], "dtype": str(dtype).replace("torch.", ""),
           "eps": eps, "act": act, "max_abs_err": err, "tol": tol}
    print(f"  group_norm {rec['shape']} {rec['dtype']} eps={eps:g} act={act}: "
          f"max|d| {err:.3e} (limit {tol:.3e})", flush=True)
    if not (err <= tol and torch.isfinite(out).all()):
        raise AssertionError(f"group norm kernel disagrees: {rec}")
    if timed:
        itemsize = torch.finfo(dtype).bits // 8
        nbytes = 2 * n * rows * c * itemsize
        flops = 8.0 * n * rows * c  # stats (2), apply (2), SiLU (~4)
        x_nc = x.transpose(1, 2).contiguous()  # the library's channels-first layout
        w, bb = scale.to(dtype), bias.to(dtype)

        def library():
            y = F.group_norm(x_nc, 32, w, bb, eps)
            return F.silu(y) if act == "silu" else y

        rec["ms"] = time_ms(lambda: gn.fused_group_norm(x, scale, bias, **kw), iters=10)
        rec["plain_ms"] = time_ms(lambda: gn.group_norm_reference(x, scale, bias, **kw))
        rec["library_ms"] = time_ms(library, iters=10)
        rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops, dtype)
        print(f"    kernel {rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} ms, "
              f"F.group_norm+silu {rec['library_ms']:.3f} ms, bound "
              f"{rec['bound_ms']:.3f} ms ({rec['bound_by']})", flush=True)
    return rec


def small_edit_check(live_source: bool) -> float:
    """The tiny-model edit at 32² latents on the card and on the CPU from the
    same weights; returns max |Δ| of the edited latents."""
    import copy

    from videop2p_tpu_torch.cli.run_videop2p import build_models, main
    from videop2p_tpu_torch.ops import attention as fa

    frames = np.random.default_rng(1).integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    cpu_bundle = build_models(tiny=True, device="cpu", seed=3)
    gpu_bundle = copy.deepcopy(cpu_bundle)
    for mod in (gpu_bundle.unet, gpu_bundle.vae, gpu_bundle.text_encoder):
        mod.to("cuda")
    kw = dict(RABBIT, fast=True, live_source=live_source, width=64, video_len=4,
              num_ddim_steps=3, frames=frames, save_gifs=False)
    before = fa.launch_count()
    on_card = main(**kw, device="cuda", bundle=gpu_bundle)
    if fa.launch_count() == before:
        raise AssertionError("the small edit did not reach the frame-attention kernel")
    on_cpu = main(**kw, device="cpu", bundle=cpu_bundle)
    if on_card["mode"] != on_cpu["mode"]:
        raise AssertionError(f"modes differ: {on_card['mode']} vs {on_cpu['mode']}")
    err = (on_card["latents"].cpu() - on_cpu["latents"]).abs().max().item()
    print(f"  small edit ({on_card['mode']} source), card vs cpu: max|d| of edited "
          f"latents {err:.3e} (limit {E2E_TOL:g})", flush=True)
    if not (err <= E2E_TOL and torch.isfinite(on_card["latents"]).all()):
        raise AssertionError(f"small edit on the card disagrees with the CPU: {err}")
    return err


def edit_forward_inputs(bundle) -> tuple:
    """The inputs of one UNet forward of the cached edit's batch (1 uncond +
    1 edit stream × 8 frames at 64²): latents, text embeddings, and the
    refine controller at step 5 of 50 (inside both the cross and the self
    window) reading the base maps of one capture forward of ``bundle``."""
    from videop2p_tpu_torch.cli.run_videop2p import encode_prompts
    from videop2p_tpu_torch.control import make_controller
    from videop2p_tpu_torch.models.attention import BASE_STORE, AttnControl

    ctx = make_controller(
        RABBIT["prompts"], bundle.tokenizer, 50, is_replace_controller=False,
        cross_replace_steps=0.2, self_replace_steps=0.5,
        blend_words=(("rabbit",), ("rabbit",)), equalizer_params=RABBIT["eq_params"],
        device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    dtype = next(bundle.unet.parameters()).dtype
    x = torch.randn(2, 8, 64, 64, 4, generator=gen, device="cuda").to(dtype)
    with torch.no_grad():
        text = encode_prompts(bundle, ["", RABBIT["prompts"][1]], "cuda")
        store: dict = {}
        bundle.unet(x[:1], 500, encode_prompts(bundle, RABBIT["prompts"][:1], "cuda"),
                    AttnControl(None, 0, capture=True), store)
    control = AttnControl(ctx, 5, 1, cached_base=store[BASE_STORE], cached_source=True)
    return x, text, control


def forward_check(mixed_precision: str) -> dict:
    """One cached edit-batch UNet forward under each frame-attention kernel
    against the same forward in float32 through the plain version
    ("chunked"): same weights (bf16 ones are the float32 ones rounded), same
    latents, text embeddings and captured base maps. Unlike the edited
    latents, one forward does not pass the kernels' differences through
    guidance and LocalBlend's thresholded mask."""
    from videop2p_tpu_torch.cli.run_videop2p import build_models

    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[mixed_precision]
    ref_bundle = build_models(device="cuda", seed=0, frame_attention="chunked")
    x, text, control = edit_forward_inputs(ref_bundle)
    with torch.no_grad():
        ref = ref_bundle.unet(x, 500, text, control, {})
    del ref_bundle
    scale = ref.abs().max().item()
    impls = ("auto", "flash_rect", "flash") + (("chunked",) if dtype != torch.float32 else ())
    errs = {}
    for impl in impls:
        bundle = build_models(dtype=dtype, device="cuda", seed=0, frame_attention=impl)
        with torch.no_grad():
            eps = bundle.unet(x.to(dtype), 500, text.to(dtype), control, {})
        del bundle
        if not torch.isfinite(eps).all():
            raise AssertionError(f"{impl} forward is not finite")
        errs[impl] = (eps.float() - ref).abs().max().item()
        print(f"  {impl} ({mixed_precision}) against chunked (fp32): max|d| of eps "
              f"{errs[impl]:.4e} (max|ref| {scale:.4e})", flush=True)
    torch.cuda.empty_cache()
    if dtype == torch.float32:
        tol = FWD_REL_TOL_F32 * scale
    else:
        tol = BF16_FWD_RATIO * errs["chunked"]
    print(f"  limit {tol:.4e}", flush=True)
    bad = {impl: err for impl, err in errs.items() if not err <= tol}
    if bad:
        raise AssertionError(f"cached edit-batch forward off the plain version: {bad} "
                             f"(limit {tol})")
    return {"dtype": mixed_precision, "max_abs_ref": scale, "max_abs_err": errs, "tol": tol}


def profile_edit_forward(mixed_precision: str, frame_attention: str) -> dict:
    """One UNet forward of the cached edit's batch (:func:`edit_forward_inputs`)
    under ``torch.profiler``, with the UNet's frame attention set to
    ``frame_attention``: device time by kernel name, the ported kernels'
    share, and the device's busy share of the traced window."""
    from torch.profiler import ProfilerActivity, profile

    from videop2p_tpu_torch.cli.run_videop2p import build_models

    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[mixed_precision]
    bundle = build_models(dtype=dtype, device="cuda", seed=0,
                          frame_attention=frame_attention)
    x, text, control = edit_forward_inputs(bundle)
    with torch.no_grad():
        def forward():
            bundle.unet(x, 500, text, control, {})

        forward()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            forward()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del bundle, control
    torch.cuda.empty_cache()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("torch.profiler recorded no device activity")
    by_name: dict = {}
    spans = []
    for e in kernels:
        start, end = e.time_range.start, e.time_range.end
        by_name[e.name] = by_name.get(e.name, 0.0) + (end - start) / 1e3
        spans.append((start, end))
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy = (busy + cur_e - cur_s) / 1e3
    window = (spans[-1][1] - spans[0][0]) / 1e3
    total = sum(by_name.values())
    ours = {name: sum(v for k, v in by_name.items() if any(p in k for p in prefixes))
            for name, prefixes in KERNEL_NAMES.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    print(f"profile: one cached edit-batch UNet forward ({mixed_precision}, "
          f"frame_attention={frame_attention}): host wall "
          f"{wall_ms:.2f} ms, device kernel time {total:.2f} ms, device busy "
          f"{busy:.2f} ms of a {window:.2f} ms kernel window "
          f"({100 * busy / window:.1f} %)", flush=True)
    for name, kernel_ms in ours.items():
        print(f"  {name}: {kernel_ms:.2f} ms ({100 * kernel_ms / total:.1f} %)")
    for name, kernel_ms in top:
        print(f"  {kernel_ms:8.2f} ms {100 * kernel_ms / total:5.1f} %  {name[:100]}")
    return {"dtype": mixed_precision, "frame_attention": frame_attention,
            "wall_ms": wall_ms, "kernel_ms": total,
            "busy_ms": busy, "window_ms": window, "ported_ms": ours,
            "top": [[name, kernel_ms] for name, kernel_ms in top]}


def run_main_path(frames, steps: int, mixed_precision: str, **kw) -> dict:
    """One edit through ``cli.run_videop2p.main`` with every launch count set
    to 0 just before and read just after; checks the output and, for the
    cached-source path, src_err == 0.0 exactly."""
    from videop2p_tpu_torch.cli.run_videop2p import main as run_edit
    from videop2p_tpu_torch.ops import attention as fa
    from videop2p_tpu_torch.ops import groupnorm as gn

    torch.cuda.empty_cache()
    fa.reset_launch_count()
    gn.reset_launch_count()
    fa.reset_flash_launch_count()
    t0 = time.perf_counter()
    res = run_edit(**RABBIT, fast=True, device="cuda", mixed_precision=mixed_precision,
                   width=512, video_len=8, num_ddim_steps=steps, frames=frames,
                   save_gifs=False, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"frame_attention": fa.launch_count(), "group_norm": gn.launch_count(),
                "flash_attention": fa.flash_launch_count()}
    # the CLI resets the peak at each phase and records it
    peak = max(res["peak_gib"].values())
    videos = res["videos"]
    src_err = (res["latents"][0] - res["x_0"][0]).abs().max().item()
    print(f"  {res['mode']} source, {steps} steps, {mixed_precision}: {wall:.2f} s; "
          "phases (s) " + ", ".join(f"{k} {v:.3f}" for k, v in res["timings"].items()),
          flush=True)
    if res["cached_maps"] is not None:
        cm = res["cached_maps"]
        print(f"  cached maps: {cm['gib']:.3f} GiB against a budget of "
              f"{cm['budget_gib']:.1f} GiB, temporal maps stored "
              f"{cm['temporal_maps_dtype']}, cross window {cm['cross_len']} steps, "
              f"self window {tuple(cm['self_window'])}", flush=True)
    print(f"  launches: {launches}; peak memory {peak:.2f} GiB (by phase: "
          + ", ".join(f"{k} {v:.2f}" for k, v in res["peak_gib"].items())
          + f"); src_err {src_err!r}", flush=True)
    if tuple(videos.shape) != (2, 8, 512, 512, 3):
        raise AssertionError(f"output shape {tuple(videos.shape)}")
    if not torch.isfinite(videos).all():
        raise AssertionError("non-finite output video")
    if res["mode"] == "cached" and src_err != 0.0:
        raise AssertionError(f"cached source stream is not x_0: src_err {src_err!r}")
    return {"mode": res["mode"], "steps": steps, "dtype": mixed_precision, "wall_s": wall,
            "timings": res["timings"], "launches": launches, "peak_gib": peak,
            "peak_gib_by_phase": res["peak_gib"],
            "src_err": src_err, "cached_maps": res["cached_maps"],
            "latents": res["latents"]}


def expect_launches(run: dict, steps: int, frame_attention: str) -> None:
    """The launch counts of one main-path run: ATTN_SITES frame-attention
    launches per UNet forward on the chosen kernel (none on the other),
    GroupNorm three per site; one forward per inversion and per edit step."""
    forwards = 2 * steps
    want = {"frame_attention": 0, "flash_attention": 0,
            "group_norm": GN_LAUNCHES_PER_CALL * GN_SITES * forwards}
    kernel = {"auto": "frame_attention", "flash": "flash_attention",
              "flash_rect": "flash_attention"}[frame_attention]
    want[kernel] = ATTN_SITES * forwards
    if run["launches"] != want:
        raise AssertionError(f"kernel launches {run['launches']}, expected {want}")


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=4,
                        help="DDIM steps of every main-path run's inversion and edit")
    parser.add_argument("--mixed_precision", choices=("fp32", "bf16"), default="fp32",
                        help="compute dtype of the main path (the CLI's default: fp32)")
    parser.add_argument("--profile", action="store_true",
                        help="also trace one cached edit-batch UNet forward with "
                             "torch.profiler")
    parser.add_argument("--frame_attention", nargs="+", default=["auto"],
                        choices=("auto", "flash_rect", "flash"),
                        help="the frame-attention implementations to profile")
    parser.add_argument("--out", type=str, default=None,
                        help="also write the measurements to this JSON file")
    args = parser.parse_args()

    # 1. probe
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)

    from videop2p_tpu_torch.cli.run_videop2p import build_models
    from videop2p_tpu_torch.ops import _build

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s ({', '.join(_build.KERNEL_SOURCES)})", flush=True)

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = {"frame_attention": [], "group_norm": [], "flash_attention": []}
    print("kernel checks:", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        # B = 3: the live edit's batch; B = 2, 1: the cached edit's and its
        # capture's
        for shape in ((3, 8, 8, 4096, 40), (3, 8, 8, 1024, 80), (2, 8, 8, 4096, 40),
                      (1, 8, 8, 4096, 40), (2, 8, 8, 1024, 80), (1, 3, 2, 1000, 40),
                      (2, 2, 4, 1100, 64)):
            timed = shape[0] == 3
            checks["frame_attention"].append(check_attention(gen, dtype, *shape, timed))
            checks["flash_attention"] += check_flash(gen, dtype, *shape, timed)
        for n, rows, c, eps, act in ((3, 8 * 4096, 640, 1e-5, "silu"),
                                     (24, 4096, 320, 1e-6, "none"),
                                     (3, 8 * 64, 1280, 1e-5, "silu"),
                                     (2, 1000, 96, 1e-5, "silu")):
            timed = c in (640, 320)
            checks["group_norm"].append(
                check_group_norm(gen, dtype, n, rows, c, eps, act, timed))
    torch.cuda.empty_cache()

    # 4. small edits, card against cpu
    print("small edit:", flush=True)
    small_err = {mode: small_edit_check(live_source=mode == "live")
                 for mode in ("cached", "live")}

    frames = np.random.default_rng(0).integers(0, 256, (8, 512, 512, 3), dtype=np.uint8)
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[args.mixed_precision]
    # 5. the main path: the cached-source fast edit, "auto" frame attention,
    # after one untimed 1-step edit that takes the first-call costs
    # (cuDNN's algorithm choice, allocator growth)
    print(f"main path (SD-1.5 width, 512², 8 frames):", flush=True)
    run_main_path(frames, 1, args.mixed_precision)
    runs = {"auto": run_main_path(frames, args.steps, args.mixed_precision)}
    if runs["auto"]["mode"] != "cached":
        raise AssertionError("the main path did not take the cached-source edit")
    expect_launches(runs["auto"], args.steps, "auto")
    # 6. the live-source path
    runs["live"] = run_main_path(frames, args.steps, args.mixed_precision, live_source=True)
    expect_launches(runs["live"], args.steps, "auto")
    # 7. the cached edit through the flash kernel, same seed and weights;
    # both variants run before a disagreement fails the script
    gate = dtype == torch.float32 and args.steps <= E2E_GATE_STEPS
    failures = []
    for impl in ("flash_rect", "flash"):
        bundle = build_models(dtype=dtype, device="cuda", seed=0, frame_attention=impl)
        runs[impl] = run_main_path(frames, args.steps, args.mixed_precision, bundle=bundle)
        del bundle
        expect_launches(runs[impl], args.steps, impl)
        d = (runs[impl]["latents"] - runs["auto"]["latents"]).abs()
        diff = runs[impl]["max_abs_diff_vs_auto"] = d.max().item()
        runs[impl]["mean_abs_diff_vs_auto"] = d.mean().item()
        print(f"  {impl} against auto: edited latents max|d| {diff:.4e}, "
              f"mean|d| {d.mean().item():.4e}"
              + (f" (limit {E2E_TOL:g})" if gate else " (not gated)"), flush=True)
        if not np.isfinite(diff):
            failures.append(f"{impl} edit is not finite")
        elif gate and diff > E2E_TOL:
            failures.append(f"{impl} edit differs from the auto edit by {diff} "
                            f"(limit {E2E_TOL})")
    for run in runs.values():
        del run["latents"]
    torch.cuda.empty_cache()
    # 8. one edit-batch forward under each kernel against the plain version
    print("cached edit-batch forward against the plain version:", flush=True)
    forward = forward_check(args.mixed_precision)
    # 9. profile
    profiled = ([profile_edit_forward(args.mixed_precision, impl)
                 for impl in args.frame_attention] if args.profile else None)

    dname = str(dtype).replace("torch.", "")
    big_attn = [3, 8, 8, 4096, 40]

    def entry(name, kind, shape, run, counter, source, replaces):
        """A kernel's line: its check at the largest main-path shape in the
        main path's dtype, and its launches on the path that runs it."""
        rec = next(c for c in checks[kind] if c.get("wrapper", kind) == name
                   and c["shape"] == shape and c["dtype"] == dname)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": runs[run]["launches"][counter],
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                "shape": rec["shape"], "dtype": rec["dtype"]}

    kernels = [
        entry("frame_attention", "frame_attention", big_attn, "auto", "frame_attention",
              "videop2p_tpu_torch/ops/csrc/frame_attention.cu",
              "videop2p_tpu/ops/attention.py:111"),
        entry("group_norm", "group_norm", [3, 8 * 4096, 640], "auto", "group_norm",
              "videop2p_tpu_torch/ops/csrc/groupnorm.cu",
              "videop2p_tpu/ops/groupnorm.py:69"),
        entry("flash_rect_frame_attention", "flash_attention", big_attn, "flash_rect",
              "flash_attention", "videop2p_tpu_torch/ops/csrc/flash_attention.cu",
              "videop2p_tpu/ops/attention.py:94"),
        entry("flash_frame_attention", "flash_attention", big_attn, "flash",
              "flash_attention", "videop2p_tpu_torch/ops/csrc/flash_attention.cu",
              "videop2p_tpu/ops/attention.py:81"),
    ]
    if args.out:
        import os

        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": card, "kind": kind, "build_s": build_s,
                       "checks": checks, "small_edit_err": small_err, "forward": forward,
                       "profile": profiled, "main_path": runs}, fh, indent=1)
    if failures:
        print("chip_smoke failed: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
