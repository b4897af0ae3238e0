"""On-card smoke test of the PyTorch/CUDA port (``videop2p_tpu_torch``).

Phases, each of which must pass (any failure exits non-zero):

1. probe the device (``torch.cuda.is_available()``) and print the card's
   name and power limit as ``nvidia-smi`` reports them;
2. build the CUDA kernels from ``videop2p_tpu_torch/ops/csrc`` (one ``nvcc``
   per source, all in parallel);
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes of the main path, in float32 and bfloat16, and time the kernel,
   the plain version and one PyTorch library call computing the same
   function;
4. run a small edit (tiny model, 32² latents, so the frame-attention kernel
   runs at its 1024-token sites) on the card and on the CPU from the same
   weights, and compare the edited latents;
5. run the main path — ``videop2p_tpu_torch.cli.run_videop2p.main`` — at
   SD-1.5 width with seeded random weights, 512², 8 frames, the rabbit-jump
   prompts, refine controller, equalizer and LocalBlend, for ``--steps``
   DDIM steps, with every kernel's launch count set to 0 just before and
   read just after; assert finite output of shape (2, 8, 512, 512, 3);
6. with ``--profile``, trace one edit-batch UNet forward with
   ``torch.profiler`` and print device time by kernel and the busy share.

Prints the ``{"kernels": [...]}`` line, then the card line, then, last,
``{"ok": true, "device": {...}}``.

Run:  python3 chip_smoke.py [--steps 4] [--mixed_precision fp32|bf16]
                             [--profile] [--out PATH.json]
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
# the small edit on the card against the same edit on the CPU
E2E_TOL = 2e-3


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


def small_edit_check() -> float:
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
    kw = dict(RABBIT, fast=True, live_source=True, width=64, video_len=4,
              num_ddim_steps=3, frames=frames, save_gifs=False)
    before = fa.launch_count()
    on_card = main(**kw, device="cuda", bundle=gpu_bundle)["latents"]
    if fa.launch_count() == before:
        raise AssertionError("the small edit did not reach the frame-attention kernel")
    on_cpu = main(**kw, device="cpu", bundle=cpu_bundle)["latents"]
    err = (on_card.cpu() - on_cpu).abs().max().item()
    print(f"  small edit, card vs cpu: max|d| of edited latents {err:.3e} "
          f"(limit {E2E_TOL:g})", flush=True)
    if not (err <= E2E_TOL and torch.isfinite(on_card).all()):
        raise AssertionError(f"small edit on the card disagrees with the CPU: {err}")
    return err


def profile_edit_forward(mixed_precision: str) -> dict:
    """One UNet forward of the edit batch (1 uncond + 2 cond streams × 8
    frames at 64², refine controller) under ``torch.profiler``: device time
    by kernel name, the two ported kernels' share, and the device's busy
    share of the traced window."""
    from torch.profiler import ProfilerActivity, profile

    from videop2p_tpu_torch.cli.run_videop2p import build_models, encode_prompts
    from videop2p_tpu_torch.control import make_controller
    from videop2p_tpu_torch.models.attention import AttnControl

    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[mixed_precision]
    bundle = build_models(dtype=dtype, device="cuda", seed=0)
    ctx = make_controller(
        RABBIT["prompts"], bundle.tokenizer, 50, is_replace_controller=False,
        cross_replace_steps=0.2, self_replace_steps=0.5,
        blend_words=(("rabbit",), ("rabbit",)), equalizer_params=RABBIT["eq_params"],
        device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(3, 8, 64, 64, 4, generator=gen, device="cuda")
    with torch.no_grad():
        text = encode_prompts(bundle, ["", *RABBIT["prompts"]], "cuda")

        def forward():
            bundle.unet(x, 500, text, AttnControl(ctx, 5, 1), {})

        forward()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            forward()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
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
    ours = {"frame_attention": sum(v for k, v in by_name.items()
                                   if "frame_attention_kernel" in k),
            "group_norm": sum(v for k, v in by_name.items()
                              if any(g in k for g in ("gn_partial_kernel",
                                                      "gn_stats_kernel",
                                                      "gn_apply_kernel")))}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    print(f"profile: one edit-batch UNet forward ({mixed_precision}): host wall "
          f"{wall_ms:.2f} ms, device kernel time {total:.2f} ms, device busy "
          f"{busy:.2f} ms of a {window:.2f} ms kernel window "
          f"({100 * busy / window:.1f} %)", flush=True)
    for name, kernel_ms in ours.items():
        print(f"  {name}: {kernel_ms:.2f} ms ({100 * kernel_ms / total:.1f} %)")
    for name, kernel_ms in top:
        print(f"  {kernel_ms:8.2f} ms {100 * kernel_ms / total:5.1f} %  {name[:100]}")
    return {"dtype": mixed_precision, "wall_ms": wall_ms, "kernel_ms": total,
            "busy_ms": busy, "window_ms": window, "ported_ms": ours,
            "top": [[name, kernel_ms] for name, kernel_ms in top]}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=4,
                        help="DDIM steps of the main path's inversion and edit")
    parser.add_argument("--mixed_precision", choices=("fp32", "bf16"), default="fp32",
                        help="compute dtype of the main path (the CLI's default: fp32)")
    parser.add_argument("--profile", action="store_true",
                        help="also trace one edit-batch UNet forward with torch.profiler")
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

    from videop2p_tpu_torch.ops import _build
    from videop2p_tpu_torch.ops import attention as fa
    from videop2p_tpu_torch.ops import groupnorm as gn

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s ({', '.join(_build.KERNEL_SOURCES)})", flush=True)

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = {"frame_attention": [], "group_norm": []}
    print("kernel checks:", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((3, 8, 8, 4096, 40), (3, 8, 8, 1024, 80), (1, 3, 2, 1000, 40),
                      (2, 2, 4, 1100, 64)):
            timed = shape[3] in (4096, 1024)
            checks["frame_attention"].append(check_attention(gen, dtype, *shape, timed))
        for n, rows, c, eps, act in ((3, 8 * 4096, 640, 1e-5, "silu"),
                                     (24, 4096, 320, 1e-6, "none"),
                                     (3, 8 * 64, 1280, 1e-5, "silu"),
                                     (2, 1000, 96, 1e-5, "silu")):
            timed = c in (640, 320)
            checks["group_norm"].append(
                check_group_norm(gen, dtype, n, rows, c, eps, act, timed))
    torch.cuda.empty_cache()

    # 4. small edit, card against cpu
    print("small edit:", flush=True)
    small_err = small_edit_check()

    # 5. the main path
    from videop2p_tpu_torch.cli.run_videop2p import main as run_edit

    frames = np.random.default_rng(0).integers(0, 256, (8, 512, 512, 3), dtype=np.uint8)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_count()
    gn.reset_launch_count()
    t0 = time.perf_counter()
    res = run_edit(**RABBIT, fast=True, live_source=True, device="cuda",
                   mixed_precision=args.mixed_precision, width=512, video_len=8,
                   num_ddim_steps=args.steps, frames=frames, save_gifs=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"frame_attention": fa.launch_count(), "group_norm": gn.launch_count()}
    videos = res["videos"]
    print(f"main path ({args.steps} steps, {args.mixed_precision}, SD-1.5 width, "
          "512², 8 frames): "
          f"{wall:.2f} s; phases (s) "
          + ", ".join(f"{k} {v:.3f}" for k, v in res["timings"].items()), flush=True)
    print(f"  launches: {launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if tuple(videos.shape) != (2, 8, 512, 512, 3):
        raise AssertionError(f"output shape {tuple(videos.shape)}")
    if not torch.isfinite(videos).all():
        raise AssertionError("non-finite output video")
    # per UNet forward: 10 frame-attention sites with N >= 1024 tokens (one
    # launch each) and 61 GroupNorm sites (three launches each: partial sums,
    # statistics, apply); one forward per inversion step and per edit step
    want = {"frame_attention": 10 * 2 * args.steps,
            "group_norm": 3 * 61 * 2 * args.steps}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    profiled = profile_edit_forward(args.mixed_precision) if args.profile else None

    def entry(name, source, replaces, headline):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": headline["max_abs_err"], "ms": headline["ms"],
                "plain_ms": headline["plain_ms"], "bound_ms": headline["bound_ms"],
                "bound_by": headline["bound_by"], "library_ms": headline["library_ms"],
                "shape": headline["shape"], "dtype": headline["dtype"]}

    kernels = [
        entry("frame_attention", "videop2p_tpu_torch/ops/csrc/frame_attention.cu",
              "videop2p_tpu/ops/attention.py:111", checks["frame_attention"][0]),
        entry("group_norm", "videop2p_tpu_torch/ops/csrc/groupnorm.cu",
              "videop2p_tpu/ops/groupnorm.py:69", checks["group_norm"][0]),
    ]
    if args.out:
        import os

        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": card, "kind": kind, "build_s": build_s,
                       "checks": checks, "small_edit_err": small_err,
                       "profile": profiled,
                       "main_path": {"steps": args.steps, "wall_s": wall,
                                     "dtype": args.mixed_precision,
                                     "timings": res["timings"], "launches": launches,
                                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}},
                      fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
