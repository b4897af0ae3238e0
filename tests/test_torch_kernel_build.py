"""CPU tests of what surrounds the Hopper kernels of videop2p_tpu_torch: the
TMA-eligibility check of the bf16 attention kernels
(``ops/attention.py:check_tma_operand``), the bf16 backward's choice of
copying an output gradient its TMA maps cannot read (``_tma_rows``) and of
the dK/dV kernel's cluster split (``dkv_split``), the build digest that
covers the headers a source includes, and the reading of ptxas's resource
report (``ops/_build.py``). No card and no nvcc needed."""

import os
import re
import shutil

import pytest
import torch

from videop2p_tpu_torch.ops import _build
from videop2p_tpu_torch.ops.attention import _tma_rows, check_tma_operand, dkv_split

ATTENTION_SOURCES = ("frame_attention.cu", "flash_attention.cu", "flash_attention_bwd.cu")


@pytest.mark.parametrize("d", [40, 80])
def test_tma_check_takes_head_split_views_of_projections(d):
    """The views FrameAttention hands the kernels: q of the (B, F, N, H, D)
    projection as (B, F, H, N, D), k and v of (B, N, H, D) as (B, H, N, D),
    K/V broadcast over frames at stride 0 (the flash wrapper), and the
    frame fold of flash_rect."""
    b, f, n, h = 2, 3, 64, 8
    q = torch.zeros(b, f, n, h, d, dtype=torch.bfloat16).transpose(2, 3)
    k = torch.zeros(b, n, h, d, dtype=torch.bfloat16).transpose(1, 2)
    views = {"q": q, "k": k, "k per frame": k[:, None].expand(b, f, h, n, d),
             "q folded": q.transpose(1, 2).reshape(b, h, f * n, d)[:, None],
             "head 5": q[:, :, 5]}
    for name, view in views.items():
        check_tma_operand(name, view)


def test_tma_check_refuses_a_misaligned_base():
    flat = torch.zeros(2 * 3 * 64 * 8 * 40 + 1, dtype=torch.bfloat16)
    q = flat[1:].view(2, 3, 64, 8, 40).transpose(2, 3)
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        check_tma_operand("q", q)


def test_tma_check_refuses_a_non_unit_head_dim_stride():
    q = torch.zeros(2, 3, 64, 8, 80, dtype=torch.bfloat16)[..., ::2].transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous last dimension"):
        check_tma_operand("q", q)


def test_tma_check_refuses_a_stride_off_16_bytes():
    """Head dim 100 in bf16: a token stride of H·100 elements is 200·H
    bytes, a multiple of 16 only for even H; a head's stride of 200 bytes
    never is."""
    q = torch.zeros(1, 2, 64, 2, 100, dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        check_tma_operand("q", q)


def test_build_digest_covers_the_headers(tmp_path):
    """A library's name changes when a header in csrc/ changes (the sources
    include the shared warpgroup core), not only when its own source does."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    header = csrc / "frame_attention_sm90.cuh"
    before = {src: _build.source_digest(src, str(csrc)) for src in _build.KERNEL_SOURCES}
    assert before == {src: _build.source_digest(src) for src in _build.KERNEL_SOURCES}
    text = header.read_text()
    header.write_text(text + "\n// edited\n")
    after = {src: _build.source_digest(src, str(csrc)) for src in _build.KERNEL_SOURCES}
    assert all(after[src] != before[src] for src in _build.KERNEL_SOURCES)
    header.write_text(text)
    assert {src: _build.source_digest(src, str(csrc))
            for src in _build.KERNEL_SOURCES} == before
    os.remove(csrc / "frame_attention.cu")
    (csrc / "frame_attention.cu").write_text("// another source\n")
    assert _build.source_digest("frame_attention.cu", str(csrc)) != before["frame_attention.cu"]


def _includes(name, csrc=_build.CSRC):
    """The csrc headers ``name`` includes, directly or through another."""
    with open(os.path.join(csrc, name)) as fh:
        direct = re.findall(r'#include "([^"]+)"', fh.read())
    return set(direct).union(*(_includes(h, csrc) for h in direct))


def test_attention_sources_include_the_shared_sm90_header():
    """The bf16 forward core (fused and flash kernels), the two backward
    cores (bf16, and float32 on the TF32 tensor cores) and the float32
    forward core all build on sm90_common.cuh, the PTX helpers they share;
    the two float32 cores also on sm90_tf32_common.cuh, the 3×TF32 pieces
    they share, and both forward sources take both forward cores."""
    tf32 = {"sm90_tf32_common.cuh", "sm90_common.cuh"}
    assert _includes("frame_attention_sm90.cuh") == {"sm90_common.cuh"}
    assert _includes("flash_attention_bwd_sm90.cuh") == {"sm90_common.cuh"}
    assert _includes("sm90_tf32_common.cuh") == {"sm90_common.cuh"}
    assert _includes("flash_attention_bwd_tf32_sm90.cuh") == tf32
    assert _includes("frame_attention_tf32_sm90.cuh") == tf32
    for src in ATTENTION_SOURCES:
        assert "sm90_common.cuh" in _includes(src), src
    for src in ("frame_attention.cu", "flash_attention.cu"):
        assert _includes(src) == {"frame_attention_sm90.cuh",
                                  "frame_attention_tf32_sm90.cuh"} | tf32, src
    assert _includes("flash_attention_bwd.cu") == {"flash_attention_bwd_sm90.cuh",
                                                    "flash_attention_bwd_tf32_sm90.cuh"} | tf32


@pytest.mark.parametrize("header", ["sm90_common.cuh", "flash_attention_bwd_sm90.cuh",
                                    "flash_attention_bwd_tf32_sm90.cuh", "sm90_tf32_common.cuh",
                                    "frame_attention_tf32_sm90.cuh"])
def test_build_digest_covers_the_shared_headers(tmp_path, header):
    """Editing a shared header or a warpgroup core renames the library of
    every attention source, so no stale build of one is loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    before = {src: _build.source_digest(src, str(csrc)) for src in ATTENTION_SOURCES}
    (csrc / header).write_text((csrc / header).read_text() + "\n// edited\n")
    after = {src: _build.source_digest(src, str(csrc)) for src in ATTENTION_SOURCES}
    assert all(after[src] != before[src] for src in ATTENTION_SOURCES)


def _strided(shape, strides, offset=0, dtype=torch.bfloat16):
    storage = torch.zeros(offset + 1 + sum((n - 1) * st for n, st in zip(shape, strides)),
                          dtype=dtype)
    return storage.as_strided(shape, strides, offset)


@pytest.mark.parametrize("case", ["projection layout", "rect fold", "contiguous"])
def test_tma_rows_keeps_a_gradient_the_maps_read_in_place(case):
    """A (B, F, H, N, D) output gradient in the projection layout, its
    flash_rect fold and a contiguous one: the backward reads each in
    place, no copy."""
    b, f, h, n, d = 1, 3, 2, 64, 40
    g = torch.zeros(b, f, n, h, d, dtype=torch.bfloat16).transpose(2, 3)
    view = {"projection layout": g,
            "rect fold": g.transpose(1, 2).reshape(b, h, f * n, d)[:, None],
            "contiguous": g.contiguous()}[case]
    assert _tma_rows(view) is view


@pytest.mark.parametrize("case", ["expanded scalar", "broadcast frames", "base off 16 bytes",
                                  "stride off 16 bytes", "head-dim stride 2"])
def test_tma_rows_copies_a_gradient_the_maps_cannot_read(case):
    """What autograd may hand the backward and a TMA map cannot step: every
    stride 0 (the gradient of ``out.sum()``), one frame broadcast over the
    frame axis, a contiguous tensor whose base is 2 bytes off 16, a slice of
    a wider tensor (token stride 44 elements, 88 bytes), a head-dim stride
    of 2. Each comes back as a contiguous copy that the maps read, with the
    same values."""
    b, f, h, n, d = 1, 3, 2, 64, 40
    shape = (b, f, h, n, d)
    gen = torch.Generator().manual_seed(0)
    view = {
        "expanded scalar": torch.ones((), dtype=torch.bfloat16).expand(shape),
        "broadcast frames": torch.randn(b, 1, h, n, d, generator=gen).bfloat16().expand(shape),
        "base off 16 bytes": _strided(shape, (f * h * n * d, h * n * d, n * d, d, 1), 1),
        "stride off 16 bytes": torch.randn(b, f, h, n, d + 4, generator=gen).bfloat16()[..., :d],
        "head-dim stride 2": torch.randn(b, f, h, n, 2 * d, generator=gen).bfloat16()[..., ::2],
    }[case]
    out = _tma_rows(view)
    assert out is not view and out.is_contiguous()
    check_tma_operand("copy", out)
    torch.testing.assert_close(out, view, rtol=0, atol=0)


@pytest.mark.parametrize("blocks, rows, sms, split", [
    (256, 32768, 132, 1),   # null-text 64² site: B1 H8, Lk 4096 -> 256 key blocks
    (64, 8192, 132, 2),     # null-text 32² site: Lk 1024 -> 64 key blocks
    (256, 32768, 1000, 2),  # a larger card splits the 64² site too
    (16, 3000, 132, 8),     # capped at the portable cluster size
    (6, 1665, 132, 8),
    (72, 2200, 132, 1),     # 2 * 72 > 132
    (1, 200, 132, 2),       # at most one CTA per 64 query rows
    (1, 64, 132, 1),
])
def test_dkv_split_fills_one_wave(blocks, rows, sms, split):
    assert dkv_split(blocks, rows, sms) == split


def test_parse_ptxas_reads_registers_smem_and_spills():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelILi48EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi48EEvv
    24 bytes stack frame, 24 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 24 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Function properties for _Z5otherv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 20480 bytes smem, 400 bytes cmem[0]
"""
    assert _build.parse_ptxas(log) == [
        {"kernel": "_Z6kernelILi48EEvv", "registers": 128, "smem_bytes": 0,
         "spill_stores": 24, "spill_loads": 28, "stack_bytes": 24},
        {"kernel": "_Z5otherv", "registers": 40, "smem_bytes": 20480,
         "spill_stores": 0, "spill_loads": 0, "stack_bytes": 0}]
