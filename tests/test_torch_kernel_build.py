"""CPU tests of what surrounds the Hopper kernels of videop2p_tpu_torch: the
TMA-eligibility check of the bf16 attention kernels
(``ops/attention.py:check_tma_operand``), the build digest that covers the
headers a source includes, and the reading of ptxas's resource report
(``ops/_build.py``). No card and no nvcc needed."""

import os
import shutil

import pytest
import torch

from videop2p_tpu_torch.ops import _build
from videop2p_tpu_torch.ops.attention import check_tma_operand


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
