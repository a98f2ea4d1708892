"""The host side of the flash kernels (K4, K5) on the CPU: the argument
rules the wrappers enforce before a launch, the bf16 operands they hand
the kernels, and the reading of the build's ptxas report."""

import pytest
import torch

from multiview_inpaint_tpu_torch import kernels
from multiview_inpaint_tpu_torch.diffusion import flash_attention as fa


@pytest.mark.parametrize("t,hd,heads,dtype,ok", [
    (256, 128, 2, torch.bfloat16, True),
    (384, 48, 3, torch.float32, True),
    (192, 128, 2, torch.bfloat16, False),   # T not a multiple of 128
    (256, 80, 2, torch.bfloat16, False),    # head dim 40
    (256, 128, 2, torch.float16, False),    # neither bf16 nor f32
])
def test_check_takes_what_the_kernels_take(t, hd, heads, dtype, ok):
    q = torch.zeros((2, t, hd), dtype=dtype)
    if ok:
        assert fa._check("k", q, (q.clone(),), heads) == (2, t, hd,
                                                          hd // heads)
    else:
        with pytest.raises(ValueError):
            fa._check("k", q, (q.clone(),), heads)


def test_check_rejects_mismatched_operands():
    q = torch.zeros((1, 256, 64), dtype=torch.bfloat16)
    for other in (torch.zeros((1, 256, 64)), torch.zeros(
            (1, 128, 64), dtype=torch.bfloat16), torch.zeros(
            (1, 64, 256), dtype=torch.bfloat16).transpose(1, 2)):
        with pytest.raises(ValueError):
            fa._check("k", q, (other,), 1)


@pytest.mark.parametrize("offset,ok", [(0, True), (4, True), (1, False),
                                       (2, False)])
def test_backward_takes_only_16_byte_aligned_lse(offset, ok, monkeypatch):
    """K5 fetches lse rows with bulk copies, which need 16-byte aligned
    sources: a contiguous view at an offset of other than a multiple of 4
    floats is refused before any launch."""
    n, t, heads, d = 1, 128, 2, 16
    q = torch.zeros((n, t, heads * d), dtype=torch.bfloat16)
    lse = torch.zeros(n * heads * t + offset)[offset:].view(n * heads, t)

    class Launched(Exception):
        pass

    def library():
        raise Launched

    monkeypatch.setattr(fa._kernels, "library", library)
    with pytest.raises(Launched if ok else ValueError):
        fa._launch_bwd(q, q.clone(), q.clone(), q.clone(), lse, q.clone(),
                       heads, 1.0)


def test_kernel_operands_are_bf16_rounded_to_nearest_even():
    b = torch.randn(4, 8).to(torch.bfloat16)
    x = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -2.5])
    got_b, got_x = fa._bf16(b, x)
    assert got_b is b
    assert got_x.dtype == torch.bfloat16
    assert got_x.float().tolist() == [1.0, 1.0 + 2.0 ** -6, -2.5]


def test_ptxas_report_reads_registers_and_spills(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    assert kernels.ptxas_report("flash_attn_fwd.cu") == []
    (tmp_path / "flash_attn_fwd.ptxas.txt").write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z3fooILi64EEv' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _Z3fooILi64EEv\n"
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill "
        "loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 384 bytes "
        "cmem[0]\n"
        "ptxas info    : Function properties for _Z3helperv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'\n"
        "ptxas info    : Used 40 registers, used 1 barriers, 47140 bytes "
        "smem, 380 bytes cmem[0]\n")
    assert kernels.ptxas_report("flash_attn_fwd.cu") == [
        ("_Z3fooILi64EEv", 168, 8, 12, 0), ("_Z3barv", 40, 0, 0, 47140)]
