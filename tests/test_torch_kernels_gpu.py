"""The CUDA kernels against their plain versions on the card.

Run on a machine with an H100 (``pytest -m gpu tests/test_torch_kernels_gpu.py``);
without a CUDA device every test skips.  Whether there is a device is decided
in the ``cuda`` fixture, never at import, so every pytest-xdist worker
collects the same tests.  float32 to 1e-4 (the kernel sums in another order
and uses the device ``exp``), bfloat16 to 3e-2."""
import pytest
import torch

from repro_torch.kernels import decode_attention as kdecode
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ref

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kh,hd,causal,window", [
    (8, 256, 256, 32, 8, 64, True, 0),      # llama3.2-1b prefill
    (1, 500, 500, 32, 8, 64, True, 0),      # ragged bulk prefill
    (2, 256, 256, 14, 2, 64, True, 0),      # qwen2-0.5b, G = 7
    (1, 512, 512, 8, 2, 64, True, 128),     # sliding window
    (2, 64, 256, 4, 4, 32, False, 0),       # non-causal, Sq != Sk
    (3, 128, 128, 3, 3, 16, True, 0),
    (1, 512, 512, 1, 1, 128, True, 0),
])
def test_flash_kernel_matches_plain(cuda, dtype, b, sq, sk, h, kh, hd,
                                    causal, window):
    q = _randn((b, sq, h, hd), dtype, cuda, 1)
    k = _randn((b, sk, kh, hd), dtype, cuda, 2)
    v = _randn((b, sk, kh, hd), dtype, cuda, 3)
    n = kflash.launches.count
    out = kflash.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert kflash.launches.count == n + 1
    want = ref.grouped_flash_ref(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype
    assert (out.float() - want.float()).abs().max().item() < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kh,hd,lengths", [
    (8, 1024, 32, 8, 64, [700] * 8),                      # llama decode
    (8, 1024, 32, 8, 64, [1, 63, 64, 65, 300, 700, 1000, 1024]),
    (4, 512, 14, 2, 64, [500, 17, 512, 256]),             # qwen, G = 7
    (6, 512, 1, 1, 64, [1, 86, 171, 256, 341, 426]),      # (BH, 1, D) form
    (2, 2048, 1, 1, 128, [1, 1025]),
    (8, 256, 1, 1, 32, [1, 33, 65, 97, 129, 161, 193, 225]),
])
def test_decode_kernel_matches_plain(cuda, dtype, b, s, h, kh, hd, lengths):
    q = _randn((b, 1, h, hd), dtype, cuda, 4)
    k = _randn((b, s, kh, hd), dtype, cuda, 5)
    v = _randn((b, s, kh, hd), dtype, cuda, 6)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    n = kdecode.launches.count
    out = kdecode.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert kdecode.launches.count == n + 1
    want = ref.grouped_decode_ref(q, k, v, lens)
    assert (out.float() - want.float()).abs().max().item() < TOL[dtype]


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros((1, 8, 4, 48), device=cuda)             # hd 48
    with pytest.raises(ValueError, match="head dim"):
        kflash.flash_attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros((1, 1, 4, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        kdecode.decode_attention(q, q, q, torch.ones(1, dtype=torch.int32,
                                                     device=cuda))
