"""The CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with a card (this file imports no JAX, and the repo's
conftest does, so skip it):

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py

Without a card every test here skips. The gate is `bf16_gate <= 1`, that
is |kernel - plain| <= 1e-3 + 2**-7 |plain| on every element: both sides
compute in fp32 and round once to bf16, so they may differ by one bf16
step of the result. The planted-fault tests show that it rejects a kernel
that drops one page or one key tile. Shapes use head_dim 128, the one the
kernels are compiled for, and paged attention 4 or 8 query heads per KV
head (llama31-8b, qwen3-30b-a3b).

The int8 matmul is held to its plain version exactly: the int32 sums do
not depend on their order, and the one conversion and the one multiply by
the scales are the same on both sides. Dropping the last 128-wide K tile
must break that equality.
"""
import pytest
import torch

from repro_torch.kernels import bf16_gate
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.int8_matmul.kernel import int8_matmul_kernel
from repro_torch.kernels.int8_matmul.ops import int8_matmul
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref
from repro_torch.kernels.paged_attention.kernel import paged_attention_kernel
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.serving.runner import set_matmul_precision

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_matmul_precision()            # the plain versions' einsums in fp32
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda").bfloat16()


def _paged_inputs(gen, B, Hq, Hkv, D, page, maxp):
    P = B * maxp + 1
    q = _randn(gen, B, Hq, D)
    kp, vp = _randn(gen, P, page, Hkv, D), _randn(gen, P, page, Hkv, D)
    bt = (torch.randperm(P - 1, generator=gen, device="cuda") + 1).to(
        torch.int32).reshape(B, maxp)
    return q, kp, vp, bt


@pytest.mark.parametrize("B,Hq,Hkv,D,page,maxp", [
    (2, 8, 2, 128, 8, 4),
    (3, 4, 1, 128, 16, 3),
    (1, 16, 4, 128, 8, 6),
    (8, 32, 8, 128, 16, 48),           # the served shape, llama31-8b
    (2, 16, 2, 128, 8, 5),             # G = 8
    (8, 32, 4, 128, 16, 48),           # the served shape, qwen3-30b-a3b
])
def test_paged_kernel_matches_plain(gen, B, Hq, Hkv, D, page, maxp):
    q, kp, vp, bt = _paged_inputs(gen, B, Hq, Hkv, D, page, maxp)
    lens = torch.randint(0, page * maxp + 1, (B,), generator=gen,
                         device="cuda", dtype=torch.int32)
    lens[0] = 0
    n = paged_attention_kernel.launches
    out = paged_attention(q, kp, vp, bt, lens)
    torch.cuda.synchronize()
    assert paged_attention_kernel.launches == n + 1
    ref = paged_attention_ref(q, kp, vp, bt, lens)
    assert torch.all(out[0] == 0)
    assert bf16_gate(out, ref) <= 1


@pytest.mark.parametrize("Hkv", [8, 4])
def test_gate_rejects_paged_kernel_without_last_page(gen, Hkv):
    """The kernel run on one page less than its plain version, as a loop
    bound off by one page would give, fails the gate."""
    q, kp, vp, bt = _paged_inputs(gen, 8, 32, Hkv, 128, 16, 48)
    lens = torch.full((8,), 768, dtype=torch.int32, device="cuda")
    short = lens.clone()
    short[-1] -= 16
    out = paged_attention(q, kp, vp, bt, short)
    assert bf16_gate(out, paged_attention_ref(q, kp, vp, bt, lens)) > 1


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal", [
    (2, 256, 256, 4, 2, 128, True),
    (1, 128, 256, 8, 8, 128, False),
    (2, 256, 256, 4, 1, 128, True),    # MQA
    (2, 192, 192, 4, 2, 128, True),    # not a multiple of 128
    (1, 100, 37, 4, 2, 128, False),    # ragged edges
    (1, 70, 130, 4, 4, 128, True),     # Sq != Sk, top-left mask
    (8, 576, 576, 32, 8, 128, True),   # a served prefill shape
])
def test_flash_kernel_matches_plain(gen, B, Sq, Sk, Hq, Hkv, D, causal):
    q = _randn(gen, B, Sq, Hq, D)
    k, v = _randn(gen, B, Sk, Hkv, D), _randn(gen, B, Sk, Hkv, D)
    n = flash_attention_kernel.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == n + 1
    ref = flash_attention_ref(q, k, v, causal=causal)
    assert bf16_gate(out, ref) <= 1


def test_gate_rejects_flash_kernel_without_last_key_tile(gen):
    """The kernel run without the last 64 keys, as a tile count off by
    one would give, fails the gate."""
    q = _randn(gen, 8, 512, 32, 128)
    k, v = _randn(gen, 8, 512, 8, 128), _randn(gen, 8, 512, 8, 128)
    out = flash_attention(q, k[:, :-64].contiguous(), v[:, :-64].contiguous(),
                          causal=True)
    assert bf16_gate(out, flash_attention_ref(q, k, v, causal=True)) > 1


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = _randn(gen, 1, 64, 4, 128)
    with pytest.raises(TypeError):
        flash_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError):       # head_dim 64 is not compiled
        flash_attention(q[..., :64].contiguous(), q[..., :64].contiguous(),
                        q[..., :64].contiguous())
    kp = _randn(gen, 4, 8, 1, 128)
    bt = torch.zeros(1, 2, dtype=torch.int32, device="cuda")
    lens = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        paged_attention(_randn(gen, 1, 4, 128), kp, kp, bt.long(), lens)
    with pytest.raises(ValueError):       # 2 query heads per KV head
        paged_attention(_randn(gen, 1, 2, 128), kp, kp, bt, lens)


def _int8_inputs(gen, M, K, N):
    xq = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                       dtype=torch.int8)
    xs = torch.rand(1, generator=gen, device="cuda") * 0.02 + 1e-3
    ws = torch.rand(1, N, generator=gen, device="cuda") * 0.02 + 1e-3
    return xq, wq, xs, ws


@pytest.mark.parametrize("M", [1, 8, 17, 4096])
@pytest.mark.parametrize("K,N", [(4096, 14336), (14336, 4096), (2048, 512),
                                 (4096, 2048)])
def test_int8_kernel_equals_plain(gen, M, K, N):
    """Ragged M (1, 8 and 17 rows; 4096, the prefill rows) at served
    (K, N) of llama31-8b and qwen3-30b-a3b: bit for bit."""
    args = _int8_inputs(gen, M, K, N)
    n = int8_matmul_kernel.launches
    out = int8_matmul(*args)
    torch.cuda.synchronize()
    assert int8_matmul_kernel.launches == n + 1
    assert out.dtype == torch.float32 and out.shape == (M, N)
    assert torch.equal(out, int8_matmul_ref(*args))


def test_int8_kernel_ragged_k_and_n(gen):
    """K and N that are not multiples of the tiles (K 16 past a 256 tile,
    N 8 past a 128 tile), at both tile shapes."""
    for M in (5, 300):
        args = _int8_inputs(gen, M, 272, 136)
        assert torch.equal(int8_matmul(*args), int8_matmul_ref(*args))


def test_int8_exact_check_rejects_dropped_k_tile(gen):
    """The kernel run without the last 128-wide K tile, as a tile count
    off by one would give, is not equal to the full plain product."""
    xq, wq, xs, ws = _int8_inputs(gen, 8, 4096, 14336)
    out = int8_matmul(xq[:, :-128].contiguous(), wq[:-128], xs, ws)
    ref = int8_matmul_ref(xq, wq, xs, ws)
    assert not torch.equal(out, ref)
    assert float((out != ref).float().mean()) > 0.9


def test_int8_wrapper_refuses_what_the_kernel_does_not_take(gen):
    xq, wq, xs, ws = _int8_inputs(gen, 8, 256, 128)
    with pytest.raises(TypeError):
        int8_matmul(xq.float(), wq, xs, ws)
    with pytest.raises(TypeError):
        int8_matmul(xq, wq, xs.double(), ws)
    with pytest.raises(ValueError):       # K not a multiple of 16
        int8_matmul(xq[:, :250].contiguous(), wq[:250], xs, ws)
    with pytest.raises(ValueError):       # not contiguous
        int8_matmul(xq, wq.t().contiguous().t(), xs, ws)
    with pytest.raises(ValueError):       # one operand on the CPU
        int8_matmul(xq, wq.cpu(), xs, ws)
