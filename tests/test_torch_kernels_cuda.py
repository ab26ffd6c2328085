"""The CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with a card (this file imports no JAX, and the repo's
conftest does, so skip it):

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py

Without a card every test here skips. The gate is `bf16_gate <= 1`, that
is |kernel - plain| <= 1e-3 + 2**-7 |plain| on every element: both sides
compute in fp32 and round once to bf16, so they may differ by one bf16
step of the result. A paged-attention row with seq_len 0 gets the mean of
V over every position its block-table row gathers. The planted-fault
tests show that it rejects a kernel that drops one page or one key tile.
Shapes use head_dim 128, the one the kernels are compiled for, and paged
attention 4 or 8 query heads per KV head (llama31-8b, qwen3-30b-a3b).

The int8 matmul is held to its plain version exactly: the int32 sums do
not depend on their order, and the one conversion and the one multiply by
the scales are the same on both sides. Its weights are stored K-major, as
the model stores them (`repro_torch.quant.k_major`). Dropping the last
128-wide K tile must break that equality.

The selective scan is held to its plain version by `fp32_gate <= 1`, that
is |kernel - plain| <= 1e-5 + 1e-4 |plain| on every element of y and
h_final: the same fp32 recurrence, but the kernel takes exp as ex2.approx
of dt * (A log2 e), updates h with one FMA and sums over N in another
order. Running the decode step with h0 read as zeros, or a prefill without
its last chunk of time steps, must fail it. Its prefill grid must fit the
card in one wave at jamba-v0.1-52b's served shape.
"""
import pytest
import torch

import torch.nn.functional as F

from repro_torch.kernels import bf16_gate, fp32_gate
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.int8_matmul.kernel import int8_matmul_kernel
from repro_torch.kernels.int8_matmul.ops import int8_matmul
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref
from repro_torch.kernels.paged_attention.kernel import paged_attention_kernel
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.ssm_scan.kernel import layout, ssm_scan_kernel
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.quant import (BY_NAME, act_scale, k_major, linear,
                               quantize_weight)
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
    assert bf16_gate(out[0], _mean_v(vp, bt[0], Hq)) <= 1
    assert bf16_gate(out, ref) <= 1


def _mean_v(vp, bt_row, Hq):
    """What a seq_len-0 row gets: the mean of V over every position its
    block-table row gathers, in fp32, for each of the Hq query heads."""
    P, page, Hkv, D = vp.shape
    m = vp[bt_row.long()].float().reshape(-1, Hkv, D).mean(0)
    return m.repeat_interleave(Hq // Hkv, dim=0)


# (B 8, Hq 32, page 16, max_pages 48): with 8 splits a 768-token row gives
# each split 6 pages; 128 tokens give each split one page, ending on its
# last position; 96 leave two splits empty, 16 and 5 all splits but one;
# and 0, 1, 17, 767
EDGE_LENS = [1, 128, 16, 768, 0, 96, 17, 767]
# a served decode step: 8 slots with contexts of 520-768 tokens
SERVED_LENS = [520, 555, 591, 626, 662, 697, 733, 768]


@pytest.mark.parametrize("Hkv", [8, 4])
@pytest.mark.parametrize("lens,idle", [
    (EDGE_LENS, 0), ([5] + EDGE_LENS[1:], 0), (SERVED_LENS, 0),
    ([0] * 4 + SERVED_LENS[4:], 4)])
def test_paged_kernel_at_edges_and_served_mix(gen, Hkv, lens, idle):
    """The served shape at edge lengths and at a served decode mix; with
    `idle`, the first slots are idle as the engine leaves them: seq_len 0
    and a block-table row of 0s, so they read page 0 only."""
    q, kp, vp, bt = _paged_inputs(gen, 8, 32, Hkv, 128, 16, 48)
    bt[:idle] = 0
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out = paged_attention(q, kp, vp, bt, lens)
    torch.cuda.synchronize()
    assert bf16_gate(out, paged_attention_ref(q, kp, vp, bt, lens)) <= 1
    for b in range(8):
        if lens[b] == 0:
            assert bf16_gate(out[b], _mean_v(vp, bt[b], 32)) <= 1


def test_paged_kernel_replays_in_a_cuda_graph(gen):
    """Captured once, replayed after seq_lens (and q) changed in place:
    the grid depends on the shapes only, so the replay follows the new
    lengths, including a row that becomes idle and one that grows."""
    q, kp, vp, bt = _paged_inputs(gen, 8, 32, 8, 128, 16, 48)
    lens = torch.tensor(SERVED_LENS, dtype=torch.int32, device="cuda")
    run = lambda: paged_attention(q, kp, vp, bt, lens)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = run()
    q.copy_(_randn(gen, *q.shape))
    lens.copy_(torch.tensor([0, 1, 16, 17, 256, 512, 700, 768],
                            dtype=torch.int32))
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, run())
    assert bf16_gate(out, paged_attention_ref(q, kp, vp, bt, lens)) <= 1


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
    (2, 64, 64, 4, 2, 128, True),      # half a 128-row Q tile, half a K tile
    (3, 1, 1, 4, 1, 128, True),        # one row, one key
    (1, 192, 192, 8, 2, 128, False),   # a half-empty last tile, full mask
    (1, 130, 70, 4, 2, 128, True),     # rows past Sk see every key
    (8, 576, 576, 32, 4, 128, True),   # G = 8 at the served 576
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


@pytest.mark.parametrize("lens", [[512, 0, 1, 63, 64, 300, 511, 37],
                                  [0, 0], [5, 130],
                                  [512] * 4 + [0] * 4])   # a served mix
def test_flash_kernel_kv_len_matches_plain(gen, lens):
    """The prefill's padding mask: keys at or past kv_len[b] masked; a
    sequence with kv_len 0 gets the mean of V over all keys."""
    B, S = len(lens), max(lens) or 64
    q = _randn(gen, B, S, 32, 128)
    k, v = _randn(gen, B, S, 8, 128), _randn(gen, B, S, 8, 128)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out = flash_attention(q, k, v, causal=True, kv_len=kv_len)
    ref = flash_attention_ref(q, k, v, causal=True, kv_len=kv_len)
    assert bf16_gate(out, ref) <= 1


def test_flash_kernel_clips_kv_len_to_sk(gen):
    """kv_len past Sk masks nothing: the result is the unmasked one."""
    q = _randn(gen, 3, 200, 8, 128)
    k, v = _randn(gen, 3, 200, 2, 128), _randn(gen, 3, 200, 2, 128)
    kv_len = torch.tensor([200, 201, 5000], dtype=torch.int32, device="cuda")
    out = flash_attention(q, k, v, causal=True, kv_len=kv_len)
    assert bf16_gate(out, flash_attention_ref(q, k, v, causal=True)) <= 1
    assert torch.equal(out, flash_attention(q, k, v, causal=True))


def test_flash_kernel_replays_in_a_cuda_graph(gen):
    """Captured once, replayed after its inputs were overwritten in place:
    the result is the eager one on the new data (the tensor maps are
    kernel parameters, built at capture from the same addresses)."""
    q = _randn(gen, 2, 320, 8, 128)
    k, v = _randn(gen, 2, 320, 4, 128), _randn(gen, 2, 320, 4, 128)
    kv_len = torch.tensor([320, 77], dtype=torch.int32, device="cuda")
    run = lambda: flash_attention(q, k, v, causal=True, kv_len=kv_len)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = run()
    for t in (q, k, v):
        t.copy_(_randn(gen, *t.shape))
    kv_len.copy_(torch.tensor([0, 250], dtype=torch.int32))
    g.replay()
    torch.cuda.synchronize()
    eager = run()
    assert torch.equal(out, eager)
    ref = flash_attention_ref(q, k, v, causal=True, kv_len=kv_len)
    assert bf16_gate(out, ref) <= 1


def _misaligned(t):
    """A contiguous copy of `t` that starts 2 bytes into its storage."""
    m = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return m.view(t.shape).copy_(t)


def test_flash_wrapper_refuses_a_misaligned_view(gen):
    """TMA needs 16-byte aligned bases: a contiguous view 2 bytes into its
    storage raises, whichever of q, k and v it is; the wrapper never
    copies it."""
    q = _randn(gen, 1, 64, 4, 128)
    k, v = _randn(gen, 1, 64, 2, 128), _randn(gen, 1, 64, 2, 128)
    for i in range(3):
        args = [q, k, v]
        args[i] = _misaligned(args[i])
        assert args[i].is_contiguous() and args[i].data_ptr() % 16
        with pytest.raises(ValueError, match="aligned"):
            flash_attention(*args)


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
    with pytest.raises(ValueError, match="aligned"):
        paged_attention(_misaligned(_randn(gen, 1, 4, 128)), kp, kp, bt, lens)


def _int8_inputs(gen, M, K, N):
    """x_q (M, K), the weight (K, N) stored K-major as the model stores it
    (`k_major`), and the scales."""
    xq = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                       dtype=torch.int8)
    wq = k_major(torch.randint(-127, 128, (K, N), generator=gen,
                               device="cuda", dtype=torch.int8))
    xs = torch.rand(1, generator=gen, device="cuda") * 0.02 + 1e-3
    ws = torch.rand(1, N, generator=gen, device="cuda") * 0.02 + 1e-3
    return xq, wq, xs, ws


@pytest.mark.parametrize("M", [1, 8, 17, 64, 65, 512, 4096])
@pytest.mark.parametrize("K,N", [(4096, 14336), (14336, 4096), (2048, 512),
                                 (4096, 2048)])
def test_int8_kernel_equals_plain(gen, M, K, N):
    """Ragged M (1, 8, 17 and 64 rows on the decode path, 65 on the
    prefill path; 512 and 4096, the prefill rows) at served (K, N) of
    llama31-8b and qwen3-30b-a3b: bit for bit."""
    args = _int8_inputs(gen, M, K, N)
    n = int8_matmul_kernel.launches
    out = int8_matmul(*args)
    torch.cuda.synchronize()
    assert int8_matmul_kernel.launches == n + 1
    assert out.dtype == torch.float32 and out.shape == (M, N)
    assert torch.equal(out, int8_matmul_ref(*args))


@pytest.mark.parametrize("M,K,N", [(8, 4096, 32000)])
def test_int8_kernel_at_lm_head_shape(gen, M, K, N):
    """mixtral-8x7b's lm_head at decode (vocab 32000, 500 tiles of 64
    columns): bit for bit."""
    args = _int8_inputs(gen, M, K, N)
    assert torch.equal(int8_matmul(*args), int8_matmul_ref(*args))


@pytest.mark.parametrize("K,N", [(272, 136), (8192, 288)])
def test_int8_kernel_ragged_k_and_n(gen, K, N):
    """K and N that are not multiples of the tiles (K 16 past a 128-byte
    k-tile, N 8 past a 64 or 128 tile; jamba's x_proj N 288) on both
    paths."""
    for M in (5, 64, 300):
        args = _int8_inputs(gen, M, K, N)
        assert torch.equal(int8_matmul(*args), int8_matmul_ref(*args))


@pytest.mark.parametrize("M,K,N", [(8, 14336, 4096), (8, 256, 8192),
                                   (33, 2048, 4096), (64, 8192, 288)])
def test_int8_kernel_split_k_equals_plain(gen, M, K, N):
    """Decode shapes whose N / 64 tiles under-fill the card split K over a
    cluster of blocks (llama31-8b's down projection, jamba's dt_proj); the
    int32 partial sums meet before the one conversion: bit for bit."""
    args = _int8_inputs(gen, M, K, N)
    assert torch.equal(int8_matmul(*args), int8_matmul_ref(*args))


@pytest.mark.parametrize("M", [8, 4096])
def test_int8_exact_check_rejects_dropped_k_tile(gen, M):
    """The kernel run without the last 128-wide K tile (a K-major (K - 128,
    N) weight that the wrapper takes), as a tile count off by one would
    give, is not equal to the full plain product."""
    xq, wq, xs, ws = _int8_inputs(gen, M, 4096, 14336)
    out = int8_matmul(xq[:, :-128].contiguous(), k_major(wq[:-128]), xs, ws)
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
        int8_matmul(xq[:, :250].contiguous(), k_major(wq[:250]), xs, ws)
    with pytest.raises(ValueError):       # a row-major (K, N) weight
        int8_matmul(xq, wq.contiguous(), xs, ws)
    with pytest.raises(ValueError):       # K-major rows longer than K
        int8_matmul(xq[:, :128].contiguous(), wq[:128], xs, ws)
    with pytest.raises(ValueError):       # one operand on the CPU
        int8_matmul(xq, wq.cpu(), xs, ws)


def _amax_inputs(amax):
    """A bf16 activation (8, 4096) and weight (4096, 1024), made on the CPU,
    whose largest magnitude (the activation's, and the weight's in channel
    7) is exactly `amax`."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 4096, generator=g).clamp(-1, 1).bfloat16()
    x[3, 17] = -amax
    w = (torch.randn(4096, 1024, generator=g) * 0.02).bfloat16()
    w[5, 7] = amax
    return x, w


@pytest.mark.parametrize("amax", [1.125, 3.25])
def test_int8_scales_and_linear_equal_on_card_and_cpu(gen, amax):
    """At an amax where amax / 127 and amax * fl32(1/127) are one float32
    step apart, the activation scale, the weight scales and codes, and the
    int8 `linear` (weights quantized on the CPU) are bit for bit the same
    on the card as on the CPU."""
    x, w = _amax_inputs(amax)
    apart = []
    xs = act_scale(x.float()), act_scale(x.cuda().float()).cpu()
    if not torch.equal(*xs):
        apart.append(f"activation scale {[v.item().hex() for v in xs]}")
    qw = quantize_weight(w, "int8"), quantize_weight(w.cuda(), "int8")
    for key in ("scale", "q"):
        on_cpu, on_card = qw[0][key], qw[1][key].cpu()
        if not torch.equal(on_cpu, on_card):
            n = int((on_cpu != on_card).sum())
            apart.append(f"weight {key}: {n} of {on_cpu.numel()} apart")
    card_w = {"q": k_major(qw[0]["q"].cuda()), "scale": qw[0]["scale"].cuda()}
    out = linear(x.cuda(), card_w, BY_NAME["int8"]).cpu()
    ref = linear(x, qw[0], BY_NAME["int8"])
    if not torch.equal(out.view(torch.int16), ref.view(torch.int16)):
        n = int((out.view(torch.int16) != ref.view(torch.int16)).sum())
        apart.append(f"linear: {n} of {ref.numel()} outputs apart")
    assert not apart, "; ".join(apart)


def _ssm_inputs(gen, B, S, di, N, with_h0):
    r = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    A = -torch.arange(1, N + 1, dtype=torch.float32, device="cuda") \
        .expand(di, N).contiguous()
    return (r(B, S, di), F.softplus(r(B, S, di)), r(B, S, N), r(B, S, N), A,
            r(di), r(B, di, N) if with_h0 else None)


@pytest.mark.parametrize("S", [1, 37, 64, 320, 512])
@pytest.mark.parametrize("di", [1024, 8192])
def test_ssm_kernel_matches_plain(gen, S, di):
    """The served N = 16 with a random h0: S 1 (decode), 37 (not a
    multiple of the kernel's chunk), 64, 320 (a multiple of 64 but not of
    the Pallas kernel's 256-step chunk) and 512; d_inner 1024 (the
    small-input model's) and 8192 (jamba's)."""
    args = _ssm_inputs(gen, 8, S, di, 16, True)
    n = ssm_scan_kernel.launches
    y, h = ssm_scan(*args)
    torch.cuda.synchronize()
    assert ssm_scan_kernel.launches == n + 1
    yr, hr = ssm_scan_ref(*args)
    assert fp32_gate(y, yr) <= 1 and fp32_gate(h, hr) <= 1


@pytest.mark.parametrize("B,S,di,N,with_h0", [
    (1, 37, 100, 4, True),       # ragged S and di, reduced()'s d_state
    (3, 70, 1000, 4, False),     # zero state, not read
    (2, 33, 130, 16, True),
    (2, 100, 8200, 16, True),    # di % 4 == 0, not a multiple of 128
    (2, 45, 8200, 4, False),
    (3, 1, 130, 4, False),       # decode: ragged di, no h0
    (3, 1, 1000, 16, True),
])
def test_ssm_kernel_ragged_and_small_state(gen, B, S, di, N, with_h0):
    args = _ssm_inputs(gen, B, S, di, N, with_h0)
    y, h = ssm_scan(*args)
    yr, hr = ssm_scan_ref(*args)
    assert fp32_gate(y, yr) <= 1 and fp32_gate(h, hr) <= 1


@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("with_h0", [True, False])
def test_ssm_decode_variant_at_served_shape(gen, N, with_h0):
    """S 1 at jamba's B 8, d_inner 8192: the decode kernel, one launch."""
    args = _ssm_inputs(gen, 8, 1, 8192, N, with_h0)
    n = ssm_scan_kernel.launches
    y, h = ssm_scan(*args)
    torch.cuda.synchronize()
    assert ssm_scan_kernel.launches == n + 1
    yr, hr = ssm_scan_ref(*args)
    assert fp32_gate(y, yr) <= 1 and fp32_gate(h, hr) <= 1


@pytest.mark.parametrize("N", [4, 16])
@pytest.mark.parametrize("with_h0", [True, False])
def test_ssm_kernel_empty_sequence(gen, N, with_h0):
    """S 0: no y, and h_final is h0 (or the zero state), one launch."""
    args = _ssm_inputs(gen, 3, 0, 200, N, with_h0)
    n = ssm_scan_kernel.launches
    y, h = ssm_scan(*args)
    torch.cuda.synchronize()
    assert ssm_scan_kernel.launches == n + 1
    assert y.shape == (3, 0, 200)
    assert torch.equal(h, args[-1] if with_h0 else torch.zeros_like(h))


@pytest.mark.parametrize("S", [1, 50])
def test_ssm_kernel_takes_unaligned_operands(gen, S):
    """u, dt, B and C as contiguous views one float into their storage:
    the prefill kernel then copies 4 bytes at a time."""
    def shifted(t):
        flat = torch.empty(t.numel() + 1, device="cuda")
        flat[1:] = t.flatten()
        return flat[1:].view(t.shape)
    args = list(_ssm_inputs(gen, 2, S, 1024, 16, True))
    args[:4] = [shifted(t) for t in args[:4]]
    assert all(t.data_ptr() % 16 for t in args[:4])
    y, h = ssm_scan(*args)
    yr, hr = ssm_scan_ref(*args)
    assert fp32_gate(y, yr) <= 1 and fp32_gate(h, hr) <= 1


@pytest.mark.parametrize("S", [1, 512])
def test_ssm_kernel_replays_in_a_cuda_graph(gen, S):
    """The decode kernel (S 1) and the prefill kernel, captured once and
    replayed after their inputs changed in place."""
    args = _ssm_inputs(gen, 8, S, 8192, 16, True)
    run = lambda: ssm_scan(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y, h = run()
    for t, new in zip(args, _ssm_inputs(gen, 8, S, 8192, 16, True)):
        t.copy_(new)
    g.replay()
    torch.cuda.synchronize()
    y2, h2 = run()
    assert torch.equal(y, y2) and torch.equal(h, h2)
    yr, hr = ssm_scan_ref(*args)
    assert fp32_gate(y, yr) <= 1 and fp32_gate(h, hr) <= 1


@pytest.mark.parametrize("N", [4, 16])
def test_ssm_prefill_grid_fits_one_wave(gen, N):
    """Every block runs the whole sequence, so the served grid (B 8,
    d_inner 8192) must be resident at once."""
    lay = layout(N)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = 8 * -(-8192 // lay["channels_per_block"])
    assert lay["resident_blocks_per_sm"] * sms >= blocks, lay


def test_fp32_gate_rejects_scan_without_carried_state(gen):
    """The decode step run with h0 read as zeros, as a scan that drops the
    carried state would, fails the gate."""
    args = _ssm_inputs(gen, 8, 1, 8192, 16, True)
    y, _ = ssm_scan(*args[:-1], None)
    assert fp32_gate(y, ssm_scan_ref(*args)[0]) > 1


def test_fp32_gate_rejects_scan_without_last_chunk(gen):
    """At prefill from a zero state: the kernel run on all but the last
    chunk of time steps (the kernel's own chunk length), as a dropped last
    ring stage would give, leaves an h_final that fails the gate."""
    args = _ssm_inputs(gen, 8, 512, 8192, 16, False)
    chunk = layout(16)["chunk"]
    cut = [t[:, :-chunk].contiguous() for t in args[:4]]
    _, h = ssm_scan(*cut, *args[4:])
    assert fp32_gate(h, ssm_scan_ref(*args)[1]) > 1


def test_ssm_wrapper_refuses_what_the_kernel_does_not_take(gen):
    args = list(_ssm_inputs(gen, 2, 8, 64, 16, True))
    with pytest.raises(TypeError):
        ssm_scan(args[0].bfloat16(), *args[1:])
    with pytest.raises(ValueError):       # not contiguous
        ssm_scan(args[0].transpose(1, 2).contiguous().transpose(1, 2),
                 *args[1:])
    with pytest.raises(ValueError):       # d_state 12 is not compiled
        small = _ssm_inputs(gen, 2, 8, 64, 12, True)
        ssm_scan(*small)
    with pytest.raises(ValueError):       # one operand on the CPU
        ssm_scan(*args[:-1], args[-1].cpu())


# -- the fleet loop (float64 event loop, one thread a lane) -----------------
#
# Held to its plain version on the CPU, on the same packed inputs of mini
# plans and of the paper's 42-cell `paper_h100` grid: every integer output
# exactly, every float within the jit tolerance (the kernel has no FMA and
# divides in integers, so they should be equal bit for bit). Skipping the
# budget cut must break that.

def _fleet_inputs(plan_name):
    from repro_torch.experiments import get_plan
    from repro_torch.serving import fleet_jit
    from repro_torch.serving.arrivals import synth_arrays
    from repro_torch.serving.fleet import FleetPoint
    pts = [FleetPoint(engine=c.engine_spec(), arrivals=c.arrival_spec(),
                      warmup=c.warmup, horizon=c.horizon,
                      failure_times=c.failure_times, **c.record_kw())
           for c in get_plan(plan_name).cells]
    md, ec, r_arr, cap, *_ = fleet_jit._pack(
        pts, [synth_arrays(p.arrivals) for p in pts])
    return pts, md, ec, r_arr, cap


def _on(d, device):
    return {k: torch.as_tensor(v, device=device) for k, v in d.items()}


def _fleet_mismatch(got, ref, W):
    """Outputs (but the dump column W - 1) outside the jit tolerance, and
    float entries that are not bitwise equal."""
    from repro_torch.serving.precision import X64_TOLERANCE
    rtol, atol = X64_TOLERANCE
    bad, inexact = [], 0
    for k, r in ref.items():
        g = got[k].cpu()
        if r.ndim == 2:
            g, r = g[:, :W - 1], r[:, :W - 1]
        if r.dtype == torch.float64:
            inexact += int((g != r).sum())
            if not torch.allclose(g, r, rtol=rtol, atol=atol):
                bad.append(k)
        elif not torch.equal(g, r):
            bad.append(k)
    return bad, inexact


@pytest.mark.parametrize("plan_name", ["mini_2x2", "mini_crosshw",
                                       "mini_ensemble", "paper_h100"])
def test_fleet_loop_kernel_matches_plain(gen, plan_name):
    from repro_torch.kernels.fleet_loop.kernel import fleet_loop_kernel
    from repro_torch.kernels.fleet_loop.ops import fleet_loop
    from repro_torch.kernels.fleet_loop.ref import fleet_loop_ref
    _pts, md, ec, r_arr, cap = _fleet_inputs(plan_name)
    n = fleet_loop_kernel.launches
    got = fleet_loop(_on(md, "cuda"), _on(ec, "cuda"),
                     torch.as_tensor(r_arr, device="cuda"), cap)
    torch.cuda.synchronize()
    assert fleet_loop_kernel.launches == n + 1
    ref = fleet_loop_ref(_on(md, "cpu"), _on(ec, "cpu"),
                         torch.as_tensor(r_arr), cap)
    bad, inexact = _fleet_mismatch(got, ref, r_arr.shape[1])
    assert not bad and inexact == 0, (bad, inexact)
    assert not got["live"].any() and int(got["rounds"].max()) > 1


def test_fleet_loop_rejects_skipped_budget_cut(gen):
    from repro_torch.kernels.fleet_loop.kernel import fleet_loop_kernel
    from repro_torch.kernels.fleet_loop.ref import fleet_loop_ref
    _pts, md, ec, r_arr, cap = _fleet_inputs("paper_h100")
    fleet_loop_kernel.skip_budget_cut = True
    try:
        got = fleet_loop_kernel(_on(md, "cuda"), _on(ec, "cuda"),
                                torch.as_tensor(r_arr, device="cuda"), cap)
        torch.cuda.synchronize()
    finally:
        fleet_loop_kernel.skip_budget_cut = False
    ref = fleet_loop_ref(_on(md, "cpu"), _on(ec, "cpu"),
                         torch.as_tensor(r_arr), cap)
    bad, _ = _fleet_mismatch(got, ref, r_arr.shape[1])
    assert "t" in bad


def test_fleet_loop_library_holds_no_dfma(gen):
    # nothing contracted into a fused multiply-add: the PTX rounds every
    # float64 product, sum and quotient on its own (the DFMAs of the SASS
    # are ptxas's expansion of div.rn.f64, which rounds correctly)
    from repro_torch.kernels import build
    f64 = {k: v for k, v in build.ptx_opcodes("fleet_loop").items()
           if k.endswith(".f64")}
    assert f64.get("mul.rn.f64") and f64.get("add.rn.f64") \
        and f64.get("div.rn.f64"), f64
    assert not [k for k in f64 if k.split(".")[0] in ("fma", "mad")], f64
    assert not [k for k in f64 if k.split(".")[0] in ("mul", "add", "sub")
                and ".rn." not in k], f64


def test_jit_run_points_on_the_card_matches_numpy(gen):
    import dataclasses
    import math
    from repro_torch.serving import fleet_jit
    from repro_torch.serving.fleet import fleet_run_points
    from repro_torch.serving.precision import X64_TOLERANCE
    pts, *_ = _fleet_inputs("mini_crosshw")
    before = dict(fleet_jit.LANES)
    got = fleet_jit.jit_run_points(pts)
    assert fleet_jit.LANES["loop"] - before["loop"] == len(pts)
    assert fleet_jit.LANES["fallback"] == before["fallback"]
    for a, b in zip(fleet_run_points(pts), got):
        for k, va in dataclasses.asdict(a).items():
            vb = getattr(b, k)
            if isinstance(va, float) and not math.isnan(va):
                assert math.isclose(va, vb, rel_tol=X64_TOLERANCE[0],
                                    abs_tol=X64_TOLERANCE[1]), (k, va, vb)
            else:
                assert repr(va) == repr(vb), (k, va, vb)


def test_jit_run_points_on_the_card_raises_where_the_loop_does_not_finish(
        gen, monkeypatch):
    from repro_torch.kernels.fleet_loop.kernel import fleet_loop_kernel
    from repro_torch.serving import fleet_jit
    pts, *_ = _fleet_inputs("mini_2x2")
    monkeypatch.setattr(fleet_jit, "_CAP_FLOOR", 1)
    monkeypatch.setattr(fleet_jit, "_CAP_PER_REQ", 0)
    before, n = dict(fleet_jit.LANES), fleet_loop_kernel.launches
    with pytest.raises(fleet_jit.JitFallback, match="did not converge"):
        fleet_jit.jit_run_points(pts)
    assert fleet_loop_kernel.launches == n + 1
    assert fleet_jit.LANES == before


def test_fleet_loop_wrapper_refuses_what_the_kernel_does_not_take(gen):
    from repro_torch.kernels.fleet_loop.kernel import fleet_loop_kernel
    _pts, md, ec, r_arr, cap = _fleet_inputs("mini_2x2")
    with pytest.raises(ValueError, match="one CUDA device"):
        fleet_loop_kernel(_on(md, "cuda"), _on(ec, "cuda"),
                          torch.as_tensor(r_arr), cap)
    with pytest.raises(TypeError, match="float64"):
        fleet_loop_kernel(_on(md, "cuda"), _on(ec, "cuda"),
                          torch.as_tensor(r_arr, device="cuda").float(),
                          cap)
    bad = dict(ec, uplen=ec["uplen"] * 0)
    with pytest.raises(ValueError, match="uplen"):
        fleet_loop_kernel(_on(md, "cuda"), _on(bad, "cuda"),
                          torch.as_tensor(r_arr, device="cuda"), cap)
