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
Shapes use the (head_dim, query heads per KV head) the kernels are
compiled for: 128 with 4 or 8 (llama31-8b, qwen3-30b-a3b), 1
(codeqwen1.5-7b), 6 (nemotron-4-15b) or 48 (granite-34b), and 64 with 2
(granite-moe-1b-a400m); flash attention takes any group.

The int8 matmul is held to its plain version exactly: the int32 sums do
not depend on their order, and the one conversion and the one multiply by
the scales are the same on both sides. Its weights are stored K-major, as
the model stores them (`repro_torch.quant.k_major`). Dropping the last
128-wide K tile must break that equality.

The int8 experts' grouped GEMM is held to its plain version (the einsum
on `quant.dequantize`'s weights) by `bf16_gate <= 1`: the same bf16
products summed in fp32 in another order. Its weights are held bit for
bit: x rows that are one-hot in k read the weight's k-rows exactly.
Dropping the last 64-deep K tile, or shifting one expert's scales by a
column, must fail the gate.

The selective scan is held to its plain version by `fp32_gate <= 1`, that
is |kernel - plain| <= 1e-5 + 1e-4 |plain| on every element of y and
h_final: the same fp32 recurrence, but the kernel takes exp as ex2.approx
of dt * (A log2 e), updates h with one FMA and sums over N in another
order. Running the decode step with h0 read as zeros, or a prefill without
its last chunk of time steps, must fail it. Its prefill grid must fit the
card in one wave at jamba-v0.1-52b's served shape.

The 8-bit AdamW update is held to its plain version bit for bit (p, the
moments' codes and scales after 3 updates): both round every operation
alike, the fused multiply-adds included. Leaving the last block of each
row un-re-encoded must break that equality.
"""
import pytest
import torch

import torch.nn.functional as F

from repro_torch.kernels import bf16_gate, fp32_gate
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.int8_matmul.kernel import (int8_matmul_kernel,
                                                    pad_rows)
from repro_torch.kernels.int8_matmul.ops import int8_matmul
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref
from repro_torch.kernels.moe_gemm.kernel import moe_gemm_kernel
from repro_torch.kernels.moe_gemm.ops import moe_gemm
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
from repro_torch.kernels.paged_attention.kernel import paged_attention_kernel
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.ssm_scan.kernel import layout, ssm_scan_kernel
from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.quant import (BY_NAME, act_scale, dequantize, k_major,
                               linear, quantize_weight)
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


# (Hq, Hkv, D) of the served heads added for codeqwen1.5-7b,
# nemotron-4-15b, granite-34b and granite-moe-1b-a400m, qwen2-vl-7b's G 7
# (28 query heads on 4 KV heads) and llama4-maverick-400b-a17b's G 5 (40
# on 8)
NEW_HEADS = [(32, 32, 128), (48, 8, 128), (48, 1, 128), (16, 8, 64),
             (28, 4, 128), (40, 8, 128)]


@pytest.mark.parametrize("Hq,Hkv,D", NEW_HEADS)
@pytest.mark.parametrize("lens,idle", [
    (EDGE_LENS, 0), (SERVED_LENS, 0), ([0] * 4 + SERVED_LENS[4:], 4)])
def test_paged_kernel_new_heads_at_edges_and_served_mix(gen, Hq, Hkv, D,
                                                        lens, idle):
    """Each new instantiation at the served shape (8 slots, page 16, 48
    pages), at edge lengths and at a served decode mix, also with slots 0-3
    idle; a seq_len-0 row is the mean of V over its block-table row."""
    q, kp, vp, bt = _paged_inputs(gen, 8, Hq, Hkv, D, 16, 48)
    bt[:idle] = 0
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    n = paged_attention_kernel.launches
    out = paged_attention(q, kp, vp, bt, lens)
    torch.cuda.synchronize()
    assert paged_attention_kernel.launches == n + 1
    assert bf16_gate(out, paged_attention_ref(q, kp, vp, bt, lens)) <= 1
    for b in range(8):
        if lens[b] == 0:
            assert bf16_gate(out[b], _mean_v(vp, bt[b], Hq)) <= 1


@pytest.mark.parametrize("Hq,Hkv,D", NEW_HEADS)
def test_paged_kernel_new_heads_replay_in_a_cuda_graph(gen, Hq, Hkv, D):
    """As `test_paged_kernel_replays_in_a_cuda_graph`, for each new
    instantiation."""
    q, kp, vp, bt = _paged_inputs(gen, 8, Hq, Hkv, D, 16, 48)
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


@pytest.mark.parametrize("Hq,Hkv,D", NEW_HEADS)
def test_gate_rejects_new_paged_kernels_without_last_page(gen, Hq, Hkv, D):
    """Each new instantiation run on one page less than its plain version
    fails the gate."""
    q, kp, vp, bt = _paged_inputs(gen, 8, Hq, Hkv, D, 16, 48)
    lens = torch.full((8,), 768, dtype=torch.int32, device="cuda")
    short = lens.clone()
    short[-1] -= 16
    out = paged_attention(q, kp, vp, bt, short)
    assert bf16_gate(out, paged_attention_ref(q, kp, vp, bt, lens)) > 1


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,causal", [
    (8, 512, 512, 16, 8, True),        # granite-moe-1b-a400m's prefill
    (2, 192, 192, 4, 1, True),         # MQA, not a multiple of 128
    (1, 100, 37, 4, 2, False),         # ragged edges
    (1, 70, 130, 4, 4, True),          # Sq != Sk, top-left mask
    (3, 1, 1, 4, 1, True),             # one row, one key
])
def test_flash_kernel_head_dim_64_matches_plain(gen, B, Sq, Sk, Hq, Hkv,
                                                causal):
    q = _randn(gen, B, Sq, Hq, 64)
    k, v = _randn(gen, B, Sk, Hkv, 64), _randn(gen, B, Sk, Hkv, 64)
    n = flash_attention_kernel.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == n + 1
    assert bf16_gate(out, flash_attention_ref(q, k, v, causal=causal)) <= 1


@pytest.mark.parametrize("lens", [[512, 0, 1, 63, 64, 300, 511, 37],
                                  [512] * 4 + [0] * 4])   # a served mix
def test_flash_kernel_head_dim_64_kv_len_matches_plain(gen, lens):
    """granite-moe-1b-a400m's prefill heads (16/8, head_dim 64) with the
    padding mask, a kv_len-0 sequence the mean of V."""
    q = _randn(gen, 8, 512, 16, 64)
    k, v = _randn(gen, 8, 512, 8, 64), _randn(gen, 8, 512, 8, 64)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out = flash_attention(q, k, v, causal=True, kv_len=kv_len)
    ref = flash_attention_ref(q, k, v, causal=True, kv_len=kv_len)
    assert bf16_gate(out, ref) <= 1


@pytest.mark.parametrize("Hq,Hkv", [(32, 32), (48, 8), (48, 1), (40, 8)])
def test_flash_kernel_at_new_groups(gen, Hq, Hkv):
    """Head_dim 128 at the groups of codeqwen1.5-7b (1), nemotron-4-15b (6),
    granite-34b (48) and llama4-maverick-400b-a17b (5), a served prefill
    of 8 x 512: the same kernel."""
    q = _randn(gen, 8, 512, Hq, 128)
    k, v = _randn(gen, 8, 512, Hkv, 128), _randn(gen, 8, 512, Hkv, 128)
    out = flash_attention(q, k, v, causal=True)
    assert bf16_gate(out, flash_attention_ref(q, k, v, causal=True)) <= 1


@pytest.mark.parametrize("B,Sq", [(8, 1500), (8, 448), (8, 1)])
def test_flash_kernel_bidirectional_at_whisper_shapes(gen, B, Sq):
    """whisper-base's attention without a mask (8 heads of 64 on 8 KV
    heads, 1500 audio frames: 23 key tiles of 64 and a last one of 28): the
    encoder's self-attention (Sq 1500), the decoder's cross-attention over
    the frames (Sq 448) and one decode row. Counted among the launches
    without a mask."""
    q = _randn(gen, B, Sq, 8, 64)
    k, v = _randn(gen, B, 1500, 8, 64), _randn(gen, B, 1500, 8, 64)
    n = flash_attention_kernel.launches
    m = flash_attention_kernel.noncausal_launches
    out = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == n + 1
    assert flash_attention_kernel.noncausal_launches == m + 1
    assert bf16_gate(out, flash_attention_ref(q, k, v, causal=False)) <= 1


def test_gate_rejects_bidirectional_flash_without_last_key_tile(gen):
    """Without a mask every row reads every key: dropping the last key
    tile of 1500 frames (the 28 past 1472) fails the gate."""
    q = _randn(gen, 8, 1500, 8, 64)
    k, v = _randn(gen, 8, 1500, 8, 64), _randn(gen, 8, 1500, 8, 64)
    out = flash_attention(q, k[:, :1472].contiguous(),
                          v[:, :1472].contiguous(), causal=False)
    assert bf16_gate(out, flash_attention_ref(q, k, v, causal=False)) > 1


def test_gate_rejects_flash_kernel_head_dim_64_without_last_key_tile(gen):
    q = _randn(gen, 8, 512, 16, 64)
    k, v = _randn(gen, 8, 512, 8, 64), _randn(gen, 8, 512, 8, 64)
    out = flash_attention(q, k[:, :-64].contiguous(), v[:, :-64].contiguous(),
                          causal=True)
    assert bf16_gate(out, flash_attention_ref(q, k, v, causal=True)) > 1


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
    with pytest.raises(ValueError):       # head_dim 96 is not compiled
        flash_attention(q[..., :96].contiguous(), q[..., :96].contiguous(),
                        q[..., :96].contiguous())
    kp = _randn(gen, 4, 8, 1, 128)
    bt = torch.zeros(1, 2, dtype=torch.int32, device="cuda")
    lens = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        paged_attention(_randn(gen, 1, 4, 128), kp, kp, bt.long(), lens)
    with pytest.raises(ValueError):       # 3 query heads per KV head
        paged_attention(_randn(gen, 1, 3, 128), kp, kp, bt, lens)
    kp96 = _randn(gen, 4, 8, 1, 96)       # head_dim 96 is not compiled
    with pytest.raises(ValueError):
        paged_attention(_randn(gen, 1, 4, 96), kp96, kp96, bt, lens)
    with pytest.raises(ValueError, match="aligned"):
        paged_attention(_misaligned(_randn(gen, 1, 4, 128)), kp, kp, bt, lens)


def _int8_inputs(gen, M, K, N):
    """x_q (M, K) (its rows padded to a multiple of 16 bytes where K is
    not one, as `linear` pads them: `pad_rows`), the weight (K, N) stored
    K-major as the model stores it (`k_major`), and the scales."""
    xq = pad_rows(torch.randint(-127, 128, (M, K), generator=gen,
                                device="cuda", dtype=torch.int8))
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


@pytest.mark.parametrize("M,K,N", [(8, 6144, 256000), (8, 6144, 128),
                                   (8, 13440, 4096), (8, 5120, 202048),
                                   (8, 5120, 1024)])
def test_int8_kernel_at_new_served_shapes(gen, M, K, N):
    """nemotron-4-15b's lm_head (vocab 256000, the widest N), granite-34b's
    wk/wv at N 128 (one KV head), codeqwen1.5-7b's down projection (K
    13440) and llama4-maverick-400b-a17b's lm_head (vocab 202048) and wk/wv
    (N 1024) at decode: bit for bit."""
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


# xlstm-350m's sLSTM projections: down (K 1365 = int(4/3 * 1024), N 1024)
# and up (K 1024, N 1365)
XLSTM_SHAPES = [(1365, 1024), (1024, 1365)]


@pytest.mark.parametrize("M", [1, 8, 17, 64, 65, 4096])
@pytest.mark.parametrize("K,N", XLSTM_SHAPES + [(17, 3), (1, 1)])
def test_int8_kernel_any_k_and_n(gen, M, K, N):
    """K and N that are no multiple of 16 or 8 (xlstm-350m's sLSTM
    projections, and the smallest), on the decode and prefill paths, on
    the padded rows that `k_major` and `pad_rows` give: bit for bit; the
    output is the (M, N) view of rows padded to a multiple of 4 floats."""
    args = _int8_inputs(gen, M, K, N)
    assert args[1].stride() == (1, -(-K // 16) * 16)
    n = int8_matmul_kernel.launches
    out = int8_matmul(*args)
    torch.cuda.synchronize()
    assert int8_matmul_kernel.launches == n + 1
    assert out.shape == (M, N) and out.stride()[1] == 1
    assert torch.equal(out, int8_matmul_ref(*args))


@pytest.mark.parametrize("M", [8, 4096])
def test_int8_exact_check_rejects_dropped_k_tail(gen, M):
    """At K 1365 the kernel run without the ragged tail (the 5 codes past
    1360, as a K rounded down to a multiple of 16 would give) is not equal
    to the full plain product."""
    xq, wq, xs, ws = _int8_inputs(gen, M, 1365, 1024)
    out = int8_matmul(xq[:, :1360], wq[:1360], xs, ws)
    ref = int8_matmul_ref(xq, wq, xs, ws)
    assert float((out != ref).float().mean()) > 0.9


@pytest.mark.parametrize("K,N", XLSTM_SHAPES)
def test_int8_linear_at_ragged_shapes_equals_cpu(gen, K, N):
    """The int8 `linear` on a bf16 activation (8 x 512 rows, a prefill)
    with a weight quantized on the CPU: the card's output equals the
    CPU's bit for bit."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(8, 512, K, generator=g).bfloat16()
    w = quantize_weight((torch.randn(K, N, generator=g) * 0.02).bfloat16(),
                        "int8")
    card_w = {"q": k_major(w["q"].cuda()), "scale": w["scale"].cuda()}
    out = linear(x.cuda(), card_w, BY_NAME["int8"]).cpu()
    ref = linear(x, w, BY_NAME["int8"])
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))


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
    with pytest.raises(ValueError):       # x_q's rows 250 bytes apart
        int8_matmul(xq[:, :250].contiguous(), k_major(wq[:250]), xs, ws)
    with pytest.raises(ValueError):       # a row-major (K, N) weight
        int8_matmul(xq, wq.contiguous(), xs, ws)
    with pytest.raises(ValueError):       # K-major rows 250 bytes apart
        wt = torch.zeros(128, 250, dtype=torch.int8, device="cuda")
        int8_matmul(xq[:, :248].contiguous(), wt[:, :248].mT, xs, ws)
    with pytest.raises(ValueError):       # K-major rows shorter than K
        int8_matmul(xq, wq.as_strided((256, 128), (1, 128)), xs, ws)
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


# ---------------------------------------------------------------------------
# the fused 8-bit AdamW update: bit for bit against its plain version
# ---------------------------------------------------------------------------

HYPER = dict(lr=3e-3, b1=0.9, b2=0.999, eps=1e-8)


def _adamw8bit_leaf(gen, shape, p_dtype):
    from repro_torch.kernels.adamw8bit.ref import num_blocks
    p = (torch.randn(*shape, generator=gen, device="cuda") * 0.02).to(
        p_dtype)
    nb = num_blocks(shape[-1])
    zq = lambda: torch.zeros(shape, dtype=torch.int8, device="cuda")
    zs = lambda: torch.full(shape[:-1] + (nb,), 1e-12, device="cuda")
    return [p, zq(), zs(), zq(), zs()]


def _adamw8bit_steps(gen, state, fn, g_dtype, steps, clip, wd, seed=1):
    """`steps` updates of `state` (p, codes and scales, in place) by `fn`,
    on gradients drawn from `seed` (the same for every caller)."""
    g_gen = torch.Generator(device="cuda").manual_seed(seed)
    for t in range(1, steps + 1):
        g = (torch.randn(state[0].shape, generator=g_gen, device="cuda")
             * 10.0 ** (-t)).to(g_dtype)
        tt = torch.tensor(float(t), device="cuda")
        bc1 = 1 - torch.pow(torch.tensor(0.9, device="cuda"), tt)
        bc2 = 1 - torch.pow(torch.tensor(0.999, device="cuda"), tt)
        scale = None if clip is None else torch.tensor(clip, device="cuda")
        fn(g, *state, bc1, bc2, scale, weight_decay=wd, **HYPER)


@pytest.mark.parametrize("shape,p_dtype,g_dtype,clip,wd", [
    ((4096,), torch.bfloat16, torch.bfloat16, None, 0.0),  # a norm scale
    ((1024, 1365), torch.bfloat16, torch.bfloat16, 0.37, 0.0),  # ragged
    ((512, 4096), torch.bfloat16, torch.float32, 0.37, 0.1),    # accumulated
    ((3, 7, 300), torch.bfloat16, torch.bfloat16, None, 0.1),
    ((64, 1000), torch.bfloat16, torch.float32, 0.5, 0.0),
])
def test_adamw8bit_kernel_equals_plain_bit_for_bit(gen, shape, p_dtype,
                                                   g_dtype, clip, wd):
    from repro_torch.kernels.adamw8bit.kernel import adamw8bit_kernel
    from repro_torch.kernels.adamw8bit.ops import adamw8bit_update
    from repro_torch.kernels.adamw8bit.ref import adamw8bit_update_ref
    got = _adamw8bit_leaf(gen, shape, p_dtype)
    want = [t.clone() for t in got]
    n = adamw8bit_kernel.launches
    _adamw8bit_steps(gen, got, adamw8bit_update, g_dtype, 3, clip, wd)
    torch.cuda.synchronize()
    assert adamw8bit_kernel.launches == n + 3
    _adamw8bit_steps(gen, want, adamw8bit_update_ref, g_dtype, 3, clip, wd)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
    assert not torch.equal(got[1], torch.zeros_like(got[1]))


def test_adamw8bit_rejects_a_block_left_unencoded(gen):
    from repro_torch.kernels.adamw8bit.kernel import adamw8bit_kernel
    from repro_torch.kernels.adamw8bit.ref import adamw8bit_update_ref
    got = _adamw8bit_leaf(gen, (256, 1365), torch.bfloat16)
    want = [t.clone() for t in got]
    adamw8bit_kernel.skip_last_block = True
    try:
        _adamw8bit_steps(gen, got, adamw8bit_kernel, torch.bfloat16, 3,
                         None, 0.0)
    finally:
        adamw8bit_kernel.skip_last_block = False
    _adamw8bit_steps(gen, want, adamw8bit_update_ref, torch.bfloat16, 3,
                     None, 0.0)
    assert not torch.equal(got[1], want[1])
    assert not torch.equal(got[2], want[2])
    # the other blocks of each row (the last starts at 5 * 256) are intact
    for a, b in zip(got[:2] + got[3:4], want[:2] + want[3:4]):
        assert torch.equal(a[:, :1280], b[:, :1280])
    assert torch.equal(got[2][:, :5], want[2][:, :5])


def test_adamw8bit_library_fuses_only_what_the_source_asks(gen):
    # every fp32 product, sum, quotient and square root rounded on its own
    # (`.rn`), the fused multiply-adds being the four the source writes
    from repro_torch.kernels import build
    f32 = {k: v for k, v in build.ptx_opcodes("adamw8bit").items()
           if k.endswith(".f32")}
    for op in ("mul.rn", "add.rn", "div.rn", "sqrt.rn", "fma.rn"):
        assert f32.get(f"{op}.f32"), (op, f32)
    assert not [k for k in f32 if k.split(".")[0] == "mad"
                or (k.split(".")[0] in ("mul", "add", "sub", "fma", "div",
                                        "sqrt") and ".rn." not in k)], f32


def test_adamw8bit_wrapper_refuses_what_the_kernel_does_not_take(gen):
    from repro_torch.kernels.adamw8bit.kernel import adamw8bit_kernel
    p, mq, ms, vq, vs = _adamw8bit_leaf(gen, (8, 300), torch.bfloat16)
    one = torch.ones((), device="cuda")
    g = torch.zeros_like(p)
    with pytest.raises(ValueError, match="one CUDA device"):
        adamw8bit_kernel(g.cpu(), p, mq, ms, vq, vs, one, one, **HYPER)
    with pytest.raises(TypeError, match="int8"):
        adamw8bit_kernel(g, p, mq.float(), ms, vq, vs, one, one, **HYPER)
    with pytest.raises(TypeError, match="p bf16"):      # no fp32 p
        adamw8bit_kernel(g.float(), p.float(), mq, ms, vq, vs, one, one,
                         **HYPER)
    with pytest.raises(ValueError, match="shapes"):
        adamw8bit_kernel(g, p, mq, ms[:, :1].contiguous(), vq, vs, one, one,
                         **HYPER)
    with pytest.raises(ValueError, match="contiguous"):
        adamw8bit_kernel(g.t(), p.t(), mq.t(), ms, vq.t(), vs, one, one,
                         **HYPER)
    with pytest.raises(ValueError, match="blocks of 256"):
        adamw8bit_kernel(g, p, mq, ms, vq, vs, one, one, block=128, **HYPER)


def _moe_inputs(gen, E, M, K, N):
    """x (E, M, K) bf16, int8 expert codes (E, K, N) row-major, as
    `quant.quantize_weight` stores a stack, and their (E, 1, N) scales."""
    q = torch.randint(-127, 128, (E, K, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    sc = torch.rand(E, 1, N, generator=gen, device="cuda") * 0.02 + 1e-4
    return _randn(gen, E, M, K), q, sc


@pytest.mark.parametrize("E,M,K,N", [
    (8, 3, 4096, 14336),               # mixtral-8x7b decode up/gate
    (8, 3, 14336, 4096),               # mixtral-8x7b decode down
    (16, 2, 4096, 14336),              # jamba-v0.1-52b decode
    (128, 1, 5120, 8192),              # llama4-maverick decode
    (128, 48, 5120, 1024),             # llama4-maverick prefill rows
    (128, 8, 2048, 768),               # qwen3-30b-a3b decode
    (32, 8, 1024, 512),                # granite-moe-1b-a400m decode
    (2, 1280, 4096, 1024),             # a prefill expert, 5 row tiles
    (4, 17, 272, 384),                 # ragged rows and K
    (3, 200, 272, 384),                # one 256-row tile
    (3, 320, 272, 384),                # 128-row tiles, a half block
])
def test_moe_gemm_kernel_equals_plain(gen, E, M, K, N):
    x, q, sc = _moe_inputs(gen, E, M, K, N)
    n = moe_gemm_kernel.launches
    out = moe_gemm(x, q, sc)
    torch.cuda.synchronize()
    assert moe_gemm_kernel.launches == n + 1
    assert out.shape == (E, M, N) and out.dtype == torch.bfloat16
    assert bf16_gate(out, moe_gemm_ref(x, q, sc)) <= 1


@pytest.mark.parametrize("M", [8, 40, 256, 320])
def test_moe_gemm_weights_equal_dequantize_bit_for_bit(gen, M):
    """One-hot rows of x read k-rows of the weight: the kernel's weights
    are `dequantize`'s to the bit, codes +-127 and scales spread over 14
    decades included (8 and 40 rows on the decode path; 256 rows on the prefill's
    256-row tiles, 320 on its 128-row ones)."""
    E, K, N = 2, 384, 384
    _, q, sc = _moe_inputs(gen, E, 1, K, N)
    q[:, :, :6] = torch.tensor([127, -127, 0, 1, -1, 64], dtype=torch.int8,
                               device="cuda")
    sc = sc * torch.logspace(-8, 6, N, device="cuda")
    ks = torch.randperm(K, generator=gen, device="cuda")[:M]
    x = torch.zeros(E, M, K, dtype=torch.bfloat16, device="cuda")
    x[:, torch.arange(M, device="cuda"), ks] = 1
    out = moe_gemm_kernel(x, q, sc)
    assert torch.equal(out.view(torch.int16),
                       dequantize(q, sc)[:, ks].view(torch.int16))


@pytest.mark.parametrize("M", [3, 160])
def test_moe_gemm_gate_rejects_planted_faults(gen, M):
    E, K, N = 4, 1024, 512
    x, q, sc = _moe_inputs(gen, E, M, K, N)
    ref = moe_gemm_ref(x, q, sc)
    dropped = moe_gemm_kernel(x[..., :K - 64].contiguous(),
                              q[:, :K - 64].contiguous(), sc)
    assert bf16_gate(dropped, ref) > 1
    shifted = sc.clone()
    shifted[1] = torch.roll(sc[1], 1, dims=-1)
    assert bf16_gate(moe_gemm_kernel(x, q, shifted), ref) > 1


def test_moe_gemm_wrapper_refuses_what_the_kernel_does_not_take(gen):
    x, q, sc = _moe_inputs(gen, 2, 3, 256, 384)
    with pytest.raises(ValueError, match="one CUDA device"):
        moe_gemm_kernel(x.cpu(), q, sc)
    with pytest.raises(TypeError, match="x bf16"):
        moe_gemm_kernel(x.float(), q, sc)
    with pytest.raises(TypeError, match="x bf16"):
        moe_gemm_kernel(x, q.to(torch.float8_e4m3fn), sc)
    with pytest.raises(TypeError, match="x bf16"):
        moe_gemm_kernel(x, q, sc.bfloat16())
    with pytest.raises(ValueError, match="shapes"):
        moe_gemm_kernel(x, q[:, :128].contiguous(), sc)
    with pytest.raises(ValueError, match="shapes"):
        moe_gemm_kernel(x, q, sc[:, :, :128].contiguous())
    with pytest.raises(ValueError, match="multiple of 128"):
        moe_gemm_kernel(x, q[..., :320].contiguous(),
                        sc[..., :320].contiguous())
    with pytest.raises(ValueError, match="multiple of 128"):
        moe_gemm_kernel(x[..., :250].contiguous(), q[:, :250].contiguous(),
                        sc)
    with pytest.raises(ValueError, match="contiguous"):
        moe_gemm_kernel(x, q.transpose(1, 2).contiguous().transpose(1, 2),
                        sc)
    with pytest.raises(ValueError, match="contiguous"):
        moe_gemm_kernel(x.transpose(0, 1).contiguous().transpose(0, 1), q,
                        sc)
    with pytest.raises(ValueError, match="aligned"):
        moe_gemm_kernel(_misaligned(x), q, sc)
