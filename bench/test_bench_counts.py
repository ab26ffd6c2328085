"""Each operation and byte counter against a hand count at small shapes."""
import dataclasses

import numpy as np
import pytest

from bench.clock import Call
from bench.counts import HBM, PEAK_BF16, PEAK_INT8
from bench.counts import flash_attention, int8_matmul, model, \
    paged_attention


@dataclasses.dataclass(frozen=True)
class Moe:
    num_experts: int = 4
    top_k: int = 2
    expert_ff: int = 8


@dataclasses.dataclass(frozen=True)
class Cfg:
    num_layers: int = 2
    d_model: int = 16
    num_heads: int = 4
    num_kv_heads: int = 2
    resolved_head_dim: int = 4
    d_ff: int = 32
    vocab_size: int = 10
    mlp_kind: str = "swiglu"
    tie_embeddings: bool = False
    moe: object = None


def test_int8_matmul_counts():
    # (2 x 3) @ (3 x 5): 2*2*3*5 ops; x 6 + w 15 + fp32 out 40 + scales 24
    assert int8_matmul.ops(2, 3, 5) == 60
    assert int8_matmul.nbytes(2, 3, 5) == 6 + 15 + 40 + 20 + 4
    big = (4096, 4096, 14336)
    assert int8_matmul.bound_s(*big) == int8_matmul.ops(*big) / PEAK_INT8
    small = (8, 4096, 14336)
    assert int8_matmul.bound_s(*small) == int8_matmul.nbytes(*small) / HBM


def test_int8_launches_per_call():
    cfg = Cfg(moe=Moe())
    pre = Call("prefill", 0, 0, tokens=np.zeros((8, 64), np.int32))
    dec = Call("decode", 0, 0, tokens=np.zeros(8, np.int32))
    # MoE: 4 projections a layer + the lm_head
    assert len(int8_matmul.launches(cfg, pre, 8)) == 2 * 4 + 1
    assert int8_matmul.launches(cfg, pre, 8)[0] == (512, 16, 16)
    assert int8_matmul.launches(cfg, pre, 8)[1] == (512, 16, 8)
    assert int8_matmul.launches(cfg, pre, 8)[-1] == (8, 16, 10)
    assert int8_matmul.launches(cfg, dec, 8)[3] == (8, 16, 16)
    dense = Cfg(mlp_kind="relu2")
    assert len(int8_matmul.launches(dense, dec, 8)) == 2 * 6 + 1
    assert int8_matmul.launches(dense, dec, 8)[4] == (8, 16, 32)


def test_paged_attention_counts():
    cfg = Cfg()
    # slot lengths 3 and 0 (idle): K+V 2*3*2*4*2 = 96 bytes; q and out
    # 2*2*4*4*2 = 128 bytes; QK+PV 4*4*4*3 = 192 ops
    b = paged_attention.bound_s(cfg, np.array([3, 0]))
    assert b == max(192 / PEAK_BF16, (96 + 128) / HBM)


def test_flash_attention_counts():
    cfg = Cfg()
    # L = 3: 4 * 4 * 4 * 6 ops; bytes 2 * 3 * (8 + 4) * 4
    assert flash_attention.ops(cfg, 3) == 384
    assert flash_attention.nbytes(cfg, 3) == 288
    assert flash_attention.bound_s(cfg, [3, 3]) == max(
        768 / PEAK_BF16, 576 / HBM)


@pytest.mark.parametrize("moe", [None, Moe()])
def test_model_flops(moe):
    cfg = Cfg(moe=moe)
    d, hd = 16, 4
    attn = d * (4 + 4) * hd + 4 * hd * d
    ff = (2 * 3 * d * 8 + d * 4) if moe else 3 * d * 32
    assert model.active_params(cfg) == 2 * (attn + ff)
    pre = Call("prefill", 0, 0, tokens=np.zeros((2, 64), np.int32),
               lens=np.array([3, 5]), mask=np.array([True, False]),
               context=np.zeros(2, np.int64))
    # 3 useful tokens; causal attention over 1+2+3 keys; one lm_head row
    want = 2 * model.active_params(cfg) * 3 + 4 * 4 * 4 * 2 * 6 \
        + 2 * 16 * 10
    assert model.call_flops(cfg, pre) == want
    dec = Call("decode", 0, 0, tokens=np.zeros(2, np.int32),
               mask=np.array([True, True]), context=np.array([3, 9]))
    want = 2 * model.active_params(cfg) * 2 + 4 * 4 * 4 * 2 * (4 + 10) \
        + 2 * 16 * 10 * 2
    assert model.call_flops(cfg, dec) == want
