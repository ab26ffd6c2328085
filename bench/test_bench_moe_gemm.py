"""The int8 experts' grouped GEMM's counter (`bench/counts/moe_gemm.py`)
against a hand count, its rows against the program's `apply_moe`, and
`moe_gemm_roofline.batch` on a synthetic trace: it reads the kernel's
launches by symbol, takes only calls whose launches match the count, and
reads nothing where the program has no such kernel."""
import dataclasses
import math
import types

import numpy as np

from bench import manifest as mf
from bench import trace as trace_lib
from bench.clock import Call
from bench.counts import HBM, PEAK_BF16, moe_gemm
from repro_torch.configs import get_config


@dataclasses.dataclass(frozen=True)
class Moe:
    num_experts: int = 4
    top_k: int = 2
    expert_ff: int = 8
    group_size: int = 256
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class Cfg:
    d_model: int = 16
    mlp_kind: str = "swiglu"
    moe: object = Moe()

    def moe_layer_mask(self):
        return (True, False, True)


def test_counts_by_hand():
    # 2 experts of (3 x 4) rows-by-K times (4 x 128): 2*2*3*4*128 ops;
    # int8 w 1024 + fp32 scales 1024 + bf16 x 48 and out 1536
    assert moe_gemm.ops(2, 3, 4, 128) == 6144
    assert moe_gemm.nbytes(2, 3, 4, 128) == 1024 + 1024 + 48 + 1536
    decode = (8, 3, 4096, 14336)          # mixtral's: bound by the weight
    assert moe_gemm.bound_s(*decode) == moe_gemm.nbytes(*decode) / HBM
    prefill = (8, 1280, 4096, 14336)      # by the tensor cores
    assert moe_gemm.bound_s(*prefill) == moe_gemm.ops(*prefill) / PEAK_BF16


def test_rows_are_apply_moes_capacity_rows():
    """mixtral-8x7b (256-token groups, 8 experts top-2): 3 rows at a
    decode step of 8 slots, 1280 at a prefill of 8 x 512; the others of
    the served MoE configurations as `chip_smoke.py` times them."""
    want = {"mixtral-8x7b": (3, 1280), "jamba-v0.1-52b": (2, 640),
            "llama4-maverick-400b-a17b": (1, 48),
            "qwen3-30b-a3b": (8, 320), "granite-moe-1b-a400m": (8, 1280)}
    for arch, rows in want.items():
        moe = get_config(arch).moe
        assert (moe_gemm.rows(moe, 8), moe_gemm.rows(moe, 4096)) == rows


def test_launches_per_call():
    cfg = Cfg()
    pre = Call("prefill", 0, 0, tokens=np.zeros((8, 64), np.int32))
    dec = Call("decode", 0, 0, tokens=np.zeros(8, np.int32))
    # up, gate and down of each of the two MoE layers
    rows = math.ceil(256 * 2 / 4 * 1.25)
    assert moe_gemm.launches(cfg, pre, 8) == [
        (4, 2 * rows, 16, 8), (4, 2 * rows, 16, 8), (4, 2 * rows, 8, 16)] * 2
    assert moe_gemm.launches(cfg, dec, 8)[2] == (4, 5, 8, 16)
    assert len(moe_gemm.launches(Cfg(mlp_kind="relu2"), dec, 8)) == 4
    assert moe_gemm.launches(Cfg(moe=None), dec, 8) == []


def _run(kernels, steps, ranges):
    t = trace_lib.Trace(kernels, ranges, 0.0, 10.0)
    t.steps = steps
    return types.SimpleNamespace(cfg=Cfg(), quant="int8", batch=8, trace=t)


def test_roofline_reads_matching_calls_by_symbol():
    read = mf.reader("moe_gemm_roofline.batch")
    dec = Call("decode", 0, 0, tokens=np.zeros(8, np.int32))
    shapes = moe_gemm.launches(Cfg(), dec, 8)
    bound = sum(moe_gemm.bound_s(*x) for x in shapes)
    sym = "void (anonymous namespace)::moe_w8_gemm_kernel<8>(CUtensorMap_st)"
    # call 1: every launch, each lasting 2 x the bound's share; call 2 one
    # launch short, left out; a cuBLAS gemm and an elementwise kernel not
    # read
    ks = [(0.1 + 0.01 * i, 0.1 + 0.01 * i + 2 * bound / len(shapes), sym)
          for i in range(len(shapes))]
    ks += [(5.1 + 0.01 * i, 5.2 + 0.01 * i, sym)
           for i in range(len(shapes) - 1)]
    ks += [(0.5, 0.9, "nvjet_tst_gemm"), (0.95, 0.99, "elementwise_kernel")]
    ranges = [(0.0, 4.0, "decode call"), (5.0, 9.0, "decode call")]
    run = _run(ks, [dec, dec], ranges)
    assert abs(read(run) - 50.0) < 1e-5
    assert trace_lib.group_of(sym) == "matmul"
    # the parent's program: no such kernel, nothing to read
    assert read(_run(ks[-2:], [dec, dec], ranges)) is None
