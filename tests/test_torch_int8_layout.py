"""The storage of the port's int8 weights, on the CPU.

The int8 kernel's tensor-core product takes the weight K-major, so every
int8 matrix that `quant.linear` reads is stored K-major: the reference's
`(K, N)` shape and values, as the `.mT` view of the first K columns of a
contiguous `(N, K_pad)` tensor, K_pad = ceil(K / 16) * 16 (strides `(1,
K_pad)`: the kernel's TMA reads rows a multiple of 16 bytes apart; the
tail is zeros), one copy. Stacked expert weights (dequantized
by `models.moe._w`, never read by the kernel) and fp8 weights keep the
row-major layout. Values are compared with the reference's bit for bit;
layouts by strides.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro.quant import quantize_tree as jquantize_tree
from repro.quant import quantize_weight as jquantize_weight
from repro_torch.configs import reduced
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref
from repro_torch.models import init_params
from repro_torch.quant import k_major, quantize_tree, quantize_weight
from repro_torch.weights import params_from_jax, to_torch


def _k_pad(K):
    return -(-K // 16) * 16

ARCHS = ["llama31-8b", "qwen3-30b-a3b", "jamba-v0.1-52b"]


def _leaves(tree, path=()):
    """(path, {"q", "scale"} dict) for every quantized weight of a tree."""
    if isinstance(tree, dict):
        if "q" in tree and "scale" in tree:
            yield path, tree
            return
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))


def _check_layout(tree, mode):
    """int8 matrices K-major; stacked int8 and fp8 weights row-major.
    Returns how many of each it saw."""
    seen = {"k_major": 0, "row_major": 0}
    for path, leaf in _leaves(tree):
        q = leaf["q"]
        if mode == "int8" and q.ndim == 2:
            K, N = q.shape
            assert q.stride() == (1, _k_pad(K)), path
            assert q.dtype == torch.int8, path
            seen["k_major"] += 1
            # one copy: the storage holds the padded rows' bytes
            assert q.untyped_storage().nbytes() == N * _k_pad(K), path
        else:
            assert q.is_contiguous(), path
            seen["row_major"] += 1
            # one copy: the storage holds exactly the matrix's bytes
            assert q.untyped_storage().nbytes() == \
                q.numel() * q.element_size()
    return seen


def _jax_params(arch, seed=1):
    return jax_init_params(jax.random.PRNGKey(seed),
                           jax_reduced(arch, vocab=1024))


@pytest.mark.parametrize("shape", [(64, 96), (256, 384), (272, 136),
                                   (1365, 1024), (1024, 1365), (4, 128)])
def test_quantize_weight_stores_int8_matrix_k_major(shape):
    """The (K, N) matrix keeps its shape and the reference's values, bit
    for bit, stored K-major in one copy."""
    rng = np.random.default_rng(5)
    w = (rng.normal(size=shape) * 0.02).astype(np.float32)
    wj = jax.numpy.asarray(w, jax.numpy.bfloat16)
    port = quantize_weight(to_torch(np.asarray(wj)), "int8")
    ref = to_torch(np.asarray(jquantize_weight(wj, "int8")["q"]))
    K, N = shape
    assert port["q"].shape == (K, N)
    assert port["q"].stride() == (1, _k_pad(K))
    assert torch.equal(port["q"], ref)


@pytest.mark.parametrize("mode,shape", [("int8", (3, 128, 48)),
                                        ("fp8", (64, 96)),
                                        ("fp8", (3, 128, 48))])
def test_quantize_weight_keeps_stacked_and_fp8_row_major(mode, shape):
    w = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    q = quantize_weight((w * 0.02).bfloat16(), mode)["q"]
    assert q.shape == shape and q.is_contiguous()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_tree_layout_and_values(arch, mode):
    """quantize_tree on the converted bf16 tree: int8 matrices K-major,
    experts and fp8 row-major, values those of the reference's
    quantize_tree."""
    cfg = reduced(arch, vocab=1024)
    jp = _jax_params(arch)
    port = quantize_tree(params_from_jax(jax.tree.map(np.asarray, jp), cfg),
                         mode)
    ref = params_from_jax(jax.tree.map(np.asarray, jquantize_tree(jp, mode)),
                          cfg)
    seen = _check_layout(port, mode)
    assert seen == _check_layout(ref, mode)
    pairs = list(zip(_leaves(port), _leaves(ref)))
    assert len(pairs) == sum(seen.values())
    for (path, a), (path_r, b) in pairs:
        assert path == path_r
        qa, qb = a["q"], b["q"]
        if qa.dtype == torch.float8_e4m3fn:
            qa, qb = qa.view(torch.uint8), qb.view(torch.uint8)
        assert torch.equal(qa, qb), path
        assert torch.equal(a["scale"], b["scale"]), path
    if mode == "int8":
        assert seen["k_major"] > 0
        # only the MoE experts stay row-major under int8
        assert seen["row_major"] == sum(
            1 for path, _ in _leaves(port) if str(path[-1]).startswith(
                "experts_"))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_stores_reference_int8_k_major(arch):
    """The reference's (K, N) int8 leaves arrive K-major (its stacked
    experts row-major), with its values bit for bit."""
    cfg = reduced(arch, vocab=1024)
    jq = jquantize_tree(_jax_params(arch), "int8")
    tp = params_from_jax(jax.tree.map(np.asarray, jq), cfg)
    _check_layout(tp, "int8")
    head = tp["lm_head"]["q"]
    assert head.stride() == (1, _k_pad(cfg.d_model))
    assert torch.equal(head, to_torch(np.asarray(jq["lm_head"]["q"])))
    # layer 0 is repeat 0 of unit position 0
    ref0 = jax.tree.map(lambda a: np.asarray(a)[0], jq["blocks"][0])
    pairs = list(zip(_leaves(tp["layers"][0]), _leaves(ref0)))
    assert pairs
    for (path, a), (path_r, b) in pairs:
        assert path == path_r
        assert torch.equal(a["q"], to_torch(b["q"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_int8_layout(arch):
    """init_params quantizes as it draws: the same layouts."""
    cfg = reduced(arch, vocab=1024)
    params = init_params(cfg, device="cpu", quant="int8",
                         generator=torch.Generator().manual_seed(0))
    seen = _check_layout(params, "int8")
    assert seen["k_major"] > 0


@pytest.mark.parametrize("M,K,N", [(1, 272, 136), (8, 256, 384),
                                   (300, 512, 64), (8, 1365, 1024)])
def test_int8_plain_equal_on_both_layouts(M, K, N):
    """The plain version reads strides: the same result, bit for bit, on
    the row-major and the K-major weight."""
    rng = np.random.default_rng(6)
    xq = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    xs = torch.tensor([0.013])
    ws = torch.from_numpy(rng.uniform(0.001, 0.02, (1, N)).astype(np.float32))
    wk = k_major(wq)
    assert wk.stride() == (1, _k_pad(K)) and torch.equal(wk, wq)
    assert k_major(wk).data_ptr() == wk.data_ptr()     # no second copy
    assert torch.equal(int8_matmul_ref(xq, wk, xs, ws),
                       int8_matmul_ref(xq, wq, xs, ws))
