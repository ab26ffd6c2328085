"""whisper-base (encoder-decoder) and qwen2-vl-7b (M-RoPE, patches) in the
port against the reference, on the CPU.

M-RoPE is held at the full config's head_dim 128 with distinct t, h and
w positions, where the section boundary matters: the reference draws
each rotary channel's section with `jnp.digitize`, bins closed on the
left, so channel 32 of the 64 opens section 1; `torch.bucketize` agrees
only with `right=True`. With three equal rows, as text is served, every
section rotates alike and M-RoPE is plain RoPE.

The encoder runs the reference's parameters (converted by
`weights.params_from_jax`) on numpy-drawn frames: through the flash op's
plain version (as `prefill` runs it) and through the plain
`bidirectional_attention` (as `forward` runs it). Tolerances: f32 within
1e-5 of the output's largest magnitude (fp32 sums in another order); bf16
within 2**-6 (the reference rounds P to bf16 before P V where the flash
op keeps it in fp32; through `bidirectional_attention`, which rounds as
the reference does, 2**-7: one bf16 step).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.models import attention as jattn
from repro.models import decode_step as jdecode_step
from repro.models import encode as jencode
from repro.models import forward as jforward
from repro.models import init_params as jax_init_params
from repro.models import prefill as jprefill
from repro.quant import BY_NAME as JBY_NAME
from repro.quant import quantize_tree as jquantize_tree
from repro_torch.configs import get_config, reduced
from repro_torch.models import (decode_step, encode, forward, init_params,
                                prefill)
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.quant import BY_NAME, SKIP
from repro_torch.serving import runner as trunner
from repro_torch.weights import cache_from_jax, params_from_jax, to_torch


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(ref, port) -> float:
    ref = _np(ref)
    return float(np.abs(port.float().numpy() - ref).max()) / max(
        float(np.abs(ref).max()), 1e-30)


def _positions3(rng, B, S):
    """(3, B, S) distinct t, h and w positions, as an image's patches have
    them."""
    return rng.integers(0, 4096, (3, B, S)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_at_head_dim_128_with_distinct_positions(dtype):
    """qwen2-vl-7b's head_dim 128, theta 1e6, distinct t/h/w positions:
    within 1e-6 of the reference's largest magnitude in f32, one bf16 step
    in bf16 (the same fp32 rotation, rounded once)."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(2, 9, 4, 128)).astype(np.float32),
                    dtype)
    pos = _positions3(rng, 2, 9)
    theta = get_config("qwen2-vl-7b").rope_theta
    ref = jattn.apply_mrope(x, jnp.asarray(pos), theta)
    out = tattn.apply_mrope(to_torch(np.asarray(x)), torch.from_numpy(pos),
                            theta)
    assert out.dtype == to_torch(np.asarray(x)).dtype
    assert _rel(ref, out) <= (1e-6 if dtype == "float32" else 2 ** -7)


def test_mrope_sections_follow_digitize_not_default_bucketize():
    """Channels 0-31 rotate by t, 32-47 by h, 48-63 by w: channel 32 is
    in section 1, as `jnp.digitize` puts it; `torch.bucketize` without
    `right=True` would put it in section 0, which only distinct positions
    show."""
    sec = tattn.mrope_sections(64)
    chan = np.arange(64)
    np.testing.assert_array_equal(
        sec.numpy(), np.asarray(jnp.digitize(chan, jnp.array([32, 48]))))
    assert sec[31] == 0 and sec[32] == 1 and sec[47] == 1 and sec[48] == 2
    assert torch.bucketize(torch.tensor(32), torch.tensor([32, 48])) == 0
    rng = np.random.default_rng(1)
    x = torch.randn(1, 3, 2, 128, generator=torch.Generator().manual_seed(0))
    pos = torch.from_numpy(_positions3(rng, 1, 3))
    wrong = pos[torch.bucketize(torch.arange(64), torch.tensor([32, 48]))]
    assert not torch.equal(wrong, pos[sec])
    assert not torch.equal(tattn.apply_mrope(x, pos, 1e6)[..., 32],
                           tattn.apply_rope(x, pos[0], 1e6)[..., 32])


def test_mrope_with_equal_rows_is_rope():
    """Three equal position rows (text, as served): M-RoPE is RoPE."""
    x = torch.randn(2, 5, 3, 128, generator=torch.Generator().manual_seed(2))
    pos = torch.arange(5, dtype=torch.int32)[None].expand(2, 5) + 7
    assert torch.equal(tattn.apply_mrope(x, pos[None].expand(3, 2, 5), 1e6),
                       tattn.apply_rope(x, pos, 1e6))
    p3 = tattn.positions_for("mrope", 2, 5)
    np.testing.assert_array_equal(
        p3.numpy(), np.asarray(jattn.positions_for("mrope", 2, 5)))
    assert p3.shape == (3, 2, 5)
    np.testing.assert_array_equal(
        tmodel._positions(get_config("qwen2-vl-7b"), 2, 1,
                          offset=torch.tensor([3, 9])).numpy()[:, :, 0],
        [[3, 9]] * 3)


def _bf16_weights(tree, name=""):
    """The weight matrices that `quantize_tree` quantizes cast to bf16;
    embeddings, positions and norms keep their dtype."""
    if isinstance(tree, dict):
        return {k: _bf16_weights(v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_bf16_weights(v, name) for v in tree]
    if tree.ndim >= 2 and name not in SKIP:
        return tree.astype(jnp.bfloat16)
    return tree


def _whisper(dtype="float32", quant="bf16"):
    jcfg = jax_reduced("whisper-base", vocab=1024)
    tcfg = reduced("whisper-base", vocab=1024)
    jp = jax_init_params(jax.random.PRNGKey(3), jcfg, dtype=jnp.dtype(dtype))
    if quant != "bf16":     # the weight matrices in bf16, then quantized
        jp = jquantize_tree(_bf16_weights(jp), quant)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           tcfg)


def _frames(cfg, dtype, B=2, seed=0):
    rng = np.random.default_rng(seed)
    f = jnp.asarray(rng.normal(size=(B, cfg.frontend_len, cfg.d_model))
                    .astype(np.float32), dtype)
    return f, to_torch(np.asarray(f))


@pytest.mark.parametrize("dtype,flash_tol,plain_tol", [
    ("float32", 1e-5, 1e-5), ("bfloat16", 2 ** -6, 2 ** -7)])
def test_encode_against_reference(dtype, flash_tol, plain_tol):
    """The stacked encoder (2 layers, layernorm, gelu, no mask) with its
    learned positions and final norm."""
    jcfg, tcfg, jp, tp = _whisper(dtype)
    fj, ft = _frames(jcfg, dtype)
    ref = jencode(jp, jcfg, fj)
    assert _rel(ref, encode(tp, tcfg, ft)) <= flash_tol
    assert _rel(ref, encode(tp, tcfg, ft, flash=False)) <= plain_tol


def test_whisper_params_match_the_reference_tree():
    """init_params draws what the reference draws, layer by layer: the
    decoder layers' ln_x and xattn, pos_embed of MAX_POS rows, one encoder
    dict a layer, enc_pos_embed of frontend_len rows, enc_final_norm; and
    `params_from_jax` carries the reference's across (int8: encoder and
    cross-attention matrices stored K-major, bit for bit)."""
    jcfg, tcfg, jp, _ = _whisper()
    tp = init_params(tcfg, device="cpu", generator=torch.Generator())
    assert tp["pos_embed"].shape == (tmodel.MAX_POS, tcfg.d_model)
    assert set(tp) == set(jp) - {"blocks"} | {"layers"}
    E = tcfg.encoder_layers
    assert len(tp["encoder"]) == E
    for r in range(E):
        ref = jp["encoder"]
        assert set(tp["encoder"][r]) == set(ref)
        for k in ref:
            assert set(tp["encoder"][r][k]) == set(ref[k]), k
            for n in ref[k]:
                assert tuple(tp["encoder"][r][k][n].shape) == \
                    tuple(ref[k][n].shape[1:]), (k, n)
    for layer in tp["layers"]:
        assert {"ln_x", "xattn"} <= set(layer)
        assert set(layer["xattn"]) == {"wq", "wk", "wv", "wo"}
    jq = jquantize_tree(_bf16_weights(jp), "int8")
    tq = params_from_jax(jax.tree.map(np.asarray, jq), tcfg)
    for r in range(E):
        q = tq["encoder"][r]["attn"]["wq"]["q"]
        K = q.shape[0]
        assert q.dtype == torch.int8 and q.stride() == (1, -(-K // 16) * 16)
        np.testing.assert_array_equal(
            q.numpy(), np.asarray(jq["encoder"]["attn"]["wq"]["q"][r]))
    np.testing.assert_array_equal(
        tq["layers"][1]["xattn"]["wk"]["q"].numpy(),
        np.asarray(jq["blocks"][0]["xattn"]["wk"]["q"][1]))


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_whisper_prefill_decode_with_frames(quant):
    """f32 activations (int8: int8 weight matrices, exact products): the
    prefill over frames and a prompt, then 4 decode steps, each side fed
    its own tokens: the same tokens, logits within 1e-5 of their largest
    magnitude, the cross-attention's cached xk/xv within 1e-5 and the
    self-attention's bf16 K/V within one bf16 step; the decoder's learned
    position is read at each slot's cache length."""
    jcfg, tcfg, jp, tp = _whisper("float32", quant)
    fj, ft = _frames(jcfg, jnp.float32)
    rng = np.random.default_rng(5)
    tok = rng.integers(0, 1000, (2, 9)).astype(np.int32)
    lj, cj = jprefill(jp, jcfg, {"tokens": jnp.asarray(tok), "frames": fj},
                      JBY_NAME[quant], max_len=16)
    lt, ct = prefill(tp, tcfg, {"tokens": torch.from_numpy(tok),
                                "frames": ft}, BY_NAME[quant], max_len=16)
    for step in range(5):
        assert _rel(lj, lt) <= 1e-5
        ref = cache_from_jax(jax.tree.map(np.asarray, cj), tcfg)
        for a, b in zip(ref["layers"], ct["layers"]):
            for n in ("xk", "xv"):
                assert float((a[n] - b[n]).abs().max()) <= \
                    1e-5 * float(a[n].abs().max())
            for n in ("k", "v"):
                assert float((a[n].float() - b[n].float()).abs().max()) \
                    <= 2 ** -7
        nj = np.asarray(jnp.argmax(lj[:, -1], -1).astype(jnp.int32))
        nt = lt[:, -1].argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(nj, nt.numpy())
        if step == 4:
            break
        lj, cj = jdecode_step(jp, jcfg, jnp.asarray(nj)[:, None], cj,
                              JBY_NAME[quant])
        lt, ct = decode_step(tp, tcfg, nt[:, None], ct, BY_NAME[quant])
    assert int(ct["len"][0]) == 9 + 4


def test_whisper_runs_on_the_contiguous_path_only():
    """check_served takes whisper-base and qwen2-vl-7b; the serving runner
    refuses the encoder-decoder, as the reference's does."""
    for arch in ("whisper-base", "qwen2-vl-7b"):
        tmodel.check_served(get_config(arch))
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        trunner.make_step_fns(reduced("whisper-base"), 16)
    trunner.make_step_fns(reduced("qwen2-vl-7b"), 16)


@pytest.mark.parametrize("with_patches", [True, False])
def test_vlm_forward_with_and_without_patches(with_patches):
    """qwen2-vl-7b's text stack at the full config's G 7 (7 query heads on
    one KV head, head_dim 128): the first 8 positions replaced by stubbed
    patch embeddings or not, f32, within 1e-5; the patches move the
    logits."""
    jcfg = dataclasses.replace(jax_reduced("qwen2-vl-7b", vocab=1024),
                               num_heads=7, num_kv_heads=1, head_dim=128)
    tcfg = dataclasses.replace(reduced("qwen2-vl-7b", vocab=1024),
                               num_heads=7, num_kv_heads=1, head_dim=128)
    jp = jax_init_params(jax.random.PRNGKey(4), jcfg, dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    rng = np.random.default_rng(6)
    b = {"tokens": rng.integers(0, 1000, (2, 16)).astype(np.int32)}
    if with_patches:
        b["patches"] = rng.normal(size=(2, 8, 64)).astype(np.float32)
    lj, _ = jforward(jp, jcfg, {k: jnp.asarray(v) for k, v in b.items()})
    lt, _ = forward(tp, tcfg, {k: torch.from_numpy(v) for k, v in b.items()})
    assert _rel(lj, lt) <= 1e-5
    if with_patches:
        plain, _ = forward(tp, tcfg, {"tokens": torch.from_numpy(b["tokens"])})
        assert not torch.allclose(plain[:, :8], lt[:, :8])
        assert _rel(lj[:, 8:], lt[:, 8:]) <= 1e-5
