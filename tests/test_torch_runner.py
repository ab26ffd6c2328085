"""The port's step functions against the reference's `make_step_fns`.

Both run `reduced(arch, vocab=1024)` on the same converted weights and
the same numpy-drawn prompts, on the CPU (the port through its kernels'
plain versions): llama31-8b (dense) and qwen3-30b-a3b (MoE), and
llama31-8b under int8. The schedule admits three slots, decodes, admits
the fourth while the others hold their context, and decodes again. Both
sides feed the same padding: MoE capacity is shared by every row of a
group, padded rows and inactive slots included, so the reference's dropped
tokens depend on them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro.quant import BY_NAME as JBY_NAME
from repro.quant import quantize_tree as jquantize_tree
from repro.serving import runner as jrunner
from repro_torch.configs import reduced
from repro_torch.quant import BY_NAME, SKIP
from repro_torch.serving import runner as trunner
from repro_torch.weights import params_from_jax

B, PAGE, NUM_PAGES, MAXP = 4, 8, 64, 8
LENS_1 = np.array([5, 20, 0, 13], np.int32)     # slot 2 waits
LENS_2 = np.array([0, 0, 29, 0], np.int32)      # then slot 2 arrives
STEPS = 5                                       # decode steps per phase


def _bf16_weights(tree, name=""):
    """Cast the weight matrices that `quantize_tree` quantizes to bf16;
    embeddings, norms and the router keep their dtype."""
    if isinstance(tree, dict):
        return {k: _bf16_weights(v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_bf16_weights(v, name) for v in tree)
    if tree.ndim >= 2 and name not in SKIP:
        return tree.astype(jnp.bfloat16)
    return tree


def _setup(dtype, arch="llama31-8b", quant="bf16"):
    """Reference params (`quant` int8: f32 params whose weight matrices
    are cast to bf16 and quantized, so everything but the int8 products
    runs in f32) and their conversion for the port."""
    jcfg = jax_reduced(arch, vocab=1024)
    tcfg = reduced(arch, vocab=1024)
    jp = jax_init_params(jax.random.PRNGKey(7), jcfg, dtype=jnp.dtype(dtype))
    if quant != "bf16":
        jp = jquantize_tree(_bf16_weights(jp), quant)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    bt = np.arange(1, 1 + B * MAXP, dtype=np.int32).reshape(B, MAXP)
    return jcfg, tcfg, jp, tp, bt


class _Pair:
    """Drives the JAX and the port step functions side by side."""

    def __init__(self, dtype, arch="llama31-8b", quant="bf16"):
        self.jcfg, self.tcfg, self.jp, self.tp, bt = _setup(dtype, arch,
                                                            quant)
        self.jpre, self.jdec = jrunner.make_step_fns(self.jcfg, PAGE,
                                                     qcfg=JBY_NAME[quant])
        self.tpre, self.tdec = trunner.make_step_fns(self.tcfg, PAGE,
                                                     qcfg=BY_NAME[quant])
        self.jpools = jrunner.init_pools(self.jcfg, NUM_PAGES, PAGE, B)
        self.tpools = trunner.init_pools(self.tcfg, NUM_PAGES, PAGE,
                                         device="cpu")
        self.jseq = jnp.zeros((B,), jnp.int32)
        self.tseq = torch.zeros((B,), dtype=torch.int32)
        self.bt_j, self.bt_t = jnp.asarray(bt), torch.from_numpy(bt)

    def prefill(self, tokens, lens):
        mask = lens > 0
        fj, self.jpools, self.jseq = self.jpre(
            self.jp, self.jpools, self.bt_j, self.jseq, jnp.asarray(tokens),
            jnp.asarray(lens), jnp.asarray(mask))
        ft, self.tseq = self.tpre(
            self.tp, self.tpools, self.bt_t, self.tseq,
            torch.from_numpy(tokens), torch.from_numpy(lens),
            torch.from_numpy(mask))
        return np.asarray(fj), ft.numpy()

    def decode(self, tokens, active):
        nj, self.jpools, self.jseq = self.jdec(
            self.jp, self.jpools, self.bt_j, self.jseq, jnp.asarray(tokens),
            jnp.asarray(active))
        nt, self.tseq = self.tdec(
            self.tp, self.tpools, self.bt_t, self.tseq,
            torch.from_numpy(tokens), torch.from_numpy(active))
        return np.asarray(nj), nt.numpy()

    def pool_diff(self):
        """Largest |K/V| difference over the real pages (page 0 is the
        trash page, written by both in an unspecified order)."""
        worst = 0.0
        for r in range(self.jcfg.num_layers):
            for name in ("k", "v"):
                j = np.asarray(self.jpools[0][name][r, 1:], np.float32)
                t = self.tpools[r][name][1:].float().numpy()
                worst = max(worst, float(np.abs(j - t).max()))
        return worst


def _prompts(rng, lens):
    lp = -(-int(lens.max()) // 64) * 64
    tokens = np.zeros((B, lp), np.int32)
    for b, n in enumerate(lens):
        tokens[b, :n] = rng.integers(0, 1000, n)
    return tokens


def _run(pair, feed_from_jax):
    """Prefill, decode, prefill slot 2, decode. Returns the token streams
    of both sides and the largest pool difference seen after each call."""
    rng = np.random.default_rng(11)
    streams_j, streams_t, diffs = [], [], []
    cur = np.zeros(B, np.int32)
    active = LENS_1 > 0
    for lens in (LENS_1, LENS_2):
        fj, ft = pair.prefill(_prompts(rng, lens), lens)
        streams_j.append(fj[lens > 0])
        streams_t.append(ft[lens > 0])
        diffs.append(pair.pool_diff())
        cur[lens > 0] = (fj if feed_from_jax else ft)[lens > 0]
        active = active | (lens > 0)
        for _ in range(STEPS):
            nj, nt = pair.decode(cur, active)
            streams_j.append(nj[active])
            streams_t.append(nt[active])
            diffs.append(pair.pool_diff())
            cur[active] = (nj if feed_from_jax else nt)[active]
    np.testing.assert_array_equal(np.asarray(pair.jseq), pair.tseq.numpy())
    return streams_j, streams_t, diffs


def _tokens_identical(arch="llama31-8b", quant="bf16"):
    pair = _Pair("float32", arch, quant)
    sj, st, diffs = _run(pair, feed_from_jax=False)
    for a, b in zip(sj, st):
        np.testing.assert_array_equal(a, b)
    # f32 K/V agree to fp32 rounding before the bf16 store; a store can
    # round to the neighbouring bf16 value, one step at |x| < 2 is 2**-7.
    assert max(diffs) <= 2 ** -7


def test_f32_tokens_identical():
    """f32 parameters: the same greedy tokens at every prefill and at each
    of 2 x 5 decode steps, each side fed its own tokens. (The pools are
    bf16 on both sides, as in the reference.)"""
    _tokens_identical()


@pytest.mark.parametrize("arch,quant", [("qwen3-30b-a3b", "bf16"),
                                        ("llama31-8b", "int8")])
def test_f32_tokens_identical_moe_and_int8(arch, quant):
    """As above for the MoE model, and for int8 weight matrices under
    `BY_NAME["int8"]` with f32 activations (the int8 products are exact
    on both sides)."""
    _tokens_identical(arch, quant)


def test_bf16_pools_match():
    """bf16 parameters: both sides fed the reference's tokens, the K/V
    pools agree within a stated tolerance after every step. The reference's
    prefill scales scores and rounds probabilities in bf16 and both sides
    round activations at every layer, so K/V of layer 2 may differ by a few
    bf16 steps: 0.02 is five steps of 2**-8 at |K| < 1."""
    pair = _Pair("bfloat16")
    sj, st, diffs = _run(pair, feed_from_jax=True)
    assert max(diffs) <= 0.02, diffs
    # most tokens agree even so: a flip needs a near-tie of two logits
    agree = np.mean(np.concatenate([a == b for a, b in zip(sj, st)]))
    assert agree >= 0.9, agree


def test_out_of_vocab_prompt_raises():
    """The reference's jnp.take fills NaN for an id past the vocabulary;
    the port refuses it."""
    pair = _Pair("float32")
    tokens = np.zeros((B, 64), np.int32)
    tokens[0, 0] = 1024
    with pytest.raises(IndexError):
        pair.tpre(pair.tp, pair.tpools, pair.bt_t, pair.tseq,
                  torch.from_numpy(tokens),
                  torch.tensor([1, 0, 0, 0], dtype=torch.int32),
                  torch.tensor([True, False, False, False]))
