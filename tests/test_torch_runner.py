"""The port's step functions against the reference's `make_step_fns`.

Both run `reduced(arch, vocab=1024)` on the same converted weights and
the same numpy-drawn prompts, on the CPU (the port through its kernels'
plain versions): llama31-8b and phi3-medium-14b (dense), qwen3-30b-a3b
(MoE) and the hybrid jamba-v0.1-52b (Mamba + attention + MoE, 8 layers),
and llama31-8b, phi3-medium-14b and jamba under int8. The schedule admits three slots, decodes, admits the
fourth while the others hold their context, and decodes again. Both
sides feed the same padding: MoE capacity is shared by every row of a
group, padded rows and inactive slots included, so the reference's dropped
tokens depend on them; and a Mamba layer's prefill runs over the padded
prompt, so the state a slot carries into decode has seen its pad tokens.
"""
import dataclasses

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
from repro_torch.weights import params_from_jax, pools_from_jax

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


def _setup(dtype, arch="llama31-8b", quant="bf16", moe=None, layers=2):
    """Reference params (`quant` int8: f32 params whose weight matrices
    are cast to bf16 and quantized, so everything but the int8 products
    runs in f32) and their conversion for the port. `moe`: fields of the
    MoE config to replace on both sides."""
    jcfg = jax_reduced(arch, vocab=1024, layers=layers)
    tcfg = reduced(arch, vocab=1024, layers=layers)
    if moe:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 **moe))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                                 **moe))
    jp = jax_init_params(jax.random.PRNGKey(7), jcfg, dtype=jnp.dtype(dtype))
    if quant != "bf16":
        jp = jquantize_tree(_bf16_weights(jp), quant)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


class _Pair:
    """Drives the JAX and the port step functions side by side."""

    def __init__(self, dtype, arch="llama31-8b", quant="bf16", moe=None,
                 bt=None, num_pages=NUM_PAGES, layers=2):
        """`bt`: the block tables, (batch, max_pages); by default slot b
        owns pages 1 + b * MAXP onwards."""
        self.jcfg, self.tcfg, self.jp, self.tp = _setup(dtype, arch, quant,
                                                        moe, layers)
        if bt is None:
            bt = np.arange(1, 1 + B * MAXP, dtype=np.int32).reshape(B, MAXP)
        nb = bt.shape[0]
        self.jpre, self.jdec = jrunner.make_step_fns(self.jcfg, PAGE,
                                                     qcfg=JBY_NAME[quant])
        self.tpre, self.tdec = trunner.make_step_fns(self.tcfg, PAGE,
                                                     qcfg=BY_NAME[quant])
        self.jpools = jrunner.init_pools(self.jcfg, num_pages, PAGE, nb)
        self.tpools = trunner.init_pools(self.tcfg, num_pages, PAGE, nb,
                                         device="cpu")
        self.jseq = jnp.zeros((nb,), jnp.int32)
        self.tseq = torch.zeros((nb,), dtype=torch.int32)
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

    def copy_trash_page(self):
        """Give the port the reference's page 0 in every attention layer:
        each side writes every inactive K/V row there, and the reference
        does not fix which of several writes to one place wins."""
        jl = pools_from_jax(jax.tree.map(np.asarray, self.jpools), self.tcfg)
        for j, t in zip(jl, self.tpools):
            if "k" in t:
                for n in ("k", "v"):
                    t[n][0].copy_(j[n][0])

    def _layers(self):
        """(reference, port) state of each layer, as fp32 numpy arrays."""
        jl = pools_from_jax(jax.tree.map(np.asarray, self.jpools), self.tcfg)
        return [({n: a.float().numpy() for n, a in j.items()},
                 {n: a.float().numpy() for n, a in t.items()})
                for j, t in zip(jl, self.tpools)]

    def pool_diff(self):
        """Largest |K/V| difference over the real pages (page 0 is the
        trash page, written by both in an unspecified order)."""
        return max([float(np.abs(j[n][1:] - t[n][1:]).max())
                    for j, t in self._layers() if "k" in j
                    for n in ("k", "v")] or [0.0])

    def state_diff(self):
        """The Mamba states `conv` and `h`: each one's largest difference
        over its largest magnitude, in the worst layer (h is fp32 and
        tiny, ~1e-5 at this size; conv holds bf16 activations of ~1)."""
        return tuple(
            max(float(np.abs(j[n] - t[n]).max()) /
                max(float(np.abs(j[n]).max()), 1e-30)
                for j, t in self._layers() if "h" in j)
            for n in ("conv", "h"))


def _prompts(rng, lens):
    lp = -(-int(lens.max()) // 64) * 64
    tokens = np.zeros((len(lens), lp), np.int32)
    for b, n in enumerate(lens):
        tokens[b, :n] = rng.integers(0, 1000, n)
    return tokens


def _run(pair, feed_from_jax, states=None):
    """Prefill, decode, prefill slot 2, decode. Returns the token streams
    of both sides and the largest pool difference seen after each call;
    with a list `states`, appends the Mamba state differences after each
    call to it."""
    rng = np.random.default_rng(11)
    streams_j, streams_t, diffs = [], [], []
    track = (lambda: states.append(pair.state_diff())) if states is not None \
        else (lambda: None)
    cur = np.zeros(B, np.int32)
    active = LENS_1 > 0
    for lens in (LENS_1, LENS_2):
        fj, ft = pair.prefill(_prompts(rng, lens), lens)
        streams_j.append(fj[lens > 0])
        streams_t.append(ft[lens > 0])
        diffs.append(pair.pool_diff())
        track()
        cur[lens > 0] = (fj if feed_from_jax else ft)[lens > 0]
        active = active | (lens > 0)
        for _ in range(STEPS):
            nj, nt = pair.decode(cur, active)
            streams_j.append(nj[active])
            streams_t.append(nt[active])
            diffs.append(pair.pool_diff())
            track()
            cur[active] = (nj if feed_from_jax else nt)[active]
    np.testing.assert_array_equal(np.asarray(pair.jseq), pair.tseq.numpy())
    return streams_j, streams_t, diffs


def _tokens_identical(arch="llama31-8b", quant="bf16", moe=None):
    pair = _Pair("float32", arch, quant, moe)
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
                                        ("llama31-8b", "int8"),
                                        ("jamba-v0.1-52b", "bf16"),
                                        ("jamba-v0.1-52b", "int8"),
                                        ("phi3-medium-14b", "bf16"),
                                        ("phi3-medium-14b", "int8")])
def test_f32_tokens_identical_moe_and_int8(arch, quant):
    """As above for the MoE model, the hybrid (7 Mamba layers, one
    attention layer, MoE on every second) and phi3-medium-14b (dense, 4
    query heads a KV head), and for int8 weight matrices under
    `BY_NAME["int8"]` with f32 activations (the int8 products are exact on
    both sides)."""
    _tokens_identical(arch, quant)


def test_jamba_f32_states_match():
    """f32 parameters, each side fed its own tokens: after every call the
    Mamba states agree. conv is stored in bf16 on both sides, so fp32
    noise that straddles a rounding boundary flips one bf16 step (at most
    2**-8 of the largest |conv|); h inherits such a flip at the next step
    through u, so it is held to 1e-3 of its largest |h| (seen: 1.2e-4)."""
    states = []
    _run(_Pair("float32", "jamba-v0.1-52b"), feed_from_jax=False,
         states=states)
    conv, h = np.max(states, axis=0)
    assert conv <= 2 ** -8 and h <= 1e-3, (conv, h)


def test_idle_slots_keep_tokens_identical_under_tight_moe_capacity():
    """An idle decode slot (seq_len 0, a block-table row of 0s, as the
    engine's `PageManager` leaves it) gets the mean of V over its gathered
    row on both sides. Its row enters the MoE queues beside the real
    tokens, and with mixtral's routing (8 experts, top-2) a group of 8
    decode rows has 3 places an expert, so an idle row ahead of a real one
    can take its place: the port must give it the reference's value. f32
    parameters, 8 slots of which 4-7 hold prompts; over 24 decode steps
    the tokens must agree at every step. Before each decode the port gets
    the reference's trash page 0, which the idle rows read."""
    lens = np.array([0, 0, 0, 0, 5, 20, 13, 9], np.int32)
    steps, maxp = 24, 12
    bt = np.zeros((8, maxp), np.int32)
    nxt = 1
    for b, n in enumerate(lens):
        need = -(-(int(n) + steps) // PAGE) if n else 0
        bt[b, :need] = np.arange(nxt, nxt + need)
        nxt += need
    pair = _Pair("float32", "qwen3-30b-a3b", moe=dict(
        num_experts=8, top_k=2, group_size=256), bt=bt, num_pages=96)
    active = lens > 0
    fj, ft = pair.prefill(_prompts(np.random.default_rng(11), lens), lens)
    np.testing.assert_array_equal(fj[active], ft[active])
    cur = np.where(active, ft, 0)
    for step in range(steps):
        pair.copy_trash_page()
        nj, nt = pair.decode(cur, active)
        np.testing.assert_array_equal(nj[active], nt[active],
                                      err_msg=f"decode step {step}")
        cur[active] = nt[active]
    assert pair.pool_diff() <= 2 ** -7


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


def test_jamba_bf16_pools_match():
    """bf16 parameters, both sides fed the reference's tokens: K/V within
    0.02 as for llama31-8b (`test_bf16_pools_match`); the Mamba states,
    relative to their largest magnitude, within 0.02 in the median call
    (one bf16 step of conv, 2**-8, and h's few percent inherited from the
    bf16 roundings of u, dt, B and C) and within 0.1 in every call: a
    near-tie of two experts in the router can send a token elsewhere on
    one side, which moved the conv state of the layers after it by 7% in
    one of the 12 calls."""
    states = []
    sj, st, diffs = _run(_Pair("bfloat16", "jamba-v0.1-52b"),
                         feed_from_jax=True, states=states)
    worst, median = np.max(states, axis=0), np.median(states, axis=0)
    assert max(diffs) <= 0.02, diffs
    assert np.all(median <= 0.02) and np.all(worst <= 0.1), states
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


MIXTRAL_ROUTING = dict(num_experts=8, top_k=2, group_size=256)


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_mixtral_tokens_identical_with_its_routing(quant):
    """Reduced mixtral-8x7b with its own routing (8 experts, top-2, groups
    of 256 tokens: 3 places an expert in a decode group of 4 rows), f32
    parameters, and under int8 f32 activations with int8 weight matrices:
    the same greedy tokens at every call, each side fed its own tokens, and
    K/V within one bf16 step."""
    _tokens_identical("mixtral-8x7b", quant, moe=MIXTRAL_ROUTING)


class _Logits:
    """Records the fp32 logits that each side's step functions compute, by
    wrapping each framework's `unembed` (the reference's step functions
    are jitted, so its wrapper hands the array out through a debug
    callback); `pop()` returns the last call's pair."""

    def __init__(self, monkeypatch):
        from repro.models import model as jmodel
        from repro_torch.models import model as tmodel
        self.j, self.t = [], []
        junembed, tunembed = jmodel.unembed, tmodel.unembed

        def jrec(*a, **k):
            out = junembed(*a, **k)
            jax.debug.callback(lambda v: self.j.append(np.asarray(v)), out)
            return out

        def trec(*a, **k):
            out = tunembed(*a, **k)
            self.t.append(out.numpy())
            return out

        monkeypatch.setattr(jmodel, "unembed", jrec)
        monkeypatch.setattr(tmodel, "unembed", trec)

    def pop(self):
        jax.effects_barrier()
        return self.j.pop()[:, 0], self.t.pop()[:, 0]


def _xlstm_states(pair):
    """For each xLSTM state name, its largest difference between the sides
    over its largest magnitude, in the worst layer; -inf entries (mLSTM m
    of a slot that never prefilled) must sit at the same places on both
    sides and are left out."""
    worst = {}
    for j, t in pair._layers():
        for n, a in j.items():
            b = t[n]
            fin = np.isfinite(a)
            np.testing.assert_array_equal(fin, np.isfinite(b), err_msg=n)
            assert not np.isnan(a).any() and not np.isnan(b).any(), n
            if fin.any():
                key = ("mLSTM " if "C" in j else "sLSTM ") + n
                rel = float(np.abs(a[fin] - b[fin]).max()) / max(
                    float(np.abs(a[fin]).max()), 1e-30)
                worst[key] = max(worst.get(key, 0.0), rel)
    return worst


def _xlstm_run(monkeypatch, dtype):
    """Prefill, decode, prefill slot 2, decode on reduced xlstm-350m (4
    layers: mLSTM, sLSTM, mLSTM, sLSTM; tied embeddings), both sides fed
    the reference's tokens. Returns, after each call, the state
    differences of `_xlstm_states` and the logits' largest difference over
    their largest magnitude (the logits of the slots that took part)."""
    logits = _Logits(monkeypatch)
    pair = _Pair(dtype, "xlstm-350m", layers=4)
    rng = np.random.default_rng(11)
    states, logit_diffs = [], []

    def record(mask):
        lj, lt = logits.pop()
        assert lt.dtype == np.float32
        logit_diffs.append(float(np.abs(lj[mask] - lt[mask]).max())
                           / float(np.abs(lj[mask]).max()))
        states.append(_xlstm_states(pair))

    cur = np.zeros(B, np.int32)
    active = LENS_1 > 0
    for lens in (LENS_1, LENS_2):
        fj, _ = pair.prefill(_prompts(rng, lens), lens)
        record(lens > 0)
        cur[lens > 0] = fj[lens > 0]
        active = active | (lens > 0)
        for _ in range(STEPS):
            nj, _ = pair.decode(cur, active)
            record(active)
            cur[active] = nj[active]
    return states, logit_diffs


def test_xlstm_f32_states_and_logits_match(monkeypatch):
    """f32 parameters: after each of the 12 calls every mLSTM state (C, n,
    m) and sLSTM state (c, n, m, h), and the fp32 logits of the slots that
    took part, agree to fp32 rounding: 1e-5 of the largest magnitude
    (seen: 8.2e-7 for the states, 2.6e-7 for the logits). Tokens alone
    would show nothing: with tied random embeddings greedy decoding
    repeats each slot's last prompt token."""
    states, logit_diffs = _xlstm_run(monkeypatch, "float32")
    assert max(logit_diffs) <= 1e-5, logit_diffs
    for s in states:
        assert max(s.values()) <= 1e-5, s


def test_xlstm_bf16_states_and_logits_match(monkeypatch):
    """bf16 parameters and activations, fp32 states. Both sides round each
    projection to bf16 after summing in another order, so a gate's
    pre-activation can land one bf16 step apart: 2**-6 at |g| in [2, 4),
    which exp turns into 1.6% of a gate, and sLSTM's n sums such gates.
    So every state within 0.03 of its largest magnitude (two such steps;
    seen: 0.0152, sLSTM n after the first prefill; mLSTM C 0.0066) and the
    logits within 0.01 of theirs (seen: 0.0019)."""
    states, logit_diffs = _xlstm_run(monkeypatch, "bfloat16")
    assert max(logit_diffs) <= 0.01, logit_diffs
    for s in states:
        assert max(s.values()) <= 0.03, s


def test_xlstm_idle_slot_keeps_minus_inf_stabiliser():
    """A slot that never prefills keeps mLSTM's m at -inf and C, n at 0 on
    both sides, through a prefill and decode steps of the others; no state
    holds a NaN."""
    pair = _Pair("float32", "xlstm-350m", layers=4)
    lens = np.array([7, 0, 18, 3], np.int32)
    active = lens > 0
    fj, ft = pair.prefill(_prompts(np.random.default_rng(3), lens), lens)
    cur = np.where(active, ft, 0)
    for _ in range(3):
        _, nt = pair.decode(cur, active)
        cur[active] = nt[active]
    n_mlstm = 0
    for j, t in pair._layers():
        for side in (j, t):
            for a in side.values():
                assert not np.isnan(a).any()
            if "C" in side:
                assert np.all(side["m"][1] == -np.inf)
                assert np.all(side["m"][active] > -np.inf)
                assert not side["C"][1].any() and not side["n"][1].any()
        n_mlstm += "C" in j
    assert n_mlstm == 2
