"""Faults planted in the timed path, for the tests that show `correct`
coming out false: each is a `fault(kind, tokens, mask)` for
`run.run_cell`, which alters the tokens a call made where they are
produced, before the engine or the harness sees them."""
import numpy as np


def altered(every: int = 1):
    """A token altered where it is produced, in every `every`-th call,
    for each slot the call served."""
    n = [0]

    def fault(kind, tokens, mask):
        n[0] += 1
        if n[0] % every:
            return tokens
        out = tokens.copy()
        out[mask] = (out[mask] + 517) % 1021
        return out
    return fault


def one_slot(vocab: int, slot: int = 0, seed: int = 0):
    """One slot of the batch serves garbage: its tokens drawn at random
    over the vocabulary; the other slots are sound."""
    rng = np.random.default_rng(seed)

    def fault(kind, tokens, mask):
        out = tokens.copy()
        if mask[slot]:
            out[slot] = rng.integers(0, vocab)
        return out
    return fault


def half_batch():
    """Half of the batch left out: of the rows a call serves, the upper
    half (rounded up) is never computed, and its tokens read as zeros."""
    def fault(kind, tokens, mask):
        out = tokens.copy()
        rows = np.flatnonzero(mask)
        out[rows[len(rows) // 2:]] = 0
        return out
    return fault


KINDS = ("one_slot", "half_batch")


def by_name(name: str, vocab: int, seed: int = 0):
    return {"one_slot": lambda: one_slot(vocab, 0, seed),
            "half_batch": half_batch,
            "altered": altered}[name]()
