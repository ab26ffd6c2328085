"""The wall clock, from the client's side, around the program's executor.

`WallClock(engine)` wraps the engine's executor's `prefill`, `decode` and
`reset_slot` in this file (the program's code is untouched, as
`chip_smoke.py::record_steps` wraps them). Engine time 0 is the wall time
at `start()`. Each call returns, as its duration, the wall time since the
engine's clock last stood, so `Engine.t` equals the wall clock at every
return, and the scheduler's own host time between calls is on it. Where
the engine jumped over idle time to the next arrival, the call first
sleeps until the wall clock reaches the engine's.

Each call is logged (`Call`) with the inputs the engine handed the
executor, which the reference replays, and each token the call made is
stamped, per request, with the call's return.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Call:
    kind: str                    # "prefill" | "decode" | "reset"
    start: float                 # wall seconds since start(), at the call
    end: float                   # ... at its return
    tokens: Optional[np.ndarray] = None       # (B, Lp) or (B,) int32
    lens: Optional[np.ndarray] = None         # prefill: (B,) prompt lengths
    mask: Optional[np.ndarray] = None         # prefill do_mask / decode active
    block_tables: Optional[np.ndarray] = None
    context: Optional[np.ndarray] = None      # (B,) the slots' lengths
    #                                           before the call (`contexts`)
    out: Optional[np.ndarray] = None          # (B,) tokens the call made
    rids: Dict[int, int] = dataclasses.field(default_factory=dict)
    slot: int = -1                            # reset: the slot
    slept: float = 0.0           # seconds slept before it (idle jump)


class WallClock:
    def __init__(self, engine, fault=None):
        self.eng = engine
        ex = engine.ex
        self._prefill, self._decode = ex.prefill, ex.decode
        self._reset = ex.reset_slot
        ex.prefill, ex.decode = self.prefill, self.decode
        ex.reset_slot = self.reset_slot
        self.fault = fault
        self.calls: List[Call] = []
        self.stamps: Dict[int, List[float]] = {}
        self.tokens: Dict[int, List[int]] = {}
        self.t0: Optional[float] = None
        self.stood = 0.0
        self._slept = 0.0
        self.range = None            # torch.profiler.record_function, traced

    def detach(self):
        """Give the executor back its own methods, and hold no reference
        to it."""
        ex = self.eng.ex
        for name in ("prefill", "decode", "reset_slot"):
            ex.__dict__.pop(name, None)
        self._prefill = self._decode = self._reset = None

    def start(self):
        self.t0 = time.perf_counter()
        self.stood = 0.0

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def _begin(self) -> float:
        base = max(self.stood, self.eng.t)
        wait = base - self.now()
        self._slept = 0.0
        if wait > 0:
            time.sleep(wait)
            self._slept = wait
        self.stood = base
        return self.now()

    def _end(self, call: Call):
        call.end = self.now()
        call.slept = self._slept
        dt = call.end - self.stood
        self.stood = call.end
        self.calls.append(call)
        for slot, rid in call.rids.items():
            self.stamps.setdefault(rid, []).append(call.end)
            self.tokens.setdefault(rid, []).append(int(call.out[slot]))
        return dt

    def _run(self, name, fn, *args):
        if self.range is None:
            return fn(*args)
        with self.range(name):
            return fn(*args)

    def prefill(self, tokens, lens, do_mask, block_tables):
        start = self._begin()
        first, _ = self._run("bench.prefill", self._prefill, tokens, lens,
                             do_mask, block_tables)
        first = np.array(first)
        if self.fault is not None:
            first = self.fault("prefill", first, do_mask)
        call = Call("prefill", start, 0.0, tokens.copy(), lens.copy(),
                    do_mask.copy(), block_tables.copy(), out=first,
                    rids={int(s): self.eng.slot_req[int(s)].rid
                          for s in np.flatnonzero(do_mask)})
        return first, self._end(call)

    def decode(self, tokens, active, block_tables):
        start = self._begin()
        nxt, _ = self._run("bench.decode", self._decode, tokens, active,
                           block_tables)
        nxt = np.array(nxt)
        if self.fault is not None:
            nxt = self.fault("decode", nxt, active)
        call = Call("decode", start, 0.0, np.array(tokens), None,
                    active.copy(), block_tables.copy(), None, nxt,
                    rids={int(s): self.eng.slot_req[int(s)].rid
                          for s in np.flatnonzero(active)})
        return nxt, self._end(call)

    def reset_slot(self, slot):
        self._reset(slot)
        t = self.now()
        self.calls.append(Call("reset", t, t, slot=int(slot)))

    def steps(self, lo: float = -np.inf, hi: float = np.inf) -> List[Call]:
        """The prefill and decode calls that ran within [lo, hi]."""
        return [c for c in self.calls if c.kind != "reset"
                and c.start >= lo and c.end <= hi]


def contexts(calls: List[Call], batch: int) -> List[Call]:
    """Fill each call's `context`: the executor's per-slot sequence
    lengths before it, replayed from the log as the executor keeps them
    (a prefill sets its slots' prompt lengths, a decode step adds one to
    each active slot, a reset zeroes its slot). Returns the steps."""
    lens = np.zeros(batch, np.int64)
    steps = []
    for c in calls:
        if c.kind == "reset":
            lens[c.slot] = 0
            continue
        c.context = lens.copy()
        if c.kind == "prefill":
            lens = np.where(c.mask, c.lens, lens)
        else:
            lens = lens + c.mask
        steps.append(c)
    return steps
