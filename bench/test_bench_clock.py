"""The wall-clock wrapper on a stub executor: the engine's clock equals
the wall clock at every return, an idle jump sleeps until its arrival,
and each token is stamped with its call's return."""
import time

import numpy as np

from bench.clock import WallClock, contexts
from repro_torch.serving import Engine, EngineConfig, Request


class Stub:
    """An executor that takes 5 ms a call and claims 1 s: the wrapper
    must return the wall time instead."""
    needs_tokens = True

    def __init__(self):
        self.n = 0

    def reset_slot(self, slot):
        pass

    def prefill(self, tokens, lens, do_mask, block_tables):
        time.sleep(0.005)
        return np.full(tokens.shape[0], 7, np.int32), 1.0

    def decode(self, tokens, active, block_tables):
        time.sleep(0.005)
        self.n += 1
        return np.full(tokens.shape[0], self.n % 100, np.int32), 1.0

    def decode_multi(self, tokens, active, block_tables, context_lens,
                     max_steps, time_budget=None):
        cur, total, steps = np.array(tokens), 0.0, 0
        while steps < max_steps:
            nxt, dt = self.decode(cur, active, block_tables)
            cur[active] = nxt[active]
            total += dt
            steps += 1
            if time_budget is not None and total >= time_budget:
                break
        return cur, total, max(steps, 1)


def test_engine_clock_is_the_wall_clock():
    ex = Stub()
    eng = Engine(EngineConfig(max_batch=2, num_pages=64,
                              max_pages_per_seq=8), ex)
    seen = []
    clock = WallClock(eng)
    inner = clock._end

    def end(call):
        dt = inner(call)
        seen.append((eng.t, clock.stood, call))
        return dt
    clock._end = end
    # two requests 0.2 s apart, with idle between them
    reqs = [Request(rid=0, arrival_time=0.1, prompt_len=5,
                    max_new_tokens=3, prompt=[1, 2, 3, 4, 5]),
            Request(rid=1, arrival_time=0.3, prompt_len=4,
                    max_new_tokens=4, prompt=[5, 6, 7, 8])]
    clock.start()
    eng.run(reqs)
    wall = clock.now()
    assert abs(eng.t - wall) < 0.01
    steps = contexts(clock.calls, 2)
    # every call began after its requests were due: the idle jumps slept
    assert steps[0].kind == "prefill" and steps[0].start >= 0.1
    pre2 = [c for c in steps if c.kind == "prefill"][1]
    assert pre2.start >= 0.3 and pre2.slept > 0
    for r in reqs:
        assert r.finish_time is not None
        stamps = clock.stamps[r.rid]
        assert len(stamps) == r.max_new_tokens == len(clock.tokens[r.rid])
        assert stamps[0] >= r.arrival_time and np.all(np.diff(stamps) > 0)
        # the engine's own record is the wall clock too
        assert abs(r.first_token_time - stamps[0]) < 1e-6
        assert abs(r.finish_time - stamps[-1]) < 1e-6
    assert clock.tokens[0][0] == 7
    clock.detach()
    assert "prefill" not in vars(ex) and clock._prefill is None


def test_contexts_replay_the_sequence_lengths():
    ex = Stub()
    eng = Engine(EngineConfig(max_batch=2, num_pages=64,
                              max_pages_per_seq=8), ex)
    clock = WallClock(eng)
    reqs = [Request(rid=0, arrival_time=0.0, prompt_len=5,
                    max_new_tokens=2, prompt=[1] * 5)]
    clock.start()
    eng.run(reqs)
    steps = contexts(clock.calls, 2)
    assert [c.kind for c in steps] == ["prefill", "decode"]
    assert steps[1].context.tolist() == [5, 0]
    assert clock.calls[-1].kind == "reset"
