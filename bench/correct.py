"""What decides `correct`: the served tokens against the plain reference,
the engine's token accounting, and the cost meter.

- the served tokens: the gap by which each served token's logit lies
  below the reference's best logit at its position. Greedy decoding
  serves the argmax, so a sound program's gap is 0 but where its rounding
  breaks a near-tie otherwise. Where a call's rows are coupled (a MoE, an
  int8 activation scale), every token the run served is judged, by a
  replay of every call. Where they are not, a sample of the finished
  requests (drawn from the run's seed; the one with the most served
  tokens and one served in each slot always in it). A cell compares the
  statistics its limits file names: `max_gap`, the widest gap;
  `mismatch_share`, the share of tokens whose gap is not 0; `far_share`,
  the share of tokens "far" below the best; `slot_far_share`, the largest
  `far_share` of the tokens of one slot of the batch.
- `tokens_short`: finished requests whose tokens, as the harness saw
  them produced, are not `max_new_tokens` (or not the engine's count).
- `lost`: requests due in the window that never finished (open loop:
  after the drain's cap).
- `meter_rel`: the relative gap between the cost meter's $/M-tokens over
  the window (the engine's Prometheus text) and the hourly price over
  the harness's own output tokens/s.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from bench import reference
from bench.clock import contexts

# served tokens the sample of an uncoupled model reaches at least
SAMPLE_TOKENS = 320
# the statistics of the served tokens' gaps a limits file may name
TOKEN_STATS = ("max_gap", "mismatch_share", "far_share", "slot_far_share",
               "median_gap")
# "far" below the reference's best: FAR standard deviations of its logits
FAR = 3.0


def slots_of(calls) -> Dict[int, int]:
    """Each request's slot, from the prefill call that admitted it."""
    return {rid: slot for c in calls if c.kind == "prefill"
            for slot, rid in c.rids.items()}


def sample(done: List, seed: int, tokens: Dict[int, List[int]],
           slot_of: Dict[int, int], target: int = SAMPLE_TOKENS) -> List:
    """The longest finished request, then one served in each slot that
    finished one, then others, in orders drawn from `seed`, until
    `target` served tokens."""
    if not done:
        return []
    done = sorted(done, key=lambda r: r.rid)
    longest = max(done, key=lambda r: (len(tokens[r.rid]), -r.rid))
    rng = np.random.default_rng(seed)
    rest = [done[i] for i in rng.permutation(len(done))
            if done[i] is not longest]
    out, seen = [longest], {slot_of.get(longest.rid)}
    for r in rest:
        if slot_of.get(r.rid) not in seen:
            out.append(r)
            seen.add(slot_of.get(r.rid))
    n = sum(len(tokens[r.rid]) for r in out)
    taken = {r.rid for r in out}
    for r in rest:
        if n >= target:
            break
        if r.rid not in taken:
            out.append(r)
            n += len(tokens[r.rid])
    return out


def gaps(cfg, cfile, seed, clock, chosen, engine_cfg, device,
         mode: str, control: str = None) -> Dict[str, float]:
    """The `stats` of the gaps of the served tokens under the reference in
    `mode`, and "n_tokens": of every token the run served where rows are
    coupled, else of the `chosen` requests'. With `control` (a lower
    precision), also those of the tokens that the reference in `control`
    puts first at the same positions, as "control_<stat>"."""
    if reference.coupled(cfg, mode):
        return _replay_gaps(cfg, cfile, seed, clock, engine_cfg, device,
                            mode, control)
    slot_of = slots_of(clock.calls)
    seqs, first, served, slots = [], [], [], []
    for r in chosen:
        toks = clock.tokens[r.rid]
        seqs.append(np.asarray(list(r.prompt) + toks[:-1], np.int64))
        first.append(r.prompt_len - 1)
        served.append(torch.as_tensor(toks, device=device))
        slots += [slot_of[r.rid]] * len(toks)
    ref = reference.forward(cfg, cfile, seed, seqs, first, device, mode)
    slots = np.asarray(slots)
    out = {**stats(token_gaps(ref, served), slots),
           "n_tokens": int(sum(len(s) for s in served))}
    if control is not None:
        ctl = reference.forward(cfg, cfile, seed, seqs, first, device,
                                control)
        out.update(stats(token_gaps(ref, [c.argmax(-1) for c in ctl]),
                         slots, "control_"))
    return out


def token_gaps(ref: List[torch.Tensor], toks: List[torch.Tensor]
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(gaps, spreads): each token's gap below the reference's best logit
    at its position, and the standard deviation of the reference's logits
    there."""
    g = [(lg.max(-1).values - lg.gather(-1, t.long()[:, None])[:, 0])
         .cpu().numpy() for lg, t in zip(ref, toks)]
    s = [lg.std(-1).cpu().numpy() for lg in ref]
    return np.concatenate(g), np.concatenate(s)


def stats(gs, slots: np.ndarray, prefix: str = "") -> Dict[str, float]:
    """The numbers a cell may compare: the widest gap; the share of tokens
    not at the reference's best (a tie counts as the best); the share of
    tokens "far" from it, more than `FAR` standard deviations of the
    reference's logits at their position below its best, where a token
    drawn at random from the vocabulary lies; and the largest such share
    among the slots of the batch (`slots`: each token's slot), so that
    one slot that serves garbage among sound ones shows."""
    g, s = gs
    far = g > FAR * s
    return {prefix + "max_gap": float(g.max()),
            prefix + "mismatch_share": float((g > 0).mean()),
            prefix + "far_share": float(far.mean()),
            prefix + "slot_far_share": float(max(
                far[slots == k].mean() for k in np.unique(slots))),
            prefix + "median_gap": float(np.median(g))}


def _replay_gaps(cfg, cfile, seed, clock, engine_cfg, device, mode,
                 control):
    steps = contexts(clock.calls, engine_cfg["max_batch"])
    want, served = [], []
    for si, c in enumerate(steps):
        for slot in c.rids:
            want.append((si, slot))
            served.append(int(c.out[slot]))
    ref = reference.replay(cfg, cfile, seed, clock.calls, engine_cfg,
                           device, mode, want)
    lg = torch.stack([ref[w] for w in want])
    t = torch.as_tensor(served, device=lg.device)
    slots = np.asarray([slot for _, slot in want])
    g = token_gaps([lg], [t])
    out = {**stats(g, slots), "n_tokens": len(want),
           "_gaps": g[0].tolist(), "_slots": slots.tolist(),
           "_kinds": [steps[si].kind for si, _ in want],
           "_rids": [steps[si].rids[slot] for si, slot in want]}
    if control is not None:
        del ref
        ctl = reference.replay(cfg, cfile, seed, clock.calls, engine_cfg,
                               device, control, want)
        ct = torch.stack([ctl[w].argmax() for w in want])
        cg = token_gaps([lg], [ct])
        out.update(stats(cg, slots, "control_"))
        out["_control_gaps"] = cg[0].tolist()
    return out


def accounting(finished: List, clock) -> int:
    """Finished requests whose delivered tokens are not what they asked
    for, or not the engine's own count."""
    return sum(1 for r in finished
               if not (len(clock.tokens.get(r.rid, ())) == r.max_new_tokens
                       == r.tokens_out))


def meter_rel(meter_c_eff: float, price_per_hr: float, tokens: int,
              seconds: float) -> float:
    own = price_per_hr * 1e6 / (3600.0 * tokens / seconds)
    return abs(meter_c_eff - own) / own
