"""The one traffic generator: a mix file of parameters -> requests.

The arrival draws are frozen copies of `repro_torch.serving.arrivals`
(`poisson_arrivals`, `gamma_arrivals`, at commit 81c71db), and the order
of the draws follows its `synth_arrays`: arrival times first, then prompt
lengths, then output lengths, all off one generator. That generator is
seeded by the mix's own `shape_seed`, so every run seed gets the same
sizes and arrivals and the work of a window does not move with the seed.
The run's `--seed` draws the prompts' token ids (uniform over the
vocabulary), and the weights elsewhere.

Mix keys: `arrivals` (`{"process": "backlog"}`: every request due at t =
0; `{"process": "poisson", "rate": r}`; `{"process": "gamma", "rate": r,
"cv": c}`), `n_requests` (a backlog's size; an open loop draws arrivals
until `warm_s` + the run's seconds), `prompt` and `output` (`lognormal`
with `median` and `sigma`, rounded and clipped to [`min`, `max`]),
`warm_s` (seconds of traffic before the window opens) and `drain_s` (the
cap on serving the window's requests after it closes).
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

# prompt + output must fit the program's 48 pages of 16 tokens a sequence
MAX_TOTAL = 768
# the longest warm-in plus window an open loop is drawn for
MAX_HORIZON_S = 120.0
# arrivals drawn past the planned window's end, for a window that opens
# late (its last call before it ran over the warm-in)
SLACK_S = 10.0


def poisson_arrivals(rng: np.random.Generator, lam: float, n: int,
                     start: float = 0.0) -> np.ndarray:
    """n exponential inter-arrival times at rate lam (CV=1)."""
    if lam < 0:
        raise ValueError(f"arrival rate must be >= 0, got {lam}")
    if lam == 0:
        return np.empty(0, np.float64)
    gaps = rng.exponential(1.0 / lam, size=n)
    return start + np.cumsum(gaps)


def gamma_arrivals(rng: np.random.Generator, lam: float, cv: float, n: int,
                   start: float = 0.0) -> np.ndarray:
    """Gamma inter-arrivals with coefficient of variation `cv` at rate
    lam: shape 1/cv^2, scale cv^2/lam."""
    if lam < 0:
        raise ValueError(f"arrival rate must be >= 0, got {lam}")
    if lam == 0:
        return np.empty(0, np.float64)
    k = 1.0 / (cv * cv)
    theta = cv * cv / lam
    gaps = rng.gamma(k, theta, size=n)
    return start + np.cumsum(gaps)


def _lengths(rng: np.random.Generator, spec: dict, n: int) -> np.ndarray:
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    x = rng.lognormal(math.log(spec["median"]), spec["sigma"], size=n)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def arrays(mix: dict, seconds: float):
    """(arrival_times, prompt_lens, output_lens) of `mix` for a window of
    `seconds`: a backlog's `n_requests` all due at 0, or an open loop's
    arrivals up to `warm_s + seconds + SLACK_S`."""
    if mix["prompt"]["max"] + mix["output"]["max"] > MAX_TOTAL:
        raise ValueError(f"{mix['name']}: prompt + output can pass "
                         f"{MAX_TOTAL} tokens")
    rng = np.random.default_rng(mix["shape_seed"])
    arr = mix["arrivals"]
    if arr["process"] == "backlog":
        times = np.zeros(mix["n_requests"])
    else:
        horizon = mix["warm_s"] + seconds
        # one count of draws for every window length, so the lengths
        # drawn after the times are the same whatever the run's seconds
        n = int(arr["rate"] * MAX_HORIZON_S * 2 + 64)
        if arr["process"] == "poisson":
            times = poisson_arrivals(rng, arr["rate"], n)
        elif arr["process"] == "gamma":
            times = gamma_arrivals(rng, arr["rate"], arr["cv"], n)
        else:
            raise ValueError(f"unknown arrival process {arr['process']!r}")
        if horizon + SLACK_S > MAX_HORIZON_S or \
                times[-1] < horizon + SLACK_S:
            raise ValueError(f"{mix['name']}: arrivals end before "
                             f"{horizon} s")
    prompts = _lengths(rng, mix["prompt"], len(times))
    outputs = _lengths(rng, mix["output"], len(times))
    if arr["process"] != "backlog":
        keep = times < horizon + SLACK_S
        times, prompts, outputs = times[keep], prompts[keep], outputs[keep]
    return times, prompts, outputs


def requests(mix: dict, seconds: float, seed: int, vocab: int) -> List:
    """The engine's `Request`s of `mix`, prompts drawn from `seed`."""
    from repro_torch.serving import Request
    times, prompts, outputs = arrays(mix, seconds)
    ids = np.random.default_rng(seed).integers(0, vocab, int(prompts.sum()))
    out, at = [], 0
    for rid, (t, p, o) in enumerate(zip(times, prompts, outputs)):
        out.append(Request(rid=rid, arrival_time=float(t), prompt_len=int(p),
                           max_new_tokens=int(o),
                           prompt=ids[at:at + p].tolist()))
        at += p
    return out
