"""How far rounding noise and planted faults move `chip_smoke.py`'s
small-input readings: the yardstick for their bounds.

    PYTHONPATH=src python3 scripts/small_check_sensitivity.py \
        [--arch mixtral-8x7b --quant int8 | --arch xlstm-350m --quant bf16
         | --arch jamba-v0.1-52b --quant int8]
        [--card | --perturbed-device cuda]

Runs `chip_smoke.small_model` twice through `chip_smoke.drive_small`: a
clean side on the CPU, and a side perturbed in one way (on the CPU, or
with `--perturbed-device cuda` on the card, its own rounding added), then
prints `chip_smoke.small_readings` of the pair (the same readings the
card-vs-CPU check prints, and whether they pass its bounds). Perturbations:
  * nudges: a share of one projection's outputs moved by one bf16 step
    (up or down at random, seed 5), as two devices that sum a bf16
    product in another order may round it: the MoE layer's input or
    output (MoE models), the outputs of every xLSTM `linear`, or the
    results of every operation that rounds to bf16; and "as an H100
    rounds": each operation at the share `--card` measured on the card;
  * faults: decode without each context's last page (attention models),
    decode with the carried Mamba h or conv state dropped (Mamba), or
    decode with the carried mLSTM or sLSTM state dropped (xLSTM).
Imports no JAX; needs a card only for `--card` and `--perturbed-device`.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARES = (0.001, 0.01, 0.1, 1.0)
# the share of each operation's result that an H100 (80GB HBM3, 700 W)
# rounded one bf16 step apart from the CPU on the CPU's own inputs
# (`--card`); "as an H100 rounds" nudges each at its share, with
# generator seeds 0-7. The recurrences' own fp32 differences are not
# nudged. mixtral's shares were read while the int8 scales were formed
# differently on the two devices; since they are formed alike, `--card`
# reads q/k/v and wo 0 and the MoE 0.0040, so these nudges are the
# noisier yardstick.
CARD_SHARES = {
    "mixtral-8x7b": {"norm (ln1, final)": 5.744485294117647e-05,
                     "linear (q, k, v)": 0.028699687882965685,
                     "rope": 1.4361213235294117e-05,
                     "flash_attention": 6.866455078125e-05,
                     "linear (wo)": 0.0014612534466911765,
                     "apply_moe": 0.003600957861971659,
                     "paged_attention": 0.000152587890625},
    "xlstm-350m": {"norm (ln1, final)": 7.898667279411765e-06,
                   "linear (xLSTM)": 0.0004412426983853663},
    # read with the int8 scales formed alike on both devices
    "jamba-v0.1-52b": {"norm (ln1, final)": 3.9892258986928106e-07,
                       "norm (ln2)": 2.243939568014706e-06,
                       "apply_moe": 0.003806496084900749,
                       "flash_attention": 8.392333984375e-05,
                       "paged_attention": 0.0001220703125}}
# the bf16 results "every operation" nudges: each leaf of the step
# functions that rounds to bf16 (not the router's indices, the fp32
# logits, or the blocks that hold nudged operations)
NUDGED_OPS = {"norm (ln1, final)", "norm (ln2)", "norm (mLSTM)",
              "linear (q, k, v)", "linear (wo)", "linear (MLP)",
              "linear (xLSTM)", "rope", "flash_attention", "paged_attention",
              "apply_moe"}


def one_step(t: torch.Tensor, share: float, gen: torch.Generator):
    """`t` with a `share` of its elements moved one bf16 step, at random
    up or down."""
    tf = t.float()
    hit = (torch.rand(t.shape, generator=gen) < share).to(t.device)
    sign = torch.where(torch.rand(t.shape, generator=gen) < 0.5, -1.0,
                       1.0).to(t.device)
    step = torch.exp2(torch.floor(torch.log2(tf.abs().clamp(min=1e-30)))
                      - 7)
    return torch.where(hit, tf + sign * step, tf).to(t.dtype)


def _nudged(f, share, gen):
    """`f` with a `share` of its result's (or its first result's) elements
    moved one bf16 step."""
    def call(*a, **k):
        r = f(*a, **k)
        if isinstance(r, tuple):
            return (one_step(r[0], share, gen),) + r[1:]
        return one_step(r, share, gen)
    return call


def perturbations(arch, cfg):
    """name -> [(module, attribute, wrapper factory taking the original)];
    each perturbation draws its nudges from a generator of its own."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models import xlstm as xlstm_lib
    from repro_torch.serving import runner
    page = 16
    gen = lambda seed=5: torch.Generator().manual_seed(seed)  # noqa: E731
    out = {}
    if cfg.moe is not None:
        for share in SHARES[1:]:
            out[f"MoE input, {share:.0%} nudged"] = [(
                moe_lib, "apply_moe",
                lambda f, s=share, g=gen(): lambda p, x, *a, **k: f(
                    p, one_step(x, s, g), *a, **k))]
            out[f"MoE output, {share:.0%} nudged"] = [(
                moe_lib, "apply_moe",
                lambda f, s=share, g=gen(): _nudged(f, s, g))]
    if cfg.xlstm is not None:
        for share in SHARES:
            out[f"xLSTM projections, {share:.1%} nudged"] = [(
                xlstm_lib, "linear",
                lambda f, s=share, g=gen(): _nudged(f, s, g))]
        for kind in ("mlstm", "slstm"):     # (..., state, qcfg) positional
            out[f"decode drops the carried {kind} state"] = [(
                xlstm_lib, f"{kind}_seq",
                lambda f: lambda *a: f(*a[:-2], None, a[-1]))]
    if cfg.ssm is not None:                 # (p, x, state, cfg, qcfg)
        for n in ("h", "conv"):
            out[f"decode drops the carried Mamba {n}"] = [(
                ssm_lib, "mamba_decode_step",
                lambda f, n=n: lambda p, x, st, *a, **k: f(
                    p, x, dict(st, **{n: torch.zeros_like(st[n])}), *a,
                    **k))]
    for share in SHARES:
        g = gen()
        out[f"every operation, {share:.1%} nudged"] = [
            (mod, attr, lambda f, s=share, g=g: _nudged(f, s, g))
            for mod, attr, label in _ops() if label in NUDGED_OPS]
    for seed in range(8):
        g = gen(seed)
        out[f"as an H100 rounds, seed {seed}"] = [
            (mod, attr, lambda f, s=CARD_SHARES[arch][label], g=g:
             _nudged(f, s, g))
            for mod, attr, label in _ops()
            if label in CARD_SHARES.get(arch, {})]
    if "attn" in cfg.block_pattern():
        out["decode drops each context's last page"] = [(
            runner, "paged_attention",
            lambda f: lambda q, kp, vp, bt, lens: f(
                q, kp, vp, bt, torch.where(lens > page, lens - page, lens)))]
    return {name: p for name, p in out.items() if p}


def run(arch: str, quant: str, names=None, device="cpu"):
    """Yield (perturbation, passes the card's bounds, readings) for each
    perturbation of `arch` (or each of `names`), the perturbed side run on
    `device` (on the card: its own rounding and kernels beside the
    planted perturbation)."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke
    from repro_torch.serving import runner
    runner.set_matmul_precision()
    cfg, params = chip_smoke.small_model(arch, quant)
    for name, patches in perturbations(arch, cfg).items():
        if names is not None and name not in names:
            continue
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
        patched = [wrap(f) for (_, _, wrap), (_, _, f) in zip(patches,
                                                               saved)]

        def before(side):
            for (mod, attr, f), g in zip(saved, patched):
                setattr(mod, attr, g if side == "perturbed" else f)

        try:
            sides = chip_smoke.drive_small(
                cfg, quant, params, {"clean": "cpu", "perturbed": device},
                before)
        finally:
            for mod, attr, f in saved:
                setattr(mod, attr, f)
        readings, ok = chip_smoke.small_readings(
            cfg, quant, sides["clean"], sides["perturbed"])
        yield name, ok, readings


def _ops():
    """(module, attribute, label) of every operation `card_breakdown`
    replays: each name as the step functions look it up."""
    from repro_torch.models import attention, layers, model, moe, xlstm
    from repro_torch.serving import runner
    return [(runner, "apply_norm", "norm (ln1, final)"),
            (model, "apply_norm", "norm (ln2)"),
            (xlstm, "apply_norm", "norm (mLSTM)"),
            (attention, "linear", "linear (q, k, v)"),
            (runner, "linear", "linear (wo)"),
            (layers, "linear", "linear (MLP)"),
            (xlstm, "linear", "linear (xLSTM)"),
            (model, "linear", "linear (lm_head)"),
            (attention, "rotate", "rope"),
            (runner, "flash_attention", "flash_attention"),
            (runner, "paged_attention", "paged_attention"),
            (moe, "top_k", "MoE top_k"),
            (moe, "apply_moe", "apply_moe"),
            (xlstm, "mlstm_seq", "mlstm_seq"),
            (xlstm, "slstm_seq", "slstm_seq"),
            (model, "unembed", "unembed")]


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _to(tree, dev):
    """A copy of `tree`'s tensors on `dev`; a broadcast tensor stays
    broadcast, so a replayed call sees its operands' layout."""
    if isinstance(tree, torch.Tensor):
        base = tree.detach()
        for d, stride in enumerate(tree.stride()):
            if stride == 0 and tree.shape[d]:
                base = base.narrow(d, 0, 1)
        return base.to(dev, copy=True).expand(tree.shape)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree


class _Replay:
    """Wraps each operation of `_ops`: on the CPU side it keeps each call's
    inputs and outputs; on the card side it runs the call as it comes,
    then once more on the CPU's inputs of the same call, and counts how
    the card's result on those inputs differs from the CPU's."""

    def __init__(self, device):
        self.device, self.side, self.replaying = device, "cpu", False
        self.queue, self.stats = {}, {}

    def wrap(self, f, label):
        def call(*a, **k):
            if self.replaying:
                return f(*a, **k)
            if self.side == "cpu":
                a0, k0 = _to(a, "cpu"), _to(k, "cpu")
                out = f(*a, **k)
                self.queue.setdefault(label, []).append(
                    (a0, k0, _to(out, "cpu")))
                return out
            out = f(*a, **k)
            a0, k0, ref = self.queue[label].pop(0)
            self.replaying = True
            try:
                mine = _to(f(*_to(a0, self.device), **_to(k0, self.device)),
                           "cpu")
            finally:
                self.replaying = False
            self._count(label, ref, mine)
            return out
        return call

    def _count(self, label, ref, mine):
        st = self.stats.setdefault(label, dict(
            calls=0, elements=0, differ=0, max_abs=0.0,
            max_over_largest=0.0))
        st["calls"] += 1
        for x, y in zip(_tensors(ref), _tensors(mine)):
            if not x.is_floating_point():
                x, y = x.double(), y.double()
            fin = torch.isfinite(x) & torch.isfinite(y)
            d = (x.float() - y.float()).abs()[fin]
            st["elements"] += x.numel()
            st["differ"] += int((d > 0).sum()) + int(
                (torch.isfinite(x) != torch.isfinite(y)).sum())
            if d.numel():
                top = max(float(x.float()[fin].abs().max()), 1e-30)
                st["max_abs"] = max(st["max_abs"], float(d.max()))
                st["max_over_largest"] = max(st["max_over_largest"],
                                             float(d.max()) / top)


def _kv_by_layer(cfg, a, b):
    """Per attention layer, the K/V cells of the prompts and of the decoded
    tokens (where the runner clamps a position past the block table to
    its last page, the decoded token's): the largest difference and the
    share within 0.02."""
    from chip_smoke import PAGE
    lens, bt = (37, 0, 128, 5), torch.arange(1, 33).reshape(4, 8)

    def cells(s, positions):
        return {(int(bt[s, min(p // PAGE, 7)]), p % PAGE) for p in positions}

    decoded = set().union(*(cells(s, range(n, n + 8)) for s, n in
                            enumerate(lens) if n))
    parts = {"prompt": sorted(set().union(*(
                 cells(s, range(n)) for s, n in enumerate(lens))) - decoded),
             "decoded": sorted(decoded)}
    out = {}
    for i, (pa, pb) in enumerate(zip(a["pools"], b["pools"])):
        if "k" not in pa:
            continue
        for part, cs in parts.items():
            pages, offs = (torch.tensor(c) for c in zip(*cs))
            d = torch.cat([(pa[n][pages, offs].float() -
                            pb[n].cpu()[pages, offs].float()).abs()
                           .reshape(-1) for n in ("k", "v")])
            out[f"layer {i} {part}"] = {
                "max": float(d.max()),
                "within 0.02": float((d <= 0.02).float().mean())}
    return out


def _states_by_layer(a, b):
    """Per recurrent layer and state, the largest difference over the
    largest magnitude (finite elements)."""
    out = {}
    for i, (pa, pb) in enumerate(zip(a["pools"], b["pools"])):
        for n, x in pa.items():
            if n in ("k", "v"):
                continue
            y = pb[n].cpu()
            fin = torch.isfinite(x) & torch.isfinite(y)
            if fin.any():
                out[f"layer {i} {n}"] = float(
                    (x[fin] - y[fin]).abs().max() / x[fin].abs().max())
    return out


def card_breakdown(arch: str, quant: str, device="cuda"):
    """Where `device` (the card) and the CPU part in
    `chip_smoke.small_input_check`: (per-operation differences on the
    CPU's inputs, per-layer K/V, per-layer recurrent states, the check's
    own readings)."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke
    from repro_torch.serving import runner
    runner.set_matmul_precision()
    cfg, params = chip_smoke.small_model(arch, quant)
    rep, saved = _Replay(device), []
    for mod, attr, label in _ops():
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, rep.wrap(getattr(mod, attr), label))

    def before(side):
        rep.side = side

    try:
        sides = chip_smoke.drive_small(cfg, quant, params,
                                       {"cpu": "cpu", "card": device},
                                       before)
    finally:
        for mod, attr, f in saved:
            setattr(mod, attr, f)
    for st in rep.stats.values():
        st["share differing"] = st["differ"] / max(st["elements"], 1)
    readings, ok = chip_smoke.small_readings(cfg, quant, sides["cpu"],
                                             sides["card"])
    return (rep.stats, _kv_by_layer(cfg, sides["cpu"], sides["card"]),
            _states_by_layer(sides["cpu"], sides["card"]),
            dict(readings, passes=ok))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--quant", default="int8")
    ap.add_argument("--card", action="store_true",
                    help="where the card and the CPU part (needs a card)")
    ap.add_argument("--perturbed-device", default="cpu",
                    help="run the perturbed side here (cuda: on the card)")
    args = ap.parse_args(argv)
    if args.card:
        for name, part in zip(("operations on the CPU's inputs",
                               "K/V by layer", "states by layer",
                               "the check's readings"),
                              card_breakdown(args.arch, args.quant)):
            print(f"{args.arch} {args.quant}, {name}: {json.dumps(part)}",
                  flush=True)
        return
    for name, ok, readings in run(args.arch, args.quant,
                                  device=args.perturbed_device):
        print(f"{args.arch} {args.quant}, {name}: passes the card's bounds: "
              f"{ok}; {json.dumps(readings)}", flush=True)


if __name__ == "__main__":
    main()
