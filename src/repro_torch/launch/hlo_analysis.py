"""Post-optimization HLO analysis: collective operand bytes, loop-aware.

Counterpart of `repro.launch.hlo_analysis`, copied as it is: plain `re`
over HLO text. The port makes no HLO (its dry-run counts the collectives
DTensor issues, `launch.dryrun`); this module is the reference's public
API for reading the reference's own records and HLO dumps, kept so the
port has every function of the reference's package.

XLA's cost_analysis counts while-loop (lax.scan) bodies ONCE, not
trip_count times — verified on this backend (a 5-step scan of a 128-flop
matmul reports 146 flops). The same holds for any text-level accounting,
so this parser:

  1. splits the module into computations,
  2. finds every `while`, reads the trip count from the constant in its
     condition computation,
  3. propagates an execution-count multiplier down the call graph
     (nested scans multiply),
  4. sums collective operand bytes weighted by the enclosing computation's
     multiplier.

The resulting per-device collective bytes are per *step*, comparable
across cells regardless of scan structure.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "all-to-all", "collective-permute")

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([\d,]*)\]")
_HEADER_RE = re.compile(r"^(?:ENTRY\s+)?(%[\w.\-]+)\s*\(")
_INSTR_RE = re.compile(r"^\s*(?:ROOT\s+)?(%[\w.\-]+)\s*=\s*(.*)$")
_WHILE_RE = re.compile(
    r"while\(.*?\),\s*condition=(%[\w.\-]+),\s*body=(%[\w.\-]+)")
_CONST_RE = re.compile(r"s32\[\]\s*constant\((\d+)\)")
_CALL_RE = re.compile(r"(?:calls|to_apply|condition|body)=(%[\w.\-]+)")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def parse_computations(hlo_text: str) -> Dict[str, List[str]]:
    comps: Dict[str, List[str]] = {}
    cur = None
    entry = None
    for line in hlo_text.splitlines():
        m = _HEADER_RE.match(line)
        if m and line.rstrip().endswith("{"):
            cur = m.group(1)
            comps[cur] = []
            if line.startswith("ENTRY"):
                entry = cur
            continue
        if line.startswith("}"):
            cur = None
            continue
        if cur is not None:
            comps[cur].append(line)
    if entry is not None:
        comps["__entry__"] = comps[entry]
    return comps


def computation_multipliers(comps: Dict[str, List[str]]) -> Dict[str, float]:
    """Execution count per computation (nested while loops multiply)."""
    # trip count per condition computation
    def trip_of(cond: str) -> int:
        consts = [int(c) for lines in [comps.get(cond, [])]
                  for line in lines for c in _CONST_RE.findall(line)]
        return max(consts) if consts else 1

    mult: Dict[str, float] = {name: 1.0 for name in comps}
    entry = comps.get("__entry__")
    if entry is None:
        return mult
    # propagate from entry through the call graph (iterate to fixpoint)
    order = ["__entry__"]
    seen = {"__entry__"}
    i = 0
    while i < len(order):
        cname = order[i]
        i += 1
        for line in comps.get(cname, []):
            w = _WHILE_RE.search(line)
            if w:
                cond, body = w.groups()
                mult[body] = mult.get(body, 1.0) * 0 + \
                    mult[cname] * trip_of(cond)
                if body not in seen:
                    seen.add(body)
                    order.append(body)
                continue
            for callee in _CALL_RE.findall(line):
                if callee not in seen and callee in comps:
                    mult[callee] = mult[cname]
                    seen.add(callee)
                    order.append(callee)
    return mult


def collective_bytes(hlo_text: str) -> Dict[str, float]:
    """Per-kind collective operand bytes per device, loop-trip-weighted."""
    comps = parse_computations(hlo_text)
    mult = computation_multipliers(comps)

    out = {k: 0.0 for k in COLLECTIVE_OPS}
    for cname, lines in comps.items():
        if cname == "__entry__":
            continue
        m = mult.get(cname, 1.0)
        shapes: Dict[str, str] = {}
        pend: List[Tuple[str, List[str], str]] = []
        for line in lines:
            im = _INSTR_RE.match(line)
            if not im:
                continue
            name, rest = im.groups()
            # leading result-shape only (tuples span to the matching paren)
            if rest.startswith("("):
                shapes[name] = rest[:rest.find(")") + 1]
            else:
                shapes[name] = rest.split(" ")[0]
            for kind in COLLECTIVE_OPS:
                token = f" {kind}(" if f" {kind}(" in line else (
                    f" {kind}-start(" if f" {kind}-start(" in line else None)
                if token:
                    args = line.split(token, 1)[1].split(")", 1)[0]
                    ops = [a.strip().split(" ")[-1] for a in args.split(",")
                           if a.strip().startswith("%") or " %" in a]
                    pend.append((kind, ops, rest))
                    break
        for kind, ops, own in pend:
            b = sum(_shape_bytes(shapes.get(o, "")) for o in ops)
            if b == 0:
                b = _shape_bytes(own.split(f"{kind}")[0])
            out[kind] += b * m
    # entry-level collectives (outside any sub-computation) were attributed
    # to the entry's named computation already (it is in comps).
    out["total"] = sum(out[k] for k in COLLECTIVE_OPS)
    return out


def count_ops(hlo_text: str, opname: str) -> int:
    pat = r"=\s*[\w\[\]{},. ]*?" + re.escape(opname) + r"\("
    return len(re.findall(pat, hlo_text))


def scan_flop_multiplier(hlo_text: str) -> float:
    """Rough whole-module correction: weighted mean loop multiplier by
    instruction count — used to scale aggregate cost_analysis numbers when
    an analytic model is unavailable."""
    comps = parse_computations(hlo_text)
    mult = computation_multipliers(comps)
    tot = w = 0.0
    for cname, lines in comps.items():
        if cname == "__entry__":
            continue
        n = len(lines)
        tot += n * mult.get(cname, 1.0)
        w += n
    return tot / w if w else 1.0
