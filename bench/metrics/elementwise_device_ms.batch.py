"""Model code outside GEMMs and the port's kernels (`models/moe.py`,
`quant`): device ms a decode step in kernels of the "other" group
(dequantization, routing, activation quantization, norms), from the
trace: kernels that start inside a decode call, over the decode calls."""


def read(run):
    t = run.trace
    if t is None:
        return None
    n = sum(1 for r in t.ranges if r[2] == "decode call")
    return 1e3 * t.group_s("other", "decode call") / n if n else None
