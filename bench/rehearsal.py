"""The CPU rehearsal of a cell, for the tests only: the cell's harness
from its traffic to its checks, on a narrow model of the cell's family
through the kernels' plain versions. Its numbers are never a
measurement, and the command line has no way to ask for it."""
import dataclasses


def narrow(d_model: int = 64, vocab: int = 1024):
    """`configure` for `run.run_cell`: the cell's config at 2 layers and
    `d_model` wide, 4 query heads over 2 KV heads of 16, a vocabulary of
    `vocab`; a MoE keeps its experts, top-k, groups and capacity."""
    def configure(cfg):
        ch = dict(num_layers=2, d_model=d_model, num_heads=4,
                  num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=vocab)
        if cfg.moe is not None:
            ch["moe"] = dataclasses.replace(cfg.moe, expert_ff=128)
        return dataclasses.replace(cfg, **ch)
    return configure


def short(workload: str) -> dict:
    """The cell's mix with prompts of at most 128 tokens, answers of at
    most 24 and 1 s of warm-in, so that a loaded CPU finishes requests
    inside a short window."""
    from bench import manifest as mf
    mix = mf.load_traffic(mf.cell(mf.load_manifest(), workload)["traffic"])
    p = dict(mix["prompt"], min=min(mix["prompt"]["min"], 64), max=128)
    o = dict(mix["output"], min=min(mix["output"]["min"], 4), max=24)
    return dict(mix, prompt=p, output=o, warm_s=min(mix["warm_s"], 1))


def run(workload: str, seed: int = 2 ** 31 + 99, seconds: float = 6.0,
        d_model: int = 64, vocab: int = 1024, **kw):
    """One run of the rehearsal; the test workers share the CPU, so each
    takes two threads."""
    import torch
    from bench import run as run_lib
    torch.set_num_threads(2)
    return run_lib.run_cell(workload, seed, seconds, False, device="cpu",
                            configure=narrow(d_model, vocab),
                            mix=short(workload), log=lambda *a: None, **kw)
