"""The port's serving path against the reference's, on the CPU.

(a) the copied numpy Engine schedules exactly as the reference's;
(b) the two RealExecutors, under one fixed clock, emit the same tokens;
(c) no module of the port imports JAX or the reference package;
(d) the entry points run on the card unless the caller asks for the CPU.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as jserving
import repro_torch.serving as tserving
from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro_torch.configs import reduced
from repro_torch.launch import serve as tserve
from repro_torch.serving.executors import RealExecutor
from repro_torch.weights import params_from_jax

SRC = Path(__file__).resolve().parents[1] / "src"
ECFG = dict(max_batch=4, page_size=8, num_pages=128, max_pages_per_seq=16)


class _StubExecutor:
    """Fixed step durations, token = step count: the engine's decisions
    depend on the clock alone."""

    needs_tokens = True

    def __init__(self):
        self.calls = 0

    def reset_slot(self, slot):
        pass

    def prefill(self, tokens, lens, do_mask, block_tables):
        self.calls += 1
        return np.full(tokens.shape[0], self.calls, np.int32), \
            0.01 + 1e-4 * int(lens.sum())

    def decode(self, tokens, active, block_tables, context_lens=None):
        self.calls += 1
        return np.full(tokens.shape[0], self.calls, np.int32), \
            0.002 + 1e-4 * int(active.sum())

    def decode_multi(self, tokens, active, block_tables, context_lens,
                     max_steps, time_budget=None):
        cur, total, steps = np.array(tokens), 0.0, 0
        while steps < int(max_steps):
            nxt, dt = self.decode(cur, active, block_tables)
            cur[active] = nxt[active]
            total += dt
            steps += 1
            if time_budget is not None and total >= time_budget:
                break
        return cur, total, max(steps, 1)


def _timings(reqs):
    return [(r.rid, r.first_token_time, r.finish_time, r.tokens_out)
            for r in reqs]


@pytest.mark.parametrize("fast_forward", [True, False])
def test_engine_copy_schedules_like_the_reference(fast_forward):
    spec = dict(lam=40.0, n_requests=12, scale=0.05, seed=5)
    out = []
    for mod in (jserving, tserving):
        eng = mod.Engine(mod.EngineConfig(fast_forward=fast_forward, **ECFG),
                         _StubExecutor())
        reqs = mod.synth_requests(mod.ArrivalSpec(**spec))
        eng.run(reqs)
        assert all(r.finish_time is not None for r in reqs)
        out.append((_timings(reqs), eng.metrics.render()))
    assert out[0] == out[1]


class _FixedClock:
    """Wraps a RealExecutor: its tokens, a fixed duration per call, and a
    record of every token it emitted (no decode_multi: the engine takes
    its per-step loop, calling decode once per step)."""

    needs_tokens = True

    def __init__(self, ex):
        self.ex, self.log = ex, []

    def reset_slot(self, slot):
        self.ex.reset_slot(slot)

    def prefill(self, tokens, lens, do_mask, block_tables):
        first, _ = self.ex.prefill(tokens, lens, do_mask, block_tables)
        self.log.append(first[do_mask].tolist())
        return first, 0.05

    def decode(self, tokens, active, block_tables, context_lens=None):
        nxt, _ = self.ex.decode(tokens, active, block_tables)
        self.log.append(nxt[active].tolist())
        return nxt, 0.01


def test_real_executors_emit_the_same_tokens():
    """f32 parameters, prompts drawn by the engine from [0, 1000), inside
    the vocabulary of 1024: identical token streams and timings."""
    _same_tokens("llama31-8b")


def test_real_executors_emit_the_same_tokens_hybrid():
    """As above for the hybrid jamba-v0.1-52b (reduced: 7 Mamba layers, one
    attention layer, MoE on every second), whose Mamba states carry each
    slot's padded prompt into its decode."""
    _same_tokens("jamba-v0.1-52b")


def _same_tokens(arch):
    jcfg = jax_reduced(arch, vocab=1024)
    jp = jax_init_params(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp),
                         reduced(arch, vocab=1024))
    kw = dict(num_pages=ECFG["num_pages"], page_size=ECFG["page_size"],
              max_batch=ECFG["max_batch"])
    execs = (_FixedClock(jserving.RealExecutor(jcfg, jp, **kw)),
             _FixedClock(RealExecutor(reduced(arch, vocab=1024), tp,
                                      device="cpu", **kw)))
    spec = dict(lam=50.0, n_requests=6, scale=0.02, seed=4)
    timings = []
    for mod, ex in zip((jserving, tserving), execs):
        eng = mod.Engine(mod.EngineConfig(**ECFG), ex)
        reqs = mod.synth_requests(mod.ArrivalSpec(**spec))
        eng.run(reqs)
        assert all(r.finish_time is not None for r in reqs)
        timings.append(_timings(reqs))
    assert timings[0] == timings[1]
    assert len(execs[0].log) > 10
    assert execs[0].log == execs[1].log


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(' '.join(k for k in sys.modules "
        "if k.startswith('repro_torch')))\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert res.returncode == 0, res.stderr
    loaded = set(res.stdout.split())
    assert len(loaded) >= 25                       # every module was loaded
    assert {"repro_torch.models.ssm", "repro_torch.kernels.ssm_scan.kernel",
            "repro_torch.kernels.ssm_scan.ops",
            "repro_torch.kernels.ssm_scan.ref",
            "repro_torch.configs.jamba_v0_1_52b"} <= loaded


def test_entry_points_need_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card refusal "
                    "cannot be shown")
    cfg = reduced("llama31-8b", vocab=1024)
    params = {"layers": []}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RealExecutor(cfg, params, num_pages=8, page_size=8, max_batch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.build_engine("llama31-8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--requests", "1"])
    eng = tserve.build_engine("llama31-8b", device="cpu")
    assert eng.ex.device.type == "cpu"


def test_cpu_server_meters_every_request(capsys):
    tserve.main(["--device", "cpu", "--lam", "5", "--requests", "4"])
    out = capsys.readouterr().out
    assert "$/MTok=" in out and "completed 4/4" in out


@pytest.mark.parametrize("arch,quant", [("qwen3-30b-a3b", "int8"),
                                        ("qwen3-30b-a3b", "fp8"),
                                        ("llama31-8b", "int8"),
                                        ("jamba-v0.1-52b", "int8"),
                                        ("jamba-v0.1-52b", "fp8")])
def test_cpu_server_serves_moe_and_quantized(arch, quant, capsys):
    tserve.main(["--device", "cpu", "--arch", arch, "--quant", quant,
                 "--lam", "5", "--requests", "4"])
    out = capsys.readouterr().out
    assert "$/MTok=" in out and "completed 4/4" in out


def test_build_engine_quantizes_and_routes_through_qcfg():
    eng = tserve.build_engine("qwen3-30b-a3b", device="cpu", quant="int8")
    layer = eng.ex.params["layers"][0]
    assert layer["attn"]["wq"]["q"].dtype == torch.int8
    assert layer["moe"]["experts_down"]["q"].dtype == torch.int8
    with pytest.raises(ValueError, match="unknown quant"):
        tserve.build_engine("llama31-8b", device="cpu", quant="int4")
