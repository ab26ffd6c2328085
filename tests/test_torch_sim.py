"""The port's sim tier against the reference's, on the CPU.

The sim tier is the same Python and numpy arithmetic on both sides, so
everything here is held to exact equality (a NaN matches a NaN):
(a) every hardware-book entry of the reference, field by field;
(b) `StepTimeModel` over the port's configs, the book's entries (the
    port's `h100-sxm` too, rebuilt as a reference `HardwareGen`), the
    quants and chip counts;
(c) an engine run on `SimExecutor`, with fast-forward on and off;
(i) `launch.serve --tier sim` prints the reference's text.
Port-only: the `h100-sxm` entry's peaks, and the real tier's price
lookup by the card's name.
"""
import contextlib
import dataclasses
import io

import pytest

import repro.launch.serve as jserve
import repro.serving as jserving
import repro.simulate as jsim
import repro_torch.serving as tserving
import repro_torch.simulate as tsim
from repro.configs import get_config as jax_get_config
from repro_torch.configs import get_config
from repro_torch.core import chip_hour_price
from repro_torch.launch import serve as tserve

ARCHS = ("llama31-8b", "qwen3-30b-a3b", "jamba-v0.1-52b", "mixtral-8x7b",
         "xlstm-350m", "codeqwen1.5-7b", "nemotron-4-15b", "granite-34b",
         "granite-moe-1b-a400m", "whisper-base", "qwen2-vl-7b")
HWS = ("tpu-v5e", "tpu-v5p", "tpu-v6e", "cpu-node", "h100-sxm")


def _hw_pair(name):
    """(reference entry, port entry); `h100-sxm` exists only in the port,
    so the reference side is a reference `HardwareGen` of its fields."""
    port = tsim.HW_BY_NAME[name]
    ref = jsim.HW_BY_NAME.get(name) or jsim.HardwareGen(
        **dataclasses.asdict(port))
    return ref, port


def test_hardware_book_copies_every_reference_entry():
    assert set(tsim.HW_BY_NAME) == set(jsim.HW_BY_NAME) | {"h100-sxm"}
    for name, ref in jsim.HW_BY_NAME.items():
        assert dataclasses.asdict(tsim.HW_BY_NAME[name]) == \
            dataclasses.asdict(ref)
    for q in ("bf16", "int8", "fp8", "fp8_native"):
        for name in jsim.HW_BY_NAME:
            assert tsim.HW_BY_NAME[name].peak(q) == \
                jsim.HW_BY_NAME[name].peak(q)


def test_h100_entry_peaks_and_price():
    h = tsim.HW_BY_NAME["h100-sxm"]
    assert h is tsim.H100
    assert h.peak("bf16") == 989e12
    assert h.peak("int8") == 1979e12
    assert h.peak("fp8") == 1979e12          # fp8 tensor cores: native
    assert h.peak("fp8_native") == 989e12    # not a step-time quant name
    assert (h.hbm_bw, h.hbm_bytes, h.ici_bw) == (3.35e12, 80e9, 450e9)
    assert chip_hour_price("h100-sxm", 2) == 2 * h.price_per_chip_hr > 0


@pytest.mark.parametrize("hw", HWS)
@pytest.mark.parametrize("arch", ARCHS)
def test_step_time_model_matches_reference(arch, hw):
    ref_hw, port_hw = _hw_pair(hw)
    for quant in ("bf16", "int8", "fp8"):
        for n_chips in (1, 2):
            a = jsim.StepTimeModel(jax_get_config(arch), ref_hw,
                                   n_chips=n_chips, quant=quant)
            b = tsim.StepTimeModel(get_config(arch), port_hw,
                                   n_chips=n_chips, quant=quant)
            for batch in (0, 1, 8, 64, 256):
                for ctx in (0.0, 37.5, 520.0, 4096.0):
                    assert b.decode_time(batch, ctx) == \
                        a.decode_time(batch, ctx)
                    for k in (0, 1, 7, 300):
                        assert b.decode_time_multi(batch, ctx, k) == \
                            a.decode_time_multi(batch, ctx, k)
            for n_tok, n_req in ((0, 0), (17, 1), (2048, 4), (8192, 8)):
                assert b.prefill_time(n_tok, n_req) == \
                    a.prefill_time(n_tok, n_req)
            assert b.saturation_tps() == a.saturation_tps()
            assert b.saturation_tps(520.0, 64) == a.saturation_tps(520.0, 64)


@pytest.mark.parametrize("arch,hw,quant", [
    ("llama31-8b", "h100-sxm", "bf16"), ("qwen3-30b-a3b", "tpu-v5e", "fp8"),
    ("mixtral-8x7b", "h100-sxm", "int8")])
@pytest.mark.parametrize("fast_forward", [True, False])
def test_sim_executor_engine_run_matches_reference(arch, hw, quant,
                                                   fast_forward):
    ref_hw, port_hw = _hw_pair(hw)
    ecfg = dict(max_batch=16, page_size=16, num_pages=4096,
                max_pages_per_seq=64, fast_forward=fast_forward)
    spec = dict(lam=8.0, n_requests=40, scale=0.25, seed=3)
    runs = []
    for mod, cfg, h, sim in ((jserving, jax_get_config(arch), ref_hw, jsim),
                             (tserving, get_config(arch), port_hw, tsim)):
        ex = mod.SimExecutor(cfg, sim.StepTimeModel(cfg, h, quant=quant))
        eng = mod.Engine(mod.EngineConfig(**ecfg), ex)
        reqs = mod.synth_requests(mod.ArrivalSpec(**spec))
        eng.run(reqs)
        assert all(r.finish_time is not None for r in reqs)
        runs.append(([(r.rid, r.ttft, r.finish_time, r.tokens_out)
                      for r in reqs], eng.t, eng.metrics.render()))
    assert runs[0] == runs[1]


def _printed(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def test_serve_sim_tier_prints_the_reference_text():
    argv = ["--tier", "sim", "--hw", "tpu-v5e", "--lam", "5",
            "--requests", "200"]
    text = _printed(tserve.main, argv)
    assert text == _printed(jserve.main, argv)
    assert "completed 200/200" in text


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "nemotron-4-15b",
                                  "granite-34b", "granite-moe-1b-a400m"])
def test_serve_sim_tier_prints_the_reference_text_for_each_arch(arch):
    argv = ["--tier", "sim", "--hw", "tpu-v5e", "--arch", arch, "--lam",
            "5", "--requests", "200"]
    text = _printed(tserve.main, argv)
    assert text == _printed(jserve.main, argv)
    assert "completed 200/200" in text


def test_serve_sim_tier_on_the_h100_entry_needs_no_card():
    text = _printed(tserve.main, ["--tier", "sim", "--arch", "mixtral-8x7b",
                                  "--quant", "fp8", "--chips", "2",
                                  "--lam", "5", "--requests", "40"])
    assert "completed 40/40" in text and "$/MTok=" in text
    eng = tserve.build_engine("mixtral-8x7b", tier="sim", n_chips=2,
                              quant="fp8")
    assert eng.ex.model.hw is tsim.H100 and eng.ex.model.n_chips == 2
    with pytest.raises(ValueError, match="unknown tier"):
        tserve.build_engine("llama31-8b", tier="tpu")


def test_real_tier_prices_at_the_hardware_it_runs_on():
    assert tserve.card_hw("NVIDIA H100 80GB HBM3") == "h100-sxm"
    for name in ("NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", ""):
        with pytest.raises(ValueError, match="no hardware-book entry"):
            tserve.card_hw(name)
    assert tserve.real_tier_hw("cpu") == "cpu-node"
    assert chip_hour_price("cpu-node") == 1.0
