"""The port's copy of the HLO reader (`repro_torch.launch.hlo_analysis`)
against the reference's, on the CPU, on two inputs: the HLO text of a
jitted 5-step `lax.scan`, and a hand-written module with all five
collective kinds inside a `while` of trip count 3."""
import jax
import jax.numpy as jnp
import pytest

import repro.launch.hlo_analysis as jhlo
import repro_torch.launch.hlo_analysis as thlo

HAND = """HloModule collectives

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(%a, %b)
}

%cond (p: (s32[], f32[8,4])) -> pred[] {
  %p = (s32[], f32[8,4]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %n = s32[] constant(3)
  ROOT %lt = pred[] compare(%i, %n), direction=LT
}

%body (p: (s32[], f32[8,4])) -> (s32[], f32[8,4]) {
  %p = (s32[], f32[8,4]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %x = f32[8,4] get-tuple-element(%p), index=1
  %ar = f32[8,4] all-reduce(%x), replica_groups={}, to_apply=%add
  %ag = f32[32,4] all-gather(%ar), dimensions={0}
  %h = bf16[8,4] convert(%x)
  %rs = bf16[2,4] reduce-scatter(%h), dimensions={0}, to_apply=%add
  %a2a = f32[8,4] all-to-all(%ar), dimensions={0}
  %cp = f32[8,4] collective-permute(%a2a), source_target_pairs={{0,1},{1,0}}
  %one = s32[] constant(1)
  %j = s32[] add(%i, %one)
  ROOT %t = (s32[], f32[8,4]) tuple(%j, %cp)
}

ENTRY %main (x: f32[8,4]) -> f32[8,4] {
  %x = f32[8,4] parameter(0)
  %z = s32[] constant(0)
  %t = (s32[], f32[8,4]) tuple(%z, %x)
  %w = (s32[], f32[8,4]) while(%t), condition=%cond, body=%body
  %r = f32[8,4] get-tuple-element(%w), index=1
  ROOT %top = f32[8,4] all-reduce(%r), replica_groups={}, to_apply=%add
}
"""


def _scan_hlo():
    def f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, None, length=5)[0]
    # 32-bit, whatever an earlier test in this process set: under x64 the
    # loop counter is s64, whose trip count neither reader finds
    with jax.enable_x64(False):
        x = jnp.ones((4, 8), jnp.float32)
        w = jnp.ones((8, 8), jnp.float32)
        return jax.jit(f).lower(x, w).compile().as_text()


@pytest.mark.parametrize("which", ["scan", "hand"])
def test_every_function_equals_the_references(which):
    text = _scan_hlo() if which == "scan" else HAND
    assert thlo.collective_bytes(text) == jhlo.collective_bytes(text)
    comps = thlo.parse_computations(text)
    assert comps == jhlo.parse_computations(text)
    assert thlo.computation_multipliers(comps) == \
        jhlo.computation_multipliers(comps)
    assert thlo.scan_flop_multiplier(text) == jhlo.scan_flop_multiplier(text)
    for op in ("while", "dot", "all-reduce", "all-gather", "fusion", "add"):
        assert thlo.count_ops(text, op) == jhlo.count_ops(text, op), op
    if which == "scan":
        mult = thlo.computation_multipliers(comps)
        assert 5.0 in mult.values()       # the scan body, 5 steps


def test_the_hand_written_module_counts_each_kind_by_its_trip_count():
    """Operand bytes, each collective in the body times 3: all-reduce
    8*4 f32 (128 B, and 128 B once more at the entry), all-gather 128,
    reduce-scatter 8*4 bf16 (64), all-to-all 128, collective-permute 128."""
    got = thlo.collective_bytes(HAND)
    assert got == {"all-reduce": 128 * 3 + 128, "all-gather": 128 * 3,
                   "reduce-scatter": 64 * 3, "all-to-all": 128 * 3,
                   "collective-permute": 128 * 3,
                   "total": 128 * 13 + 64 * 3}
    assert thlo.count_ops(HAND, "all-reduce") == 2
