"""The harness loads neither JAX nor the JAX package, and its reference
loads nothing of the program: checked in fresh processes, by whole
top-level module names (`repro_torch` is not `repro`)."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

HARNESS = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
import bench.run, bench.sweep, bench.control, bench.correct, bench.trace
import bench.faults, bench.rehearsal
from bench import manifest as mf
for m in mf.load_manifest()["per_layer"]:
    mf.reader(m["name"])
import repro_torch.launch.serve, repro_torch.serving, repro_torch.quant
import repro_torch.core, repro_torch.kernels.build, repro_torch.configs
import repro_torch.serving.runner
print(sorted({{m.split(".", 1)[0] for m in sys.modules}}))
"""

REFERENCE = """
import sys
sys.path[:0] = [{root!r}]
import bench.reference, bench.correct, bench.weights, bench.traffic
print(sorted({{m.split(".", 1)[0] for m in sys.modules}}))
"""


def _tops(code):
    out = subprocess.run(
        [sys.executable, "-c", code.format(src=str(ROOT / "src"),
                                           root=str(ROOT))],
        capture_output=True, text=True, timeout=240, check=True,
        env={"PATH": "/usr/bin:/bin", "HOME": "/tmp"})
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    tops = _tops(HARNESS)
    assert "repro_torch" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_program():
    tops = _tops(REFERENCE)
    assert "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
