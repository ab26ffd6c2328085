"""The port's dry-run of a multi-pod train cell on a fake process group
of 512 ranks, on the CPU: whisper-base on (2, 16, 16) at the train_4k
cell's global batch of 256 and 2,048 tokens a row, the whole train step
(8 micro-batches of the loss and its gradients with remat, the clip, and
the 8-bit AdamW update of every sharded leaf).

It stands in for the reference's own slow test's third cell, xlstm-350m
train_4k on two pods: the port's xLSTM loops over time in Python, too
long a run for a test. The rows are 2,048 tokens, not train_4k's 4,096,
so that the decoder's attention is the plain one and not the blocked one
of rows past 2,048 (16 block pairs a layer, each a dozen ops on fake
DTensors): the 4,096-token cell takes over two minutes here. The
sharding is the same (the batch over ("pod", "data"); 2,048 divides as
4,096 does), and so are the collective kinds, all-reduce, all-gather and
reduce-scatter. The cell runs in a subprocess, as a fake process group is
process-wide.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

CODE = r"""
import dataclasses, json
from repro_torch.configs import SHAPES_BY_NAME, get_config
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_production_mesh
shape = dataclasses.replace(SHAPES_BY_NAME["train_4k"], name="train_2k",
                            seq_len=2048)
SHAPES_BY_NAME[shape.name] = shape
rec = dryrun.run_cell("whisper-base", shape.name, multi_pod=True,
                      save=False, verbose=False)
mesh = make_production_mesh(multi_pod=True)
_, args, sp, donate = specs.build_cell(get_config("whisper-base"), shape,
                                       mesh)
rec["want_argument_bytes"] = specs.shard_bytes(args, sp, mesh)
print("JSON" + json.dumps(rec))
"""


def test_whisper_train_on_two_pods():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", CODE], capture_output=True,
                         text=True, env=env, timeout=900)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("JSON")][-1]
    rec = json.loads(line[4:])
    assert rec["status"] == "ok"
    assert rec["n_devices"] == 512 and rec["mesh"] == "2x16x16"
    assert rec["roofline"]["compute_s"] > 0
    assert rec["cost_analysis"]["flops"] > 0
    coll = rec["collective_bytes"]
    # the kinds the train_4k cell issues (gradients are reduced over the
    # data axes, so all-reduces happen)
    assert coll["all-reduce"] > 0 and coll["all-gather"] > 0
    assert coll["reduce-scatter"] > 0
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == rec["want_argument_bytes"]
    # a train step reads every parameter and all of its optimizer state
    assert mem["unread_argument_size_in_bytes"] == 0
    assert mem["temp_size_in_bytes"] > 0
