"""Train a ~100M-parameter llama-family model for a few hundred steps on
one device, with checkpoints + restart-and-continue (the PyTorch port's
counterpart of `examples/train_small.py`).

    PYTHONPATH=src python examples/torch_train_small.py --steps 300
    # kill it mid-run, re-run the same command: it resumes.

(~100M: d_model=640, 10 layers, ff=2560, vocab=16384.) Runs on the card
(the fused 8-bit AdamW kernel); `--device cpu` runs the plain versions.
The checkpoints go under the temporary directory (`$TMPDIR`) unless
`--ckpt-dir` names another.
"""
import argparse
import os
import tempfile

from repro_torch.configs import reduced
from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_100m_ckpt"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced("llama31-8b", layers=10, d_model=640, ff=2560, vocab=16384)
    print(f"config: {cfg.num_layers}L d={cfg.d_model} ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} -> {cfg.param_count()/1e6:.1f}M params")

    return train_main([
        "--arch", "llama31-8b", "--reduced",
        "--layers", "10", "--d-model", "640", "--ff", "2560",
        "--vocab", "16384",
        "--steps", str(args.steps), "--batch", str(args.batch),
        "--seq", str(args.seq), "--lr", "1e-3", "--opt", "adamw8bit",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50",
        "--log-every", "10", "--device", args.device,
    ])


if __name__ == "__main__":
    main()
