"""End-to-end training example on the PyTorch port: train the paper's KNN-LM
base model class (knnlm-247m; reduced unless ``--full``) for a few hundred
steps and checkpoint it, as ``examples/train_e2e.py`` does with the JAX
package.

    PYTHONPATH=src python examples/train_e2e_torch.py [--steps 200] [--full]
    PYTHONPATH=src python examples/train_e2e_torch.py --device cpu --steps 5

Runs on the card unless ``--device cpu``; checkpoints go to
``repro_torch_ckpt`` under the temporary directory (``$TMPDIR``).
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch import train as train_mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true",
                    help="full 247M config (on the card)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    argv = ["--arch", "knnlm-247m", "--steps", str(args.steps),
            "--batch", "8", "--seq", "128", "--device", args.device,
            "--ckpt-dir", os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"),
            "--ckpt-every", str(max(args.steps // 2, 1))]
    if not args.full:
        argv.append("--reduced")
    train_mod.main(argv)


if __name__ == "__main__":
    main()
