"""End-to-end training example on the PyTorch port (the counterpart of
``examples/train_lm.py``): train a small LM for a few hundred steps with
checkpointing, an injected node failure, and automatic recovery -- the
full production loop at laptop scale.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200]   # the card
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu \\
        --arch musicgen-medium --steps 20
"""

import argparse
import sys
import tempfile

from repro_torch.launch.train import main as launch_main

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as d:
        rc = launch_main([
            "--arch", args.arch, "--reduced",
            "--steps", str(args.steps),
            "--batch", "8", "--seq", "64",
            "--ckpt-dir", d, "--ckpt-every", "25", "--log-every", "10",
            # inject a "node failure" mid-run: the launcher restores the
            # last checkpoint (with the data-pipeline position) and resumes
            "--fail-at", str(args.steps // 2),
        ] + (["--device", args.device] if args.device else []))
    sys.exit(rc)
