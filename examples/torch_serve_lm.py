"""Serving example on the PyTorch port: batched requests with
continuous-batching lanes (the counterpart of ``examples/serve_lm.py``).

qwen2-1.5b's reduced config (2 layers, d_model 96, QKV bias, tied
embeddings), random weights; every prompt pass goes through the
flash-attention kernel on the card.

    PYTHONPATH=src python examples/torch_serve_lm.py              # the card
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""

import argparse
import sys

from repro_torch.launch.serve import main as serve_main

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    args = ap.parse_args()
    sys.exit(serve_main(["--arch", "qwen2-1.5b", "--reduced",
                         "--requests", "6", "--lanes", "2",
                         "--max-new", "12"]
                        + (["--device", args.device] if args.device else [])))
