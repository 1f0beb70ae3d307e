"""Serving example on the PyTorch port: batched requests with
continuous-batching lanes (the counterpart of ``examples/serve_lm.py``).

qwen2-1.5b's reduced config by default (2 layers, d_model 96, QKV bias,
tied embeddings), or another token-frontend arch's (``--arch
dbrx-132b``: the MoE family, 8 experts top-4; ``--arch
deepseek-v2-236b``: MLA attention with a latent cache and 2 shared
experts), random weights; every prompt pass goes through the
flash-attention kernel on the card.  deepseek-v2-smoke's head dims (q·k
24, v 16) are outside the card's kernels, which take MLA's full-width
192 / 128 only: serve it with ``--device cpu``.

    PYTHONPATH=src python examples/torch_serve_lm.py              # the card
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
    PYTHONPATH=src python examples/torch_serve_lm.py --arch dbrx-132b \\
        --device cpu
    PYTHONPATH=src python examples/torch_serve_lm.py \\
        --arch deepseek-v2-236b --device cpu
"""

import argparse
import sys

from repro_torch.launch.serve import main as serve_main

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    args = ap.parse_args()
    sys.exit(serve_main(["--arch", args.arch, "--reduced",
                         "--requests", "6", "--lanes", "2",
                         "--max-new", "12"]
                        + (["--device", args.device] if args.device else [])))
