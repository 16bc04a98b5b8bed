"""Run one benchmark cell of kzg_tpu_torch once and print its result line.

    python3 kzgbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, printing no result, without enough CUDA devices for the
cell, when the program cannot be imported, or when jax, jaxlib, flax or
the JAX package kzg_tpu is loaded in this process once the window closes.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kzgbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
