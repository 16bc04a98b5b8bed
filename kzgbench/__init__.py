"""The benchmark of kzg_tpu_torch, the PyTorch and CUDA port: cells of
EIP-4844 and EIP-7594 calls at block size on one H100, driven by data
files found by name from BENCHMARK.json, and judged by a plain reference
(reference/) that imports nothing of the program. See README.md."""
