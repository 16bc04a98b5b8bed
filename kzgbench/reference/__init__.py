"""The benchmark's plain reference: BLS12-381, KZG commitments and proofs,
EIP-4844 blobs and EIP-7594 cells in Python integers, after the consensus
specs. It imports nothing of kzg_tpu_torch, of the JAX package kzg_tpu, or
of JAX, and takes nothing the program made: it reads the trusted setup
file itself."""
