"""Multi-device execution on torch.distributed: the process group and the
mesh (distributed.py), the sharded MSMs (sharded_msm.py), the sharded Fr
FFT (sharded_fft.py) and the multi-process dry run (dryrun.py)."""
