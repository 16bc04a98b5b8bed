"""The port's bench scripts, the counterparts of the JAX package's benches/:
the fixed-base MSM's stage split (msm_stages), the gather probe
(gather_micro) and the weak scaling of the sharded fixed-base MSM over
processes (scaling_2proc). Each runs on the card:

    python3 -m kzg_tpu_torch.benches.msm_stages
    python3 -m kzg_tpu_torch.benches.gather_micro
    python3 -m kzg_tpu_torch.benches.scaling_2proc
"""
