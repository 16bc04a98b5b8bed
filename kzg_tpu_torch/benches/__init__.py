"""The port's bench scripts, the counterparts of the JAX package's benches/:
the per-op table (run_benches), the fixed-base MSM's stage split
(msm_stages) and the gather probe (gather_micro). Each runs on the card:

    python3 -m kzg_tpu_torch.benches.run_benches
    python3 -m kzg_tpu_torch.benches.msm_stages
    python3 -m kzg_tpu_torch.benches.gather_micro
"""
