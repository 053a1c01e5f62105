"""Entry points of the port, run as modules:

    python -m taste_spokenlm_tpu_torch.scripts.train --tiny --synthetic
    python -m taste_spokenlm_tpu_torch.scripts.profile_fusion [--s3]
    python -m taste_spokenlm_tpu_torch.scripts.profile_lmhead

Counterparts of the JAX repo's scripts/train.py, scripts/profile_fusion.py
and scripts/profile_lmhead.py.  Each runs on CUDA unless given `--device
cpu`; the profiling tools have `main(argv) -> dict` and print one line per
layout or head.
"""
