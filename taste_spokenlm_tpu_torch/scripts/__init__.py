"""Measurement entry points of the port, run as modules:

    python -m taste_spokenlm_tpu_torch.scripts.profile_fusion [--s3]
    python -m taste_spokenlm_tpu_torch.scripts.profile_lmhead

Counterparts of the JAX repo's scripts/profile_fusion.py and
scripts/profile_lmhead.py.  Each has `main(argv) -> dict`, runs on CUDA
unless given `--device cpu`, and prints one line per layout or head.
"""
