"""Entry points of the port, run as modules:

    python -m taste_spokenlm_tpu_torch.scripts.train --tiny --synthetic
    python -m taste_spokenlm_tpu_torch.scripts.profile_fusion [--s3]
    python -m taste_spokenlm_tpu_torch.scripts.profile_lmhead
    python -m taste_spokenlm_tpu_torch.scripts.create_seed_model --tiny
    python -m taste_spokenlm_tpu_torch.scripts.convert_checkpoint ...
    python -m taste_spokenlm_tpu_torch.scripts.generate_audio ...
    python -m taste_spokenlm_tpu_torch.scripts.extract_vq --synthetic ...
    python -m taste_spokenlm_tpu_torch.scripts.eval --synthetic ...

Counterparts of the JAX repo's scripts of the same names.  Each runs on
CUDA unless given `--device cpu` and has `main(argv)`; the profiling tools
print one line per layout or head.
"""
