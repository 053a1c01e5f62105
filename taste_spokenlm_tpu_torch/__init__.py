"""PyTorch/CUDA port of taste_spokenlm_tpu.

The JAX package beside this one stays the reference.  The port mirrors its
layout (config, ops, models, convert) and runs the TPU kernels of its path as
hand-written CUDA kernels for Hopper (`csrc/*.cu`, bound in `kernels/`).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA they raise instead of falling back.
"""

from taste_spokenlm_tpu_torch.config import TasteConfig  # noqa: F401
from taste_spokenlm_tpu_torch.pretrained import (from_pretrained,  # noqa: F401
                                                 save_pretrained)

__all__ = ["TasteConfig", "from_pretrained", "save_pretrained"]
