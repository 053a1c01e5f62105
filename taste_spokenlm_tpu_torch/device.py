"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU.  A missing CUDA
device is an error, never a silent fallback: a run that was meant to measure
or serve on the card must not quietly run the plain CPU versions instead.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """None -> "cuda".  Raises when a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev
