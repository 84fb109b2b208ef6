"""Device resolution for the port's entry points.

Counterpart in spirit of `tpu_tts.parallel.maybe_force_platform`: the
entry points default to the card, the tests ask for the CPU, and a request
for CUDA on a machine without it raises instead of carrying on elsewhere.
"""

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`cuda` unless told otherwise, with its index made explicit; raises if
    CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is False; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
