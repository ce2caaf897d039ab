"""Device resolution for the port's entry points.

Every entry point runs on ``cuda`` unless the caller asks for the CPU. With no
CUDA device and no explicit ``device="cpu"`` it raises: the port never runs on
the CPU by accident.
"""

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Raises if a CUDA device is asked for and absent.

    Also pins float32 matmuls and convolutions to full float32 (no TF32), so
    the port's float32 matches the JAX package's ``precision="highest"``.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "artspeech_tpu_torch runs on a CUDA device unless device='cpu' is "
            "passed, and no CUDA device is available"
        )
    return dev
