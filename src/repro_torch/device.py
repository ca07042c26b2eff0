"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: the card unless ``"cpu"`` is asked.

    A CUDA request on a machine without a card raises instead of running on
    the CPU.  On the card this also turns off the reduced-precision matmul
    shortcuts (TF32 for float32 products, reduced-precision reductions for
    bfloat16 ones) process-wide, so a float32 product is float32 as on the
    JAX side and a bfloat16 product accumulates in float32.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev
