"""Device selection: the device a run computes on is named, never guessed.

Counterpart of ``parfastaai_tpu.cli._init_backend``: there is no global
backend switch and no silent move to the CPU when CUDA is missing.
"""

from __future__ import annotations

import torch

from .parallel import distributed
from .types import ErrorCode, PFAAIError


def resolve_device(name: str) -> torch.device:
    """``"cuda"`` when CUDA is available, ``"cpu"`` when asked for; anything
    else raises PFAAIError(CONSTRUCT_ERROR).  In a multi-process run
    (``parallel.distributed``) a rank's CUDA device is
    ``cuda:rank_device_index()``, made the current one."""
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise PFAAIError(
            ErrorCode.CONSTRUCT_ERROR, f"unknown device {name!r} (cuda or cpu)"
        )
    if not torch.cuda.is_available():
        raise PFAAIError(
            ErrorCode.CONSTRUCT_ERROR,
            "--device cuda: CUDA is not available on this machine "
            "(pass --device cpu to run on the CPU)",
        )
    if distributed.world_size() > 1:
        index = distributed.rank_device_index()
        torch.cuda.set_device(index)
        return torch.device("cuda", index)
    return torch.device("cuda")
