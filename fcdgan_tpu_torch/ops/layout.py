"""NHWC views of the port's channels_last NCHW tensors, for the kernels.

Every activation of the port lives in channels_last memory, whose NHWC view
is contiguous and free. A gradient may reach a kernel's backward in another
layout; ``nhwc`` then copies it, and counts the copy in the recorder's
counter ``layout.nhwc_copies`` (``tools/profile_train.py`` reports it per
step).
"""

from __future__ import annotations

import torch

from ..utils.timing import count


def nhwc(t: torch.Tensor) -> torch.Tensor:
    """The contiguous NHWC view of NCHW ``t``, copied (and counted) when its
    memory is not channels_last."""
    v = t.permute(0, 2, 3, 1)
    if v.is_contiguous():
        return v
    count("layout.nhwc_copies")
    return v.contiguous()
