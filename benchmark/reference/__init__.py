"""Plain float32 PyTorch reference of FCD-GAN (Cwuwhu/FCD-GAN-pytorch), the
yardstick that decides a benchmark run's ``correct``.

It imports torch and numpy only: nothing of the program under test, no
kernel, no cache, no batching of its own. Every matmul and convolution runs
in float32 with TF32 off (``strict_fp32``). ``precision="fp8"`` rounds each
convolution's operands to float8 e4m3 (one scale per tensor, the common
fp8 recipe), the control that a bf16 program has to stay clear of.
"""

import torch


def strict_fp32() -> None:
    """No TF32 in float32 matmuls and convolutions on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
