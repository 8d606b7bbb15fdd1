"""PyTorch/CUDA port of the FCD-GAN change-detection system for NVIDIA Hopper.

A package of its own beside the JAX package ``fcdgan_tpu``, which stays the
reference. It imports ``torch`` and never ``jax``, and nothing of
``fcdgan_tpu``: what it needs of that package's framework-free modules it
keeps as its own trimmed copies, each under the same module path.

Ported so far: scene serving (``tools/infer.py``, mode ``scene``) and USSS
training (``demos/demo_usss.py``). Three hand-written CUDA kernels sit on
these paths: ``ops/conv3x3.py`` (the narrow full-resolution 3x3 convs),
``ops/pool_bwd.py`` (every 2x2 max-pool backward) and ``ops/fused_ssim.py``
(each MS-SSIM level), with their sources in ``csrc/``.

Entry points run on ``cuda`` unless the caller asks for ``cpu``; see
``utils/device.py``.
"""
