"""PyTorch/CUDA port of the FCD-GAN change-detection system for NVIDIA Hopper.

A package of its own beside the JAX package ``fcdgan_tpu``, which stays the
reference. It imports ``torch`` and never ``jax``, and nothing of
``fcdgan_tpu``: what it needs of that package's framework-free modules it
keeps as its own trimmed copies, each under the same module path, and the
same holds for the native tile I/O library (``native/tileio.cpp``).

Ported: serving (``tools/infer.py``), USSS, WSSS and RSSS training
(``demos/``), and their data feeds (``data/device_cache.py``,
``data/pipeline.py``, ``native/``). Six hand-written CUDA kernels sit on
these paths (``ops/`` with their sources in ``csrc/``): conv3x3, pool_bwd,
fused_ssim, channel_sums, channel_sums_pair and phase_pool.

Entry points run on ``cuda`` unless the caller asks for ``cpu``; see
``utils/device.py``.
"""
