"""PyTorch/CUDA port of the FCD-GAN change-detection system for NVIDIA Hopper.

A package of its own beside the JAX package ``fcdgan_tpu``, which stays the
reference. It imports ``torch`` and never ``jax``, and nothing of
``fcdgan_tpu``: what it needs of that package's framework-free modules it
keeps as its own trimmed copies, each under the same module path.

This slice ports the scene serving path (``tools/infer.py``, mode ``scene``):
the eval-mode siamese Segmentor over a device-resident scene pair, with the
narrow full-resolution 3x3 convolutions on a hand-written CUDA kernel
(``ops/conv3x3.py`` + ``csrc/conv3x3.cu``).

Entry points run on ``cuda`` unless the caller asks for ``cpu``; see
``utils/device.py``.
"""
