"""PyTorch / CUDA port of ``slotformer_tpu`` for NVIDIA Hopper (H100).

The JAX package ``slotformer_tpu`` is the reference: every module here has a
counterpart there, under the same subpackage name (``ops/`` becomes
``kernels/``), and is tested against it on the CPU with the same weights and
inputs. This package never imports ``jax``, ``flax`` or ``slotformer_tpu``.

Conventions:
  * parameter names follow the reference torch checkpoints' key layout, so a
    reference ``{'state_dict': ...}`` loads with ``load_state_dict``;
  * public functions keep the JAX package's layouts (NHWC images
    ``[B, T, H, W, 3]``, attention ``[B, N, S]``); modules work in NCHW inside;
  * entry points run on ``device="cuda"`` unless the caller passes
    ``device="cpu"``; every hand-written kernel has a plain PyTorch version
    that runs only for CPU tensors.
"""
