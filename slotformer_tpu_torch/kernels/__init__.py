"""Hand-written CUDA kernels for Hopper, the counterparts of ``slotformer_tpu/ops``.

Each kernel module holds the wrapper, its plain PyTorch version and a launch
counter; ``build`` compiles ``csrc/`` on first use.
"""
