"""Plain float32 PyTorch references of the benchmarked models.

Written for the benchmark from the published model descriptions (SAVi,
StoSAVi, SlotFormer) and the reference key layout; they import nothing of
the program under test. Each module ``<name>.py`` is named by a
configuration's ``"reference"`` key and exposes ``build(params) ->
nn.Module``.
"""
