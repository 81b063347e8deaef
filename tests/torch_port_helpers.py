"""Shared helpers of the ``tests/test_torch_*.py`` parity tests.

Both sides get the same numbers: inputs and noise are drawn with numpy and
handed to the JAX module and to its PyTorch port; the JAX module's random
init is carried to the port with ``slotformer_tpu_torch.runtime.weights``.
Both run on the CPU in float32 (``tests/conftest.py`` pins JAX matmuls to
float32).
"""

from __future__ import annotations

import os

import jax
import numpy as np
import torch

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

# single modules: float32 reassociation noise between XLA and torch CPU
RTOL, ATOL = 1e-4, 1e-5


def rng(seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)


def randn(r: np.random.Generator, *shape) -> np.ndarray:
    return r.standard_normal(shape).astype(np.float32)


def jax_init(module, *args, seed: int = 0, **kwargs) -> dict:
    """The module's random flax params as nested dicts of numpy arrays."""
    variables = module.init(jax.random.PRNGKey(seed), *args, **kwargs)
    return jax.tree.map(np.asarray, dict(variables["params"]))


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))  # a writable copy


def close(got, want, rtol=RTOL, atol=ATOL) -> None:
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def golden_group(tag: str, fname: str = "model_goldens.npz"):
    """(sd, inputs, outputs) of a golden group, as numpy dicts."""
    store = np.load(os.path.join(GOLDEN, fname))
    sd, ins, outs = {}, {}, {}
    for k in store.files:
        if k.startswith(tag + "/"):
            _, kind, name = k.split("/", 2)
            {"sd": sd, "in": ins, "out": outs}[kind][name] = store[k]
    assert sd and ins and outs, f"missing golden group {tag}"
    return sd, ins, outs


def state_dict(sd_np: dict) -> dict:
    return {k: t(v) for k, v in sd_np.items()}
