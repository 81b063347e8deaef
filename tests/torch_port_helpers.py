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


# ---- SlotFormer training / test_vp (tests/test_torch_slotformer_training.py,
# tests/test_torch_test_vp.py)

def sf_cfg(**loss_dict) -> dict:
    """A tiny dropout-free SlotFormer (3 burn-in + 4 rollout frames, 16x16,
    4 slots of 16) with the image loss on; ``loss_dict`` picks the branch."""
    return dict(
        resolution=(16, 16),
        slot_dict=dict(num_slots=4, slot_size=16),
        dec_dict=dict(dec_channels=(16, 8, 8), dec_resolution=(4, 4), dec_ks=3,
                      dec_norm=""),
        rollout_dict=dict(num_slots=4, slot_size=16, history_len=3, t_pe="sin",
                          slots_pe="", d_model=16, num_layers=1, num_heads=2,
                          ffn_dim=32, norm_first=True, dropout=0.0),
        loss_dict=dict(rollout_len=4, use_img_recon_loss=True, **loss_dict),
    )


def sf_batch(seed: int = 0, vid_len: bool = False, B: int = 2) -> dict:
    """slots [B, 7, 4, 16], img [B, 7, 16, 16, 3] (+ vid_len) for ``sf_cfg``."""
    r = rng(seed)
    batch = {"slots": randn(r, B, 7, 4, 16), "img": randn(r, B, 7, 16, 16, 3)}
    if vid_len:
        batch["vid_len"] = np.array([5, 7] * (B // 2), np.int32)
    return batch


def tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def write_params(path, attrs: dict) -> str:
    """A config file of the port with ``attrs`` as its class attributes."""
    with open(path, "w") as f:
        f.write("from slotformer_tpu_torch.runtime.params import BaseParams\n\n\n"
                "class SlotFormerParams(BaseParams):\n"
                + "".join(f"    {k} = {v!r}\n" for k, v in attrs.items()))
    return str(path)
