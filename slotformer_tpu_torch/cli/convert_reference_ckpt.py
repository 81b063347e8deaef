"""Convert a checkpoint into the port's: the port of
``slotformer_tpu/cli/convert_reference_ckpt.py``.

Two sources:

  * a reference (pairlab/SlotFormer) ``.pth``, ``{'state_dict': {dotted torch
    key: tensor}}`` or a bare state_dict: the port keeps the reference's key
    layout, so its tensors load by name;
  * a JAX package checkpoint ``.ckpt.pkl`` (``{'state_dict': flax tree,
    'opt_state', 'step', 'format_version', ...}``), its tree carried over by
    ``runtime.weights.from_jax_params``. The file also pickles the optax
    optimizer state, whose classes would make a plain ``pickle.load`` import
    optax and JAX; it is read with a restricted unpickler that admits numpy
    arrays and builtins and stands a placeholder in for any other class.
    What the JAX package's ``load_checkpoint`` refuses is refused here: a
    ``format_version`` above 2, and an unstamped file with deconvolutions
    (their kernels were stored in another layout before the stamp).

The model named by ``--params`` is built (randomly initialised); every
tensor of the source replaces the model's of the same name and a shape that
differs raises. The model's tensors the source lacks stay at their init and
are listed, as the JAX CLI reports its coverage; the source's tensors the
model has no place for (the reference StoSAVi's unused
``prior_slot_layer``, for one) are listed and left out, as the JAX CLI
maps only what its model holds. The result is written as the port's
``{'state_dict': ...}`` ``.pth``, usable wherever a trained checkpoint is.

Usage:
    python -m slotformer_tpu_torch.cli.convert_reference_ckpt \\
        --params slotformer_tpu_torch/configs/stosavi_clevrer_params.py \\
        --ref_ckpt model.pth|model_<step>.ckpt.pkl --save_path savi.pth
"""

from __future__ import annotations

import argparse
import pickle
from typing import Dict, List, Mapping, Tuple

import torch

FORMAT_VERSION = 2  # the JAX package's checkpoint format this reads

_NUMPY = {("numpy", "ndarray"), ("numpy", "dtype"),
          ("numpy.core.multiarray", "_reconstruct"),
          ("numpy._core.multiarray", "_reconstruct"),
          ("numpy.core.multiarray", "scalar"),
          ("numpy._core.multiarray", "scalar"),
          ("numpy.core.numeric", "_frombuffer"),
          ("numpy._core.numeric", "_frombuffer")}
_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int", "float",
             "complex", "bool", "str", "bytes", "bytearray", "slice", "object"}


class StandIn:
    """What a class of the pickle outside numpy and the builtins (optax's
    states, for one) becomes: its arguments and state, kept as read."""

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.args = args
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in _NUMPY or (module == "numpy.dtypes"
                                        and name.endswith("DType")):
            return super().find_class(module, name)
        if module == "builtins" and name in _BUILTINS:
            return super().find_class(module, name)
        if (module, name) in {("collections", "OrderedDict"),
                              ("copyreg", "_reconstructor")}:
            return super().find_class(module, name)
        return type(name, (StandIn,), {"__module__": module})


def _has_deconv(tree) -> bool:
    if isinstance(tree, Mapping):
        return any(str(k).startswith("ConvTranspose") or _has_deconv(v)
                   for k, v in tree.items())
    return False


def read_jax_checkpoint(path: str) -> dict:
    """A JAX package checkpoint's ``state_dict`` (nested dicts of numpy
    arrays), ``step`` and ``format_version``, read without importing JAX."""
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    ver = payload.get("format_version")
    if ver is not None and ver > FORMAT_VERSION:
        raise ValueError(f"{path}: checkpoint format_version {ver} is newer "
                         f"than {FORMAT_VERSION}, the one this reads")
    if ver is None and _has_deconv(payload.get("state_dict", {})):
        raise ValueError(
            f"{path}: checkpoint predates the format_version stamp and holds "
            "ConvTranspose kernels, which such files may store in the "
            "round-1 layout ([kH, kW, in, out]); re-save it with the JAX "
            "package's save_checkpoint (format_version 2) or convert the "
            "reference .pth instead")
    return {k: payload.get(k) for k in ("state_dict", "step", "format_version")}


def source_state_dict(params, path: str) -> Dict[str, torch.Tensor]:
    """The source checkpoint's tensors in the reference key layout."""
    if path.endswith(".pkl"):
        from ..runtime.weights import from_jax_params

        return from_jax_params(read_jax_checkpoint(path)["state_dict"],
                               params.model, params)
    ckp = torch.load(path, map_location="cpu", weights_only=True)
    return dict(ckp.get("state_dict", ckp))


def merge(init: Mapping[str, torch.Tensor], src: Mapping[str, torch.Tensor]
          ) -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """The model's state_dict ``init`` with ``src``'s tensors in place of
    its own: (merged, the model's names the source lacks, the source's names
    the model lacks). A shape that differs raises."""
    merged, unmapped = {}, []
    for k, v in init.items():
        if k not in src:
            merged[k] = v
            unmapped.append(k)
            continue
        s = src[k]
        if tuple(s.shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: source {tuple(s.shape)} "
                             f"vs model {tuple(v.shape)}: check the config "
                             "matches the source run")
        merged[k] = s.detach().to(v.dtype).clone()
    return merged, unmapped, sorted(set(src) - set(init))


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(
        description="reference .pth or JAX .ckpt.pkl -> the port's .pth")
    parser.add_argument("--params", required=True, help="the model's config")
    parser.add_argument("--ref_ckpt", required=True,
                        help="a reference .pth or a JAX package .ckpt.pkl")
    parser.add_argument("--save_path", required=True, help="output .pth")
    args = parser.parse_args(argv)

    from ..models import build_model
    from ..runtime import load_params, save_checkpoint

    params = load_params(args.params)
    torch.manual_seed(0)
    model = build_model(params, device="cpu")
    merged, unmapped, ignored = merge(model.state_dict(),
                                      source_state_dict(params, args.ref_ckpt))
    model.load_state_dict(merged)
    n = len(merged)
    print(f"[convert] mapped {n - len(unmapped)}/{n} tensors")
    if unmapped:
        print("[convert] WARNING: left at random init (no source "
              "equivalent):")
        for k in unmapped[:20]:
            print(f"  {k}")
    if ignored:
        print(f"[convert] ignored {len(ignored)} source tensors the model has "
              f"no place for: {', '.join(ignored[:20])}")
    save_checkpoint(args.save_path, merged)
    print(f"[convert] saved -> {args.save_path}")
    return args.save_path


if __name__ == "__main__":
    main()
