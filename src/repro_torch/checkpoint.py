"""Checkpoints in the JAX package's format, and the weight carry into the port.

The format (`repro/checkpoint/io.py`) is one `arrays.npz` whose keys are the
pytree paths joined by "/", plus `manifest.json` with each key's shape and
original dtype; bf16 leaves are stored upcast to fp32 (lossless). Reading and
writing need numpy alone, and each package reads what the other writes.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten, unflatten

_TORCH_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16,
    "int32": torch.int32, "int64": torch.int64, "int8": torch.int8, "uint8": torch.uint8,
}


def _to_tensor(arr: Any, dtype_name: str, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":        # ml_dtypes arrays carried from JAX
        arr = arr.astype(np.float32)
    if dtype_name not in _TORCH_DTYPES:
        raise ValueError(f"unsupported checkpoint dtype {dtype_name!r}")
    t = torch.from_numpy(np.array(arr))    # a writable copy
    return t.to(dtype=_TORCH_DTYPES[dtype_name], device=device)


def params_from_numpy(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """JAX params as nested numpy arrays (e.g. `jax.tree.map(np.asarray,
    params)`) -> the port's nested dict of tensors, same keys and dtypes."""
    flat = flatten(tree)
    return unflatten({
        k: _to_tensor(v, np.asarray(v).dtype.name, device) for k, v in flat.items()
    })


def load_checkpoint(path: str, device="cpu") -> Tuple[Dict[str, Any], dict]:
    """Read `path/{arrays.npz,manifest.json}` -> (params, manifest), each
    leaf cast back to the dtype the manifest records."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        flat = {
            k: _to_tensor(data[k], manifest["keys"][k]["dtype"], device)
            for k in data.files
        }
    for k, meta in manifest["keys"].items():
        if list(flat[k].shape) != list(meta["shape"]):
            raise ValueError(f"{k}: shape {tuple(flat[k].shape)} != manifest {meta['shape']}")
    return unflatten(flat), manifest


def save_checkpoint(path: str, params: Dict[str, Any], step: int = 0,
                    extra: Optional[dict] = None) -> None:
    """Write `params` (a dict tree of tensors) to `path/{arrays.npz,
    manifest.json}`; the arrays go to a temporary file renamed into place."""
    os.makedirs(path, exist_ok=True)
    flat = {k: t.detach().cpu() for k, t in flatten(params).items()}
    arrays = {k: (t.float() if t.dtype == torch.bfloat16 else t).numpy() for k, t in flat.items()}
    manifest = {
        "step": step,
        "keys": {k: {"shape": list(t.shape), "dtype": str(t.dtype).replace("torch.", "")}
                 for k, t in flat.items()},
        "extra": extra or {},
    }
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp.npz")
    os.close(fd)
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(path, "arrays.npz"))
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
