"""Pytree checkpointing (npz, no external deps): the port of
``repro/checkpoint/io.py``, file for file.

Flat key paths ("layers/attn/wq") -> arrays, metadata as JSON bytes under
``__meta__``: each package loads the other's files. bf16 leaves are
written as the reference writes them (numpy has no bf16: two raw bytes a
value, dtype ``|V2``) and read back from that as ``torch.bfloat16``.
Loaded leaves are CPU tensors.
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_BF16_FILE_DTYPE = np.dtype("V2")


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(_BF16_FILE_DTYPE)
        return x.numpy()
    return np.asarray(x)


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype == _BF16_FILE_DTYPE:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = _to_numpy(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _to_tensor(val)

    def fix_lists(node):
        if isinstance(node, dict):
            keys = list(node)
            if keys and all(k.isdigit() for k in keys):
                return [fix_lists(node[str(i)]) for i in range(len(keys))]
            return {k: fix_lists(v) for k, v in node.items()}
        return node
    return fix_lists(root)


def save_checkpoint(path: str, tree, metadata: Optional[dict] = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    if metadata is not None:
        flat["__meta__"] = np.frombuffer(
            json.dumps(metadata).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def load_checkpoint(path: str) -> Tuple[Any, Optional[dict]]:
    """Load a checkpoint written by either package's ``save_checkpoint``.

    Raises ``FileNotFoundError`` when the file is missing and
    ``ValueError`` (naming the path) when it is not a readable npz
    archive or its metadata is not valid JSON.
    """
    if not path.endswith(".npz"):
        path = path + ".npz"
    try:
        with np.load(path) as npz:
            data = dict(npz)
    except FileNotFoundError:
        raise
    except (OSError, ValueError, EOFError, zipfile.BadZipFile) as e:
        raise ValueError(
            f"corrupt or unreadable checkpoint {path!r}: {e}") from e
    meta = None
    if "__meta__" in data:
        try:
            meta = json.loads(bytes(data.pop("__meta__").tobytes()).decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(
                f"corrupt checkpoint metadata in {path!r}: {e}") from e
    return _unflatten(data), meta
