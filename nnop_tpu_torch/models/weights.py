"""Parameter trees from numpy: the JAX package's params and npz checkpoints.

Counterpart of nnop_tpu/models/weights.py (its flat-key npz checkpoints,
`save_checkpoint`/`load_checkpoint`). The HF safetensors loader waits
until published checkpoints are available to the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nnop_tpu_torch.ops.quantization import QTensor, QTensor4


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """numpy array -> tensor. bf16 arrays (ml_dtypes.bfloat16, as JAX
    hands them out, or the 2-byte void type they are stored as in npz)
    go through a uint16 view, and fp8 arrays (ml_dtypes.float8_e4m3fn)
    through a uint8 view, since torch.from_numpy rejects both."""
    a = np.array(a)  # a writable copy: torch shares its memory
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2):
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    elif a.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(a)
    return t.to(device) if device is not None else t


def params_from_numpy(tree, device=None):
    """The JAX package's parameter tree (nested dicts and lists of numpy
    arrays, e.g. `jax.tree.map(np.asarray, params)`) -> the same tree of
    tensors on `device`. Its quantized leaves (the JAX QTensor and
    QTensor4 dataclasses, holding numpy arrays) become this package's,
    recognized by their fields, byte for byte."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    if dataclasses.is_dataclass(tree):
        fields = {f.name for f in dataclasses.fields(tree)}
        if fields == {"values", "scale", "axis"}:
            return QTensor(tensor_from_numpy(tree.values, device),
                           tensor_from_numpy(tree.scale, device), int(tree.axis))
        if fields == {"packed", "scale", "group", "pack_block"}:
            return QTensor4(tensor_from_numpy(tree.packed, device),
                            tensor_from_numpy(tree.scale, device), int(tree.group),
                            int(tree.pack_block))
        raise TypeError(f"unknown parameter leaf {type(tree).__name__}")
    return tensor_from_numpy(tree, device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy on the host. bf16 becomes the 2-byte void type that
    npz holds for the JAX package's bf16 arrays (tensor_from_numpy reads
    it back bit for bit); other dtypes convert as they are."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def save_checkpoint(path: str, params):
    """Write a parameter tree as the JAX package's flat-key npz
    (nnop_tpu/models/weights.py:save_checkpoint: keys like "layers/0/wq",
    list indices as key parts), which its load_checkpoint and this
    package's read."""
    flat = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}{i}/")
        else:
            flat[prefix[:-1]] = tensor_to_numpy(tree)

    walk(params, "")
    np.savez(path, **flat)


def load_checkpoint(path: str, device=None):
    """Load a flat-key npz checkpoint written by the JAX package
    (nnop_tpu.models.weights.save_checkpoint: keys like "layers/0/wq")
    into a parameter tree on `device`. Numeric key parts are list
    indices."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    tree: dict = {}
    for key in data.files:
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = tensor_from_numpy(data[key], device)

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(tree)
