"""Parameter trees: the JAX package's params and npz checkpoints, and
local HuggingFace checkpoints.

Counterpart of nnop_tpu/models/weights.py: its flat-key npz checkpoints
(`save_checkpoint`/`load_checkpoint`), and its HF loader (`load_hf_llama`,
`config_from_hf`, the family-aware name map `_hf_layer_map`) with the
same semantics and names. The safetensors format is parsed here (an
8-byte little-endian header length, a JSON header, then the raw tensors;
BF16, F16 and F32), so the port needs no `safetensors` package:
`read_safetensors` streams a shard's tensors one at a time straight to
the target device, and `save_safetensors` writes the format.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct

import numpy as np
import torch

from nnop_tpu_torch.models.llama import LlamaConfig
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


# ---- HuggingFace safetensors checkpoints --------------------------------

_ST_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str, device=None):
    """Yield (name, tensor) for each tensor of one .safetensors file, in
    file order, each read from disk into its own host buffer and moved to
    `device` before the next is read (so a shard never sits whole in host
    memory). Dtypes BF16, F16 and F32; any other raises ValueError."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        data_start = 8 + n
        for name, info in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0]):
            if info["dtype"] not in _ST_DTYPES:
                raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}; "
                                 f"supported: {sorted(_ST_DTYPES)}")
            begin, end = info["data_offsets"]
            buf = bytearray(end - begin)
            f.seek(data_start + begin)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{path}: tensor {name} is truncated")
            dtype = _ST_DTYPES[info["dtype"]]
            t = (torch.frombuffer(buf, dtype=dtype) if buf
                 else torch.empty(0, dtype=dtype)).reshape(info["shape"])
            yield name, t.to(device) if device is not None else t


def save_safetensors(path: str, tensors: dict):
    """Write {name: tensor} as one .safetensors file (bf16, f16 or f32
    tensors, any device): the header padded with spaces to 8 bytes, as
    the reference writer pads it, then the tensors in name order."""
    header, offset = {}, 0
    for name in sorted(tensors):
        t = tensors[name]
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"tensor {name} has dtype {t.dtype}; supported: "
                             f"{sorted(_ST_DTYPES)}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in sorted(tensors):
            t = tensors[name].detach().contiguous().cpu()
            f.write(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")


def _hf_layer_map(i: int, cfg: LlamaConfig | None = None):
    """HF name map for one decoder layer, family-aware:

    * Llama/Mistral/Qwen: mlp_norm is `post_attention_layernorm` (it
      PRE-cedes the MLP despite the name).
    * Gemma-2 (post_norms): `post_attention_layernorm` is the attention
      POST-norm; the MLP pre/post norms are `pre_feedforward_layernorm` /
      `post_feedforward_layernorm`.
    * Qwen2 (qkv_bias): q/k/v biases ride along.
    * Mixtral (n_experts): the router is `block_sparse_moe.gate`; the
      experts are stacked by load_hf_llama.

    Gemma's (1+w) norm convention matches rms_offset=1 with weights
    stored as w: no transform on load.
    """
    p = f"model.layers.{i}."
    m = {
        "attn_norm": p + "input_layernorm.weight",
        "wq": p + "self_attn.q_proj.weight",
        "wk": p + "self_attn.k_proj.weight",
        "wv": p + "self_attn.v_proj.weight",
        "wo": p + "self_attn.o_proj.weight",
        "mlp_norm": p + "post_attention_layernorm.weight",
        "w_gate": p + "mlp.gate_proj.weight",
        "w_up": p + "mlp.up_proj.weight",
        "w_down": p + "mlp.down_proj.weight",
    }
    if cfg is not None and cfg.post_norms:
        m["attn_post_norm"] = p + "post_attention_layernorm.weight"
        m["mlp_norm"] = p + "pre_feedforward_layernorm.weight"
        m["mlp_post_norm"] = p + "post_feedforward_layernorm.weight"
    if cfg is not None and cfg.qkv_bias:
        m["bq"] = p + "self_attn.q_proj.bias"
        m["bk"] = p + "self_attn.k_proj.bias"
        m["bv"] = p + "self_attn.v_proj.bias"
    if cfg is not None and cfg.n_experts is not None:
        for key in ("w_gate", "w_up", "w_down"):
            del m[key]
        m["w_router"] = p + "block_sparse_moe.gate.weight"
    return m


def load_hf_llama(path: str, cfg: LlamaConfig, dtype=None, device=None):
    """Load a local HF Llama-family checkpoint directory (its .safetensors
    shards) into a params tree of `dtype` (default cfg.dtype) on `device`.

    HF stores projection weights as (out_features, in_features); this tree
    uses (in, out), so projections (the keys starting with "w") are
    transposed on load. Mixtral's per-expert w1 / w3 / w2 stack into
    w_gate / w_up (E, d, h) and w_down (E, h, d). An untied config whose
    checkpoint has no lm_head takes the embedding's transpose. The shards
    are read in name order, one tensor at a time, each straight onto the
    device; tensors the config does not use are skipped.
    """
    dtype = dtype or cfg.dtype
    shards = [os.path.join(path, f) for f in sorted(os.listdir(path))
              if f.endswith(".safetensors")]
    if not shards:
        raise FileNotFoundError(f"no .safetensors files in {path}")
    # HF name -> (the dict it goes into, its key there, its expert or None, transpose)
    params = {"layers": [{} for _ in range(cfg.n_layers)]}
    where = {"model.embed_tokens.weight": (params, "embed", None, False),
             "model.norm.weight": (params, "final_norm", None, False)}
    if not cfg.tie_embeddings:
        where["lm_head.weight"] = (params, "lm_head", None, True)
    for i, layer in enumerate(params["layers"]):
        for ours, theirs in _hf_layer_map(i, cfg).items():
            where[theirs] = (layer, ours, None, ours.startswith("w"))
        if cfg.n_experts is not None:
            p = f"model.layers.{i}.block_sparse_moe.experts."
            for ours, theirs in (("w_gate", "w1"), ("w_up", "w3"), ("w_down", "w2")):
                for e in range(cfg.n_experts):
                    where[f"{p}{e}.{theirs}.weight"] = (layer, ours, e, True)
    found = set()
    for shard in shards:
        for name, t in read_safetensors(shard, device):
            if name not in where:
                continue
            node, key, expert, transpose = where[name]
            t = (t.T.contiguous() if transpose else t).to(dtype)
            if expert is None:
                node[key] = t
            else:
                if key not in node:
                    node[key] = torch.empty((cfg.n_experts, *t.shape), dtype=dtype,
                                            device=t.device)
                node[key][expert] = t
            found.add(name)
    if "lm_head.weight" in where and "lm_head.weight" not in found:
        # a tied checkpoint under an untied config
        del where["lm_head.weight"]
        if "embed" in params:
            params["lm_head"] = params["embed"].T.contiguous()
    missing = sorted(set(where) - found)
    if missing:
        raise KeyError(f"{path}: {len(missing)} tensors missing, e.g. {missing[:3]}")
    return params


_HF_ARCH_DEFAULTS = {
    # per-family knobs not expressible in config.json fields alone
    "LlamaForCausalLM": {},
    "MistralForCausalLM": {},
    "MixtralForCausalLM": {},
    "Qwen2ForCausalLM": {"qkv_bias": True},
    "Gemma2ForCausalLM": {"rms_offset": 1.0, "act": "gelu",
                          "post_norms": True, "window_pattern": 2},
    "GemmaForCausalLM": {"rms_offset": 1.0, "act": "gelu"},
}


def config_from_hf(path: str, **overrides) -> LlamaConfig:
    """Build a LlamaConfig from a HF checkpoint directory's config.json.

    Covers the supported families (Llama/3.1, Mistral, Mixtral, Qwen2,
    Gemma/Gemma-2); anything else raises. `overrides` win over both the
    file and the family defaults (e.g. dtype=torch.float32)."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    arch = (hf.get("architectures") or ["LlamaForCausalLM"])[0]
    if arch not in _HF_ARCH_DEFAULTS:
        raise ValueError(f"unsupported architecture {arch!r}")

    dim = hf["hidden_size"]
    n_heads = hf["num_attention_heads"]
    kw = dict(
        vocab_size=hf["vocab_size"],
        dim=dim,
        n_layers=hf["num_hidden_layers"],
        n_heads=n_heads,
        n_kv_heads=hf.get("num_key_value_heads", n_heads),
        head_dim=hf.get("head_dim", dim // n_heads),
        hidden_dim=hf["intermediate_size"],
        rope_base=hf.get("rope_theta", 10000.0),
        rms_eps=hf.get("rms_norm_eps", 1e-5),
        max_seq_len=hf.get("max_position_embeddings", 8192),
    )
    if hf.get("sliding_window"):
        kw["sliding_window"] = hf["sliding_window"]
    if hf.get("tie_word_embeddings"):
        kw["tie_embeddings"] = True
    rs = hf.get("rope_scaling")
    if rs and rs.get("rope_type", rs.get("type")) == "llama3":
        kw["rope_scaling"] = (
            rs["factor"], rs["low_freq_factor"], rs["high_freq_factor"],
            rs["original_max_position_embeddings"],
        )
    if arch == "MixtralForCausalLM":
        kw["n_experts"] = hf["num_local_experts"]
        kw["n_experts_per_token"] = hf["num_experts_per_tok"]
        kw["router_aux_coef"] = hf.get("router_aux_loss_coef", 0.01)
    if arch == "Gemma2ForCausalLM":
        kw["attn_softcap"] = hf.get("attn_logit_softcapping", 50.0)
        kw["final_softcap"] = hf.get("final_logit_softcapping", 30.0)
        q = hf.get("query_pre_attn_scalar")
        if q:
            kw["attn_scale"] = q**-0.5
    if arch in ("GemmaForCausalLM", "Gemma2ForCausalLM"):
        kw["embed_scale"] = float(dim) ** 0.5
        kw["tie_embeddings"] = True
    kw.update(_HF_ARCH_DEFAULTS[arch])
    kw.update(overrides)
    return LlamaConfig(**kw)
