"""The port's local HF checkpoint loader against the JAX package's on the
CPU: synthetic safetensors directories written here (f32 through the
reference `safetensors` writer, bf16 through the port's own writer, one
or two shards), for the Llama, Qwen2 (q/k/v biases), Gemma-2 (post-norm
names, tied head) and Mixtral (stacked experts) name maps.
`load_hf_llama` must give the JAX tree bit for bit (after
params_from_numpy), `config_from_hf` the same config fields, and
`cli generate --hf-path` the JAX CLI's tokens."""

import argparse
import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from nnop_tpu import cli as j_cli
from nnop_tpu.models.llama import LlamaConfig as JLlamaConfig
from nnop_tpu.models.llama import init_params as j_init_params
from nnop_tpu.models.weights import config_from_hf as j_config_from_hf
from nnop_tpu.models.weights import load_hf_llama as j_load_hf_llama
from nnop_tpu_torch import cli
from nnop_tpu_torch.models.llama import LlamaConfig
from nnop_tpu_torch.models.weights import (
    config_from_hf,
    load_hf_llama,
    params_from_numpy,
    read_safetensors,
    save_safetensors,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel worker
    processes, and a default thread pool per worker oversubscribes the
    cores (tens of times slower on these tiny tensors under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf_tensors(params, cfg):
    """A JAX params tree as HF names -> f32 numpy arrays, projections
    stored (out, in) and Mixtral's experts one by one (the inverse of the
    loaders' maps; tests/test_weights.py:_dump_hf)."""
    t = {"model.embed_tokens.weight": np.asarray(params["embed"], np.float32),
         "model.norm.weight": np.asarray(params["final_norm"], np.float32)}
    if "lm_head" in params:
        t["lm_head.weight"] = np.ascontiguousarray(np.asarray(params["lm_head"], np.float32).T)
    names = {"attn_norm": "input_layernorm.weight", "wq": "self_attn.q_proj.weight",
             "wk": "self_attn.k_proj.weight", "wv": "self_attn.v_proj.weight",
             "wo": "self_attn.o_proj.weight", "w_gate": "mlp.gate_proj.weight",
             "w_up": "mlp.up_proj.weight", "w_down": "mlp.down_proj.weight",
             "bq": "self_attn.q_proj.bias", "bk": "self_attn.k_proj.bias",
             "bv": "self_attn.v_proj.bias", "w_router": "block_sparse_moe.gate.weight"}
    if cfg.post_norms:
        names.update(attn_post_norm="post_attention_layernorm.weight",
                     mlp_norm="pre_feedforward_layernorm.weight",
                     mlp_post_norm="post_feedforward_layernorm.weight")
    else:
        names["mlp_norm"] = "post_attention_layernorm.weight"
    for i, layer in enumerate(params["layers"]):
        for ours, arr in layer.items():
            a = np.asarray(arr, np.float32)
            if cfg.n_experts is not None and ours in ("w_gate", "w_up", "w_down"):
                hf = {"w_gate": "w1", "w_up": "w3", "w_down": "w2"}[ours]
                for e in range(cfg.n_experts):
                    t[f"model.layers.{i}.block_sparse_moe.experts.{e}.{hf}.weight"] = (
                        np.ascontiguousarray(a[e].T))
                continue
            t[f"model.layers.{i}.{names[ours]}"] = np.ascontiguousarray(
                a.T if ours.startswith("w") else a)
    return t


def _write_shards(path, tensors, n_shards, writer):
    """Split the names over n_shards files: the reference writer takes f32
    numpy; the port's writer takes bf16 tensors."""
    names = sorted(tensors)
    for s in range(n_shards):
        part = {n: tensors[n] for n in names[s::n_shards]}
        f = str(path / f"model-{s + 1:05d}-of-{n_shards:05d}.safetensors")
        if writer == "reference":
            save_file(part, f)
        else:
            save_safetensors(f, {n: torch.from_numpy(np.array(a)).to(torch.bfloat16)
                                 for n, a in part.items()})


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _flat(tree[key], f"{prefix}{key}/").items()}
    if isinstance(tree, list):
        return {k: v for i, x in enumerate(tree) for k, v in _flat(x, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


FAMILIES = {
    "llama": dict(),
    "qwen2_bias": dict(qkv_bias=True),
    "gemma2": dict(rms_offset=1.0, act="gelu", tie_embeddings=True, embed_scale=128.0**0.5,
                   post_norms=True, attn_softcap=20.0, final_softcap=15.0,
                   sliding_window=8, window_pattern=2),
    "mixtral": dict(n_experts=4, n_experts_per_token=2),
}


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("writer,n_shards", [("reference", 1), ("port", 2)],
                         ids=["f32_reference_1shard", "bf16_port_2shards"])
def test_load_hf_llama_matches_jax(tmp_path, family, writer, n_shards):
    jcfg = JLlamaConfig.tiny(dtype=jnp.float32, **FAMILIES[family])
    jp = j_init_params(jax.random.key(0), jcfg)
    if family == "qwen2_bias":  # nonzero biases, so the map is tested
        for i, layer in enumerate(jp["layers"]):
            for b in ("bq", "bk", "bv"):
                layer[b] = jax.random.normal(jax.random.key(10 + i), layer[b].shape) * 0.1
    tensors = _hf_tensors(jp, jcfg)
    _write_shards(tmp_path, tensors, n_shards, writer)
    want = params_from_numpy(jax.tree.map(np.asarray, j_load_hf_llama(str(tmp_path), jcfg)))
    cfg = LlamaConfig.tiny(dtype=torch.float32, **FAMILIES[family])
    got = load_hf_llama(str(tmp_path), cfg)
    gf, wf = _flat(got), _flat(want)
    assert sorted(gf) == sorted(wf)
    for k in wf:
        assert gf[k].dtype == torch.float32 and gf[k].shape == wf[k].shape, k
        assert torch.equal(gf[k], wf[k]), k
    if writer == "port":  # the bf16 files hold the f32 weights rounded to bf16
        emb = tensors["model.embed_tokens.weight"].astype(ml_dtypes.bfloat16).astype(np.float32)
        np.testing.assert_array_equal(got["embed"].numpy(), emb)


def test_load_hf_llama_untied_config_takes_the_embedding(tmp_path):
    """A tied checkpoint (no lm_head) under an untied config: the head is
    the embedding's transpose, as in JAX; a missing tensor raises."""
    jcfg = JLlamaConfig.tiny(dtype=jnp.float32)
    jp = j_init_params(jax.random.key(1), jcfg)
    tensors = _hf_tensors(jp, jcfg)
    del tensors["lm_head.weight"]
    save_file(tensors, str(tmp_path / "model.safetensors"))
    got = load_hf_llama(str(tmp_path), LlamaConfig.tiny(dtype=torch.bfloat16))
    want = np.asarray(j_load_hf_llama(str(tmp_path), jcfg, dtype=jnp.bfloat16)["lm_head"],
                      np.float32)
    assert got["lm_head"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["lm_head"].float().numpy(), want)
    del tensors["model.layers.1.mlp.up_proj.weight"]
    save_file(tensors, str(tmp_path / "model.safetensors"))
    with pytest.raises(KeyError, match="missing"):
        load_hf_llama(str(tmp_path), LlamaConfig.tiny(dtype=torch.float32))


def test_safetensors_reader_and_writer(tmp_path):
    """The port's reader against the reference writer (BF16, F16, F32, an
    empty tensor), the reference reader against the port's writer, and an
    unsupported dtype refused."""
    rng = np.random.default_rng(0)
    arrays = {"a": rng.standard_normal((3, 5)).astype(np.float32),
              "b": rng.standard_normal((4,)).astype(ml_dtypes.bfloat16),
              "c": rng.standard_normal((2, 2, 2)).astype(np.float16),
              "empty": np.zeros((0, 3), np.float32)}
    save_file(arrays, str(tmp_path / "ref.safetensors"))
    got = dict(read_safetensors(str(tmp_path / "ref.safetensors")))
    assert sorted(got) == sorted(arrays)
    for k, a in arrays.items():
        assert tuple(got[k].shape) == a.shape
        np.testing.assert_array_equal(got[k].float().numpy(), a.astype(np.float32))
    save_safetensors(str(tmp_path / "port.safetensors"), got)
    with open(tmp_path / "port.safetensors", "rb") as f:
        assert int.from_bytes(f.read(8), "little") % 8 == 0
    from safetensors.numpy import load_file

    back = load_file(str(tmp_path / "port.safetensors"))
    for k, a in arrays.items():
        assert back[k].dtype == a.dtype
        np.testing.assert_array_equal(back[k], a)
    save_file({"i": np.arange(4, dtype=np.int32)}, str(tmp_path / "int.safetensors"))
    with pytest.raises(ValueError, match="dtype I32"):
        list(read_safetensors(str(tmp_path / "int.safetensors")))


CONFIG_CASES = {
    "llama": ("LlamaForCausalLM", {}),
    "llama31_rope_scaling": ("LlamaForCausalLM", dict(rope_scaling=dict(
        rope_type="llama3", factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
        original_max_position_embeddings=8192))),
    "mistral": ("MistralForCausalLM", dict(sliding_window=4096)),
    "mixtral": ("MixtralForCausalLM", dict(num_local_experts=8, num_experts_per_tok=2)),
    "qwen2": ("Qwen2ForCausalLM", dict(tie_word_embeddings=True)),
    "gemma": ("GemmaForCausalLM", dict(head_dim=256, num_key_value_heads=1)),
    "gemma2": ("Gemma2ForCausalLM", dict(
        attn_logit_softcapping=50.0, final_logit_softcapping=30.0, query_pre_attn_scalar=256,
        sliding_window=4096, head_dim=256)),
}


@pytest.mark.parametrize("case", list(CONFIG_CASES))
def test_config_from_hf_matches_jax(tmp_path, case):
    arch, extra = CONFIG_CASES[case]
    hf = dict(architectures=[arch], vocab_size=1024, hidden_size=256, num_hidden_layers=3,
              num_attention_heads=8, num_key_value_heads=4, intermediate_size=512,
              rope_theta=500000.0, rms_norm_eps=1e-6, max_position_embeddings=4096)
    hf.update(extra)
    (tmp_path / "config.json").write_text(json.dumps(hf))
    got, want = config_from_hf(str(tmp_path)), j_config_from_hf(str(tmp_path))
    for f in dataclasses.fields(want):
        if f.name != "dtype":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.dtype == torch.bfloat16
    assert config_from_hf(str(tmp_path), dtype=torch.float32, n_layers=1).n_layers == 1
    (tmp_path / "config.json").write_text(json.dumps(dict(hf, architectures=["GPT2LMHeadModel"])))
    with pytest.raises(ValueError, match="unsupported architecture"):
        config_from_hf(str(tmp_path))


def test_cli_generate_hf_path_matches_jax(tmp_path):
    """`generate --model tiny --hf-path DIR`: the config from --model, the
    weights from the directory (over --checkpoint), the JAX CLI's tokens."""
    jcfg = JLlamaConfig.tiny(dtype=jnp.float32)
    _write_shards(tmp_path, _hf_tensors(j_init_params(jax.random.key(7), jcfg), jcfg), 2,
                  "port")
    prompts, max_new = ["hello world", "abcabcabc"], 6
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        j_cli.cmd_generate(argparse.Namespace(
            model="tiny", seed=0, hf_path=str(tmp_path), checkpoint=None, wbits=16, batch=4,
            int8_kv=False, prompt=prompts, max_new=max_new))
    want = [line for line in out.getvalue().splitlines() if line.startswith("[")]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["generate", "--model", "tiny", "--device", "cpu", "--hf-path", str(tmp_path),
                  "--checkpoint", str(tmp_path / "absent.npz"), "--max-new", str(max_new),
                  "--prompt", *prompts])
    got = [line for line in out.getvalue().splitlines() if line.startswith("[")]
    assert len(got) == 2 and got == want
