"""The port's tokenizers (nnop_tpu_torch.runtime.tokenizer) against the JAX
package's: the same merges and the same HF-format vocabulary give the
same ids and the same text, through the shared native library and
through the pure-Python merge loop."""

import json

import pytest

from nnop_tpu.runtime import tokenizer as jtok
from nnop_tpu_torch.runtime import tokenizer as ttok

TEXTS = ["the theme", "café résumé", "日本語 🚀 étude", " leading and trailing  ", ""]


def _vocab_json(tmp_path):
    """A tokenizer.json with the 256 byte tokens, merges over ASCII and
    multi-byte UTF-8, and two special tokens."""
    b2u = ttok._bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    merges = []

    def u(text):
        return "".join(b2u[x] for x in text.encode("utf-8"))

    ri = u("日")  # three bytes, merged in two steps
    for left, right in ((u("t"), u("h")), (u("th"), u("e")), (u(" "), u("the")),
                        (u("é")[:1], u("é")[1:]), (ri[:1], ri[1:2]), (ri[:2], ri[2:])):
        vocab.setdefault(left + right, len(vocab))
        merges.append(f"{left} {right}")
    added = [{"id": len(vocab), "content": "<|begin_of_text|>"},
             {"id": len(vocab) + 1, "content": "<|end_of_text|>"}]
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps({"model": {"type": "BPE", "vocab": vocab, "merges": merges},
                                "added_tokens": added}))
    return str(path)


def test_bpe_tokenizer_matches_jax():
    merges = [(ord("a"), ord("b"), 256), (256, ord("c"), 257), (ord("c"), ord("d"), 258)]
    jt, tt = jtok.BPETokenizer(merges), ttok.BPETokenizer(merges)
    assert tt.native == jt.native
    for text in ["abcd", "aabbccdd", "hello abc world cd", "日本語 abc", ""]:
        ids = tt.encode(text)
        assert ids == jt.encode(text) == tt._encode_py(text.encode("utf-8"))
        assert tt.decode(ids) == jt.decode(ids) == text


@pytest.mark.parametrize("text", TEXTS)
def test_vocab_tokenizer_matches_jax(tmp_path, text):
    path = _vocab_json(tmp_path)
    jt, tt = jtok.VocabBPETokenizer.from_file(path), ttok.VocabBPETokenizer.from_file(path)
    ids = tt.encode(text, add_special=("<|begin_of_text|>",))
    assert ids == jt.encode(text, add_special=("<|begin_of_text|>",))
    if any(s in text for s in ("th", "é", "日")):  # the merges applied
        assert len(ids) - 1 < len(text.encode("utf-8"))
    assert tt.decode(ids) == jt.decode(ids) == text
    assert tt.decode_bytes(ids, skip_special=False) == jt.decode_bytes(ids, skip_special=False)
    handle, tt._handle = tt._handle, None  # the pure-Python merge loop
    try:
        assert tt.encode(text, add_special=("<|begin_of_text|>",)) == ids
    finally:
        tt._handle = handle
