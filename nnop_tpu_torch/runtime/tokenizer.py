"""Byte-level BPE tokenizer: ctypes bindings over the native C++ core
(native/tokenizer.cpp, shared with the JAX package), with a pure-Python
fallback.

Counterpart of nnop_tpu/runtime/tokenizer.py, ported rather than imported:
importing anything from `nnop_tpu` imports JAX (nnop_tpu/__init__.py).
The native library is built on demand (`make -C native`) and loaded via
ctypes. Vocab format: a merges list of (left_id, right_id, new_id) ranked
by priority, plus optional byte-token remapping handled by the caller.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libnnop_tokenizer.so")


def _load_native():
    src = os.path.join(_NATIVE_DIR, "tokenizer.cpp")
    stale = (
        os.path.exists(_LIB_PATH)
        and os.path.exists(src)
        and os.path.getmtime(_LIB_PATH) < os.path.getmtime(src)
    )
    if not os.path.exists(_LIB_PATH) or stale:
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, "-B"] if stale
                else ["make", "-C", _NATIVE_DIR],
                check=True,
                capture_output=True,
            )
        except Exception:
            if not os.path.exists(_LIB_PATH):
                return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.tok_create.restype = ctypes.c_void_p
    lib.tok_create.argtypes = [
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_uint32,
    ]
    lib.tok_destroy.argtypes = [ctypes.c_void_p]
    lib.tok_encode.restype = ctypes.c_uint32
    lib.tok_encode.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint32),
    ]
    return lib


_LIB = None
_LIB_TRIED = False


def _lib():
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB = _load_native()
        _LIB_TRIED = True
    return _LIB


class BPETokenizer:
    """merges: ordered list of (left_id, right_id, new_id); ids 0..255 are
    raw bytes. decode() inverts via a recursive expansion table."""

    def __init__(self, merges: list[tuple[int, int, int]]):
        self.merges = list(merges)
        self._expand = {}
        for left, right, new in merges:
            self._expand[new] = (left, right)
        lib = _lib()
        self._handle = None
        if lib is not None:
            lefts = np.asarray([m[0] for m in merges], np.uint32)
            rights = np.asarray([m[1] for m in merges], np.uint32)
            ids = np.asarray([m[2] for m in merges], np.uint32)
            self._lefts, self._rights, self._ids = lefts, rights, ids  # keep alive
            self._handle = lib.tok_create(
                lefts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                rights.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                len(merges),
            )

    def __del__(self):
        lib = _lib()
        if lib is not None and getattr(self, "_handle", None):
            lib.tok_destroy(self._handle)
            self._handle = None

    @property
    def native(self) -> bool:
        return self._handle is not None

    def encode(self, text: str) -> list[int]:
        data = text.encode("utf-8")
        if self._handle is not None:
            lib = _lib()
            buf = np.frombuffer(data, np.uint8)
            out = np.empty(max(len(data), 1), np.uint32)
            n = lib.tok_encode(
                self._handle,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                len(data),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            )
            return out[:n].astype(int).tolist()
        return self._encode_py(data)

    def _encode_py(self, data: bytes) -> list[int]:
        ranks = {
            (left, right): (rank, new)
            for rank, (left, right, new) in enumerate(self.merges)
        }
        toks = list(data)
        while True:
            best = None
            for i in range(len(toks) - 1):
                r = ranks.get((toks[i], toks[i + 1]))
                if r is not None and (best is None or r[0] < best[0]):
                    best = (r[0], i, r[1])
            if best is None:
                return toks
            _, i, new = best
            toks[i : i + 2] = [new]

    def decode_bytes(self, ids: list[int]) -> bytes:
        """Raw decoded bytes. Decoding is a pure per-token byte
        concatenation, so decode_bytes(a + b) == decode_bytes(a) +
        decode_bytes(b) — the property the engine's incremental
        stop-string matcher relies on."""
        out = bytearray()

        def expand(t):
            if t < 256:
                out.append(t)
            else:
                left, right = self._expand[t]
                expand(left)
                expand(right)

        for t in ids:
            expand(t)
        return bytes(out)

    def decode(self, ids: list[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")


# ---------------------------------------------------------------------------
# Real-vocabulary loading: HF tokenizer.json (Llama-3 / GPT-2 byte-level
# BPE format). Token strings live in the GPT-2 byte<->unicode space; ids
# are arbitrary. The native core merges over arbitrary id sequences
# (tok_encode_ids); Python maps raw bytes -> byte-token ids first and
# inverts id -> bytes for decoding.
# ---------------------------------------------------------------------------


def _bytes_to_unicode():
    """GPT-2's printable-unicode byte mapping (public algorithm)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAD))
        + list(range(0xAE, 0x100))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


# Approximation of the GPT-2/Llama pretokenizer regex using stdlib `re`
# (\w for \p{L}\p{N}): contractions | space-word | space-symbols |
# trailing/other whitespace. Merges never cross these boundaries.
_PRETOKEN_RE = None


def _pretokenize(text: str):
    global _PRETOKEN_RE
    if _PRETOKEN_RE is None:
        import re

        _PRETOKEN_RE = re.compile(
            r"'s|'t|'re|'ve|'m|'ll|'d| ?\w+| ?[^\s\w]+|\s+(?!\S)|\s+",
            re.UNICODE,
        )
    return _PRETOKEN_RE.findall(text)


class VocabBPETokenizer:
    """Byte-level BPE over a real vocabulary (HF tokenizer.json format).

    Supports the Llama-3 / GPT-2 family layout: model.vocab maps
    byte-unicode token strings to ids, model.merges ranks "left right"
    pairs, added_tokens carry specials (BOS/EOS etc.). Encoding runs the
    native C++ merge core when available.
    """

    def __init__(self, vocab: dict, merges: list, added_tokens=()):
        b2u = _bytes_to_unicode()
        self._u2b = {u: b for b, u in b2u.items()}
        self.vocab = vocab
        self.id_to_token = {i: t for t, i in vocab.items()}
        self.special = {}
        for tok in added_tokens:
            self.special[tok["content"]] = tok["id"]
            self.id_to_token[tok["id"]] = tok["content"]

        # raw byte -> byte-token id
        self.byte_id = np.zeros(256, np.uint32)
        for b in range(256):
            u = b2u[b]
            if u not in vocab:
                raise ValueError(f"vocab missing byte token {u!r} ({b})")
            self.byte_id[b] = vocab[u]

        # id -> raw bytes (specials decode to their literal content)
        self._id_bytes = {}
        for tok, i in vocab.items():
            try:
                self._id_bytes[i] = bytes(self._u2b[c] for c in tok)
            except KeyError:
                self._id_bytes[i] = tok.encode("utf-8")
        for tok in added_tokens:
            self._id_bytes[tok["id"]] = tok["content"].encode("utf-8")

        # merge triples in id space
        triples = []
        for m in merges:
            if isinstance(m, str):
                left, right = m.split(" ")
            else:
                left, right = m
            li, ri = vocab[left], vocab[right]
            ni = vocab[left + right]
            triples.append((li, ri, ni))
        self.merges = triples
        self._ranks = {
            (l, r): (rank, n) for rank, (l, r, n) in enumerate(triples)
        }

        lib = _lib()
        self._handle = None
        if lib is not None and hasattr(lib, "tok_encode_ids"):
            lib.tok_encode_ids.restype = ctypes.c_uint32
            lib.tok_encode_ids.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_uint32,
                ctypes.POINTER(ctypes.c_uint32),
            ]
            lefts = np.asarray([m[0] for m in triples], np.uint32)
            rights = np.asarray([m[1] for m in triples], np.uint32)
            ids = np.asarray([m[2] for m in triples], np.uint32)
            self._tables = (lefts, rights, ids)  # keep alive
            self._handle = lib.tok_create(
                lefts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                rights.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                len(triples),
            )

    @classmethod
    def from_file(cls, path: str) -> "VocabBPETokenizer":
        """Load an HF tokenizer.json (Llama-3/GPT-2 byte-level BPE)."""
        import json

        with open(path) as f:
            spec = json.load(f)
        model = spec["model"]
        if model.get("type") not in (None, "BPE"):
            raise ValueError(f"unsupported model type {model.get('type')}")
        return cls(
            model["vocab"], model["merges"], spec.get("added_tokens", ())
        )

    def __del__(self):
        lib = _lib()
        if lib is not None and getattr(self, "_handle", None):
            lib.tok_destroy(self._handle)
            self._handle = None

    @property
    def native(self) -> bool:
        return self._handle is not None

    def _bpe_ids(self, ids: np.ndarray) -> list:
        if self._handle is not None:
            lib = _lib()
            out = np.empty(max(len(ids), 1), np.uint32)
            n = lib.tok_encode_ids(
                self._handle,
                np.ascontiguousarray(ids).ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint32)
                ),
                len(ids),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            )
            return out[:n].astype(int).tolist()
        toks = ids.astype(int).tolist()
        while True:
            best = None
            for i in range(len(toks) - 1):
                r = self._ranks.get((toks[i], toks[i + 1]))
                if r is not None and (best is None or r[0] < best[0]):
                    best = (r[0], i, r[1])
            if best is None:
                return toks
            _, i, new = best
            toks[i : i + 2] = [new]

    def encode(self, text: str, add_special=()) -> list:
        out = [self.special[t] for t in add_special]
        for chunk in _pretokenize(text):
            data = chunk.encode("utf-8")
            out.extend(self._bpe_ids(self.byte_id[list(data)]))
        return out

    def decode_bytes(self, ids, skip_special: bool = True) -> bytes:
        """Raw decoded bytes (per-token concatenative — see the note on
        the BPE tokenizer's decode_bytes)."""
        buf = bytearray()
        special_ids = set(self.special.values())
        for i in ids:
            if skip_special and i in special_ids:
                continue
            buf.extend(self._id_bytes[int(i)])
        return bytes(buf)

    def decode(self, ids, skip_special: bool = True) -> str:
        return self.decode_bytes(ids, skip_special).decode(
            "utf-8", errors="replace")
