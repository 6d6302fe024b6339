"""ctypes binding of the native C++ batch featurizer (the port's own copy of
``realise_tpu.data.native`` over its own ``csrc/featurizer.cpp``).

The library is built with the host's C++ compiler at first use into
``build/realise_tpu_torch/librealise_featurizer.so`` (``ops/kernels/_build``:
rebuilt when the source's hash changes). There is no quiet fallback: when the
build fails, :class:`NativeFeaturizer` raises with the compiler's output.
Callers that want the Python tokenizer pass no native featurizer
(``Corrector(native_featurizer=False)``, the default).

The native path covers tokenization and batch assembly (the reference's
per-step Python cost, src/run.py:68-101); the pinyin features stay a numpy
table gather (``data.features.Featurizer.featurize_raw``).
"""

from __future__ import annotations

import ctypes
import unicodedata
from typing import Dict, Sequence

import numpy as np

LIBRARY = "realise_featurizer"


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.rtf_create.restype = ctypes.c_void_p
    lib.rtf_create.argtypes = [ctypes.c_char_p]
    lib.rtf_create_ex.restype = ctypes.c_void_p
    lib.rtf_create_ex.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.rtf_destroy.restype = None
    lib.rtf_destroy.argtypes = [ctypes.c_void_p]
    lib.rtf_vocab_size.restype = ctypes.c_int
    lib.rtf_vocab_size.argtypes = [ctypes.c_void_p]
    i32 = ctypes.POINTER(ctypes.c_int32)
    lib.rtf_encode_batch.restype = ctypes.c_int
    lib.rtf_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.c_int, i32, i32, i32, i32, i32]
    return lib


def _normalize(s: str, lower: bool = True) -> bytes:
    """Pre-normalize for the C++ tokenizer so its ids match the Python path
    beyond ASCII/CJK: the Python BasicTokenizer lowercases and NFD-strips
    accents per word and drops every category-C char (bidi marks, ZWJ, soft
    hyphen, BOM, lone surrogates...); the C++ side only lowercases
    ASCII/Latin-1, has no Unicode tables and reads the bytes with strlen, so
    an embedded NUL (category Cc) would truncate the sentence. Lowercasing
    and accent-stripping commute with the (case- and accent-invariant)
    splitting, so applying them to the whole string first is equivalent.
    ``\\t\\n\\r`` stay: they are whitespace to both tokenizers."""
    if lower:
        # Accent-stripping is gated on do_lower_case in the Python
        # tokenizer too.
        s = unicodedata.normalize("NFD", s.lower())
        s = "".join(ch for ch in s if unicodedata.category(ch) != "Mn")
    s = "".join(ch for ch in s
                if ch in "\t\n\r"
                or not unicodedata.category(ch).startswith("C"))
    return s.encode("utf-8")


class NativeFeaturizer:
    """Batch-encode raw sentences with the C++ tokenizer into the Python
    featurizer's ``src_idx/masks/loss_masks/lengths/tokens_size`` contract
    (run.py:68-101 semantics)."""

    def __init__(self, vocab_path: str, do_lower_case: bool = True):
        from realise_tpu_torch.ops.kernels._build import load

        self._lib = _declare(load(LIBRARY))  # built first if stale
        self._lower = do_lower_case
        self._handle = self._lib.rtf_create_ex(vocab_path.encode("utf-8"),
                                               1 if do_lower_case else 0)
        if not self._handle:
            raise RuntimeError(
                f"failed to load vocab from {vocab_path} (missing file or "
                f"missing [UNK]/[CLS]/[SEP] specials)")

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.rtf_destroy(self._handle)
            self._handle = None

    @property
    def vocab_size(self) -> int:
        return self._lib.rtf_vocab_size(self._handle)

    def encode_batch(self, sentences: Sequence[str],
                     max_len: int) -> Dict[str, np.ndarray]:
        n = len(sentences)
        arr = (ctypes.c_char_p * n)(
            *[_normalize(s, lower=self._lower) for s in sentences])
        out = {"src_idx": np.zeros((n, max_len), np.int32),
               "masks": np.zeros((n, max_len), np.int32),
               "loss_masks": np.zeros((n, max_len), np.int32),
               "lengths": np.zeros((n,), np.int32),
               "tokens_size": np.zeros((n, max_len), np.int32)}

        def ptr(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

        rc = self._lib.rtf_encode_batch(
            self._handle, arr, n, max_len, ptr(out["src_idx"]),
            ptr(out["masks"]), ptr(out["loss_masks"]), ptr(out["lengths"]),
            ptr(out["tokens_size"]))
        if rc != 0:
            raise RuntimeError(f"rtf_encode_batch failed with {rc}")
        return out
