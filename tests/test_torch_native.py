"""The port's native C++ featurizer (realise_tpu_torch/data/native.py over
realise_tpu_torch/csrc/featurizer.cpp) against the JAX package's native
featurizer and against the port's Python tokenizer path: the cases of
tests/test_native.py, array for array. The library is built with the host's
C++ compiler at first use; without one these tests skip."""

import numpy as np
import pytest

from realise_tpu.config import config_for
from realise_tpu.data.native import NativeFeaturizer as JaxNative
from realise_tpu.data.native import native_available as jax_native_available
from realise_tpu_torch.config import RealiseConfig
from realise_tpu_torch.data import native as tnative
from realise_tpu_torch.data.features import Featurizer, make_example
from realise_tpu_torch.ops.kernels import _build
from realise_tpu_torch.text.tokenizer import WordPieceTokenizer

KEYS = ("src_idx", "masks", "loss_masks", "lengths", "tokens_size")


@pytest.fixture(scope="module")
def port_tokenizer(vocab_list):
    from realise_tpu_torch.text.vocab import vocab_to_dict

    return WordPieceTokenizer(vocab_to_dict(vocab_list))


@pytest.fixture(scope="module")
def vocab_path(port_tokenizer, tmp_path_factory):
    return port_tokenizer.save_pretrained(str(tmp_path_factory.mktemp("vocab")))


@pytest.fixture(scope="module")
def ours(vocab_path):
    try:
        _build.find_cxx()
    except RuntimeError as e:
        pytest.skip(str(e))
    return tnative.NativeFeaturizer(vocab_path)


@pytest.fixture(scope="module")
def theirs(vocab_path):
    if not jax_native_available():
        pytest.skip("the JAX package's native featurizer did not build")
    return JaxNative(vocab_path)


def _python_row(text, tokenizer, max_len):
    ex = make_example("x", text, text, tokenizer)
    want = np.zeros(max_len, np.int32)
    want[: len(ex["src_idx"])] = ex["src_idx"]
    return ex, want


def _assert_encodings_equal(a, b, msg=""):
    for k in KEYS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{k} {msg!r}")


def test_vocab_size(ours, theirs, port_tokenizer):
    assert ours.vocab_size == theirs.vocab_size == len(port_tokenizer)


TEXTS = ["你好吗", "天气很好。", "hello你好world", "worlding好", "a,b你",
         "你Ω好"]
EDGE = ["你\x00好吗",        # embedded NUL (Cc): strlen must not truncate
        "你‪好",        # bidi embedding (Cf)
        "你‍好",        # zero-width joiner (Cf)
        "a­ b你",       # soft hyphen (Cf) inside a word
        "a〇b你",            # U+3007 Nl: not punctuation
        "a·b你",             # U+00B7 Po: punctuation (Latin-1)
        "你«好»吗",          # U+00AB/BB Pi/Pf
        "二〇二一年好",       # ideographic zero between CJK
        "你\ud800好",        # a lone surrogate (hostile JSON)
        "你\r\n好\r吗"]       # CRLF and a bare CR


@pytest.mark.parametrize("text", TEXTS + EDGE)
def test_parity(ours, theirs, port_tokenizer, text):
    """The same arrays as the JAX native featurizer, and the Python
    tokenizer's ids, lengths, widths and masks."""
    got = ours.encode_batch([text], max_len=16)
    _assert_encodings_equal(got, theirs.encode_batch([text], max_len=16), text)
    ex, want = _python_row(text, port_tokenizer, 16)
    np.testing.assert_array_equal(got["src_idx"][0], want, err_msg=text)
    assert int(got["lengths"][0]) == ex["lengths"]
    np.testing.assert_array_equal(got["tokens_size"][0][: ex["lengths"]],
                                  ex["tokens_size"])
    assert got["masks"][0].sum() == ex["lengths"] + 2
    assert got["loss_masks"][0].sum() == ex["lengths"]
    assert got["loss_masks"][0][0] == 0


def test_truncation(ours, theirs, port_tokenizer):
    text = "好" * 30
    got = ours.encode_batch([text], max_len=8)
    _assert_encodings_equal(got, theirs.encode_batch([text], max_len=8))
    assert got["lengths"][0] == 30  # the true length; the ids truncated
    assert got["src_idx"][0][-1] == port_tokenizer.sep_token_id
    assert got["loss_masks"][0].tolist() == [0, 1, 1, 1, 1, 1, 1, 0]
    cfg = RealiseConfig.from_dict(config_for(
        "bert", vocab_size=len(port_tokenizer), max_seq_length=8).to_dict())
    py = Featurizer(port_tokenizer, cfg).featurize(
        [make_example("0", text, text, port_tokenizer)], seq_len=8)
    for k in ("src_idx", "loss_masks", "masks"):
        np.testing.assert_array_equal(got[k][0], py[k][0], err_msg=k)


def test_batch_shapes(ours):
    out = ours.encode_batch(["你好吗今天天气很好" * 3] * 512, max_len=64)
    assert out["src_idx"].shape == (512, 64)


@pytest.mark.parametrize("seq_len", [None, 8])
def test_featurize_raw_native_equals_python(ours, port_tokenizer, seq_len):
    """featurize_raw with the C++ encoder gives the Python path's host
    batch: ids, masks, pinyin gathers and the passthrough fields, truncated
    sentences (lengths == len(tokens_size)) too."""
    cfg = RealiseConfig.from_dict(config_for(
        "bert-pho2-res-arch3", vocab_size=len(port_tokenizer),
        max_seq_length=16).to_dict())
    feat = Featurizer(port_tokenizer, cfg)
    sentences = TEXTS + EDGE + ["你好吗天气很好今天"]
    a = feat.featurize_raw(sentences, native=ours, seq_len=seq_len)
    b = feat.featurize_raw(sentences, seq_len=seq_len)
    assert set(a) == set(b)
    for key in ("src_idx", "masks", "loss_masks", "pho_idx", "pho_lens",
                "lengths"):
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]),
                                      err_msg=key)
    for key in ("tokens_size", "src", "tgt", "id"):
        assert a[key] == b[key], key
    assert all(len(t) == n for t, n in zip(a["tokens_size"], a["lengths"]))


def test_crlf_vocab_loads(ours, port_tokenizer, tmp_path):
    tokens = port_tokenizer.convert_ids_to_tokens(range(len(port_tokenizer)))
    p = tmp_path / "vocab_crlf.txt"
    p.write_bytes("\r\n".join(tokens).encode("utf-8") + b"\r\n")
    assert tnative.NativeFeaturizer(str(p)).vocab_size == len(port_tokenizer)
    assert WordPieceTokenizer.from_pretrained(str(p)).tokenize("你好") == \
        port_tokenizer.tokenize("你好")


def test_missing_specials_vocab_rejected(ours, tmp_path):
    p = tmp_path / "bad_vocab.txt"
    p.write_text("foo\nbar\n", encoding="utf-8")
    with pytest.raises(RuntimeError, match="vocab"):
        tnative.NativeFeaturizer(str(p))


@pytest.mark.parametrize("text", ["Hello你好", "ABC你", "École好"])
def test_cased_mode_parity(ours, vocab_path, port_tokenizer, text):
    """do_lower_case=False flows through: cased input stays cased, as on
    the Python path and the JAX native path."""
    cased = tnative.NativeFeaturizer(vocab_path, do_lower_case=False)
    got = cased.encode_batch([text], max_len=16)
    if jax_native_available():
        _assert_encodings_equal(
            got, JaxNative(vocab_path, do_lower_case=False).encode_batch(
                [text], max_len=16), text)
    cased_tok = WordPieceTokenizer(port_tokenizer.vocab, do_lower_case=False)
    ex, want = _python_row(text, cased_tok, 16)
    assert int(got["lengths"][0]) == ex["lengths"]
    np.testing.assert_array_equal(got["src_idx"][0], want, err_msg=text)


def test_a_failed_build_raises_with_the_compiler_output(ours, vocab_path,
                                                        tmp_path, monkeypatch):
    """No quiet fallback: a featurizer source that does not compile makes
    NativeFeaturizer raise with the compiler's message."""
    (tmp_path / "featurizer.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="featurizer.cpp failed:(.|\n)*error"):
        tnative.NativeFeaturizer(vocab_path)
