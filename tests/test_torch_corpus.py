"""The port's offline corpus pipeline (``realise_tpu_torch/data/corpus.py``,
``data/fixes.py``, ``cli/prepare_data.py``) against the JAX package's.

Every fabricated snippet and case of tests/test_corpus.py and
tests/test_prepare_data.py, plus the CLI's other three formats, runs through
both packages as one parametrised case each; the outputs must be equal: the
parsed records, the TSV and label files byte for byte, the pkl's examples
key for key, and the errors raised on bad input (type and message, the
message's package path aside). Cases that take a traditional→simplified
converter run twice: with the identity (as tests/test_corpus.py does) and
with each package's ``make_t2s()``, the built-in ``_S2T_BUILTIN`` fallback
(opencc is kept from both sides).
"""

import importlib.util
import pickle
import re
import sys
import warnings
from types import SimpleNamespace

import pytest

from realise_tpu.cli import prepare_data as jprepare
from realise_tpu.data import corpus as jcorpus
from realise_tpu.data import fixes as jfixes
from realise_tpu.data.dataset import load_pkl_dataset as jload
from realise_tpu.eval.metric_core import read_label_file as jread_label_file
from realise_tpu.text.tokenizer import WordPieceTokenizer as JTokenizer
from realise_tpu.text.vocab import build_synthetic_vocab as jvocab
from realise_tpu_torch.cli import prepare_data as tprepare
from realise_tpu_torch.cli.common import load_pkl_dataset as tload
from realise_tpu_torch.data import corpus as tcorpus
from realise_tpu_torch.data import fixes as tfixes
from realise_tpu_torch.eval.metric_core import read_label_file as tread_label_file
from realise_tpu_torch.text.tokenizer import WordPieceTokenizer as TTokenizer
from realise_tpu_torch.text.vocab import build_synthetic_vocab as tvocab
from test_corpus import BROKEN_SGML, FIXTURE_FIXES, SIGHAN13, SIGHAN15, WANG
from test_prepare_data import SGML as PREPARE_SGML


@pytest.fixture(scope="module")
def packages():
    """Each package's pipeline, its pkl and label readers and its tokenizer
    over its own synthetic vocab."""
    return {
        "jax": SimpleNamespace(
            corpus=jcorpus, fixes=jfixes, prepare=jprepare, load=jload,
            read_label_file=jread_label_file,
            tokenizer=JTokenizer({t: i for i, t in enumerate(jvocab())})),
        "port": SimpleNamespace(
            corpus=tcorpus, fixes=tfixes, prepare=tprepare, load=tload,
            read_label_file=tread_label_file,
            tokenizer=TTokenizer({t: i for i, t in enumerate(tvocab())})),
    }


@pytest.fixture(autouse=True)
def _builtin_t2s(monkeypatch):
    """Both packages' ``make_t2s`` take their built-in table: opencc, where
    it is installed, is hidden from the import."""
    if importlib.util.find_spec("opencc") is not None:
        warnings.warn("opencc is importable; both packages are compared with "
                      "the built-in t2s fallback forced")
    monkeypatch.setitem(sys.modules, "opencc", None)


def _t2s(pkg, mode):
    return (lambda s: s) if mode == "identity" else pkg.corpus.make_t2s()


# --------------------------------------------------------------- the cases
# Each takes (package, t2s mode, scratch dir) and returns what it produced;
# tests/test_corpus.py's checks of each case are kept as assertions on the
# JAX side's value in test_case_outputs_equal.
def case_full_to_half_width(p, mode, tmp):
    return [p.corpus.full_to_half_width(s)
            for s in ("ＡＢＣ１２３", "，。", "你　好", "ＡＢ１　。")]


def case_normalize_punct(p, mode, tmp):
    return [p.corpus.normalize_punct(s) for s in ("「你好」", "好?", "a,b")]


def case_collapse_english_words(p, mode, tmp):
    return p.corpus.collapse_english_words("我用app看app和web。",
                                           "我用app看app和web。")


def case_clean_pair_appends_terminator(p, mode, tmp):
    t2s = _t2s(p, mode)
    return [p.corpus.clean_pair(s, s, t2s=t2s) for s in ("你好吗", "你好！")]


def case_compute_errors_one_based(p, mode, tmp):
    return p.corpus.compute_errors("你号吗", "你好吗")


def case_make_record_multichar_mistake(p, mode, tmp):
    return p.corpus.make_record("x1", "我动遥了", [(1, "动遥", "动摇")],
                                t2s=_t2s(p, mode))


def case_parse_sighan13(p, mode, tmp):
    return p.corpus.parse_sighan13_sample(SIGHAN13, t2s=_t2s(p, mode))


def case_parse_sighan_training(p, mode, tmp):
    return p.corpus.parse_sighan_training(SIGHAN15, year=15, t2s=_t2s(p, mode))


def case_parse_wang271k(p, mode, tmp):
    return p.corpus.parse_wang271k(WANG, t2s=_t2s(p, mode))


def case_parse_sighan_test(p, mode, tmp):
    return p.corpus.parse_sighan_test("(pid=A2-1-1)\t我号。\n(pid=A2-1-2)\t天气好。",
                                      "A2-1-1, 2, 好\nA2-1-2, 0", year=15,
                                      t2s=_t2s(p, mode))


def case_tsv_roundtrip(p, mode, tmp):
    recs = p.corpus.parse_sighan_training(SIGHAN15, year=15, t2s=_t2s(p, mode))
    path = str(tmp / "data.tsv")
    p.corpus.write_tsv(recs, path)
    return _read_bytes(path), p.corpus.read_tsv(path), recs


def case_write_label_file(p, mode, tmp):
    recs = [{"id": "a", "src": "x", "tgt": "x", "errors": []},
            {"id": "b", "src": "x", "tgt": "y", "errors": [(1, "y")]}]
    path = str(tmp / "lbl.tsv")
    p.corpus.write_label_file(recs, path)
    return _read_bytes(path), p.read_label_file(path)


def case_records_to_examples(p, mode, tmp):
    recs = [{"id": "r1", "src": "你号吗", "tgt": "你好吗", "errors": [(2, "好")]},
            {"id": "r2", "src": "好" * 50, "tgt": "好" * 50, "errors": []}]
    examples = p.corpus.records_to_examples(recs, p.tokenizer, max_len=20)
    path = str(tmp / "run.pkl")
    with open(path, "wb") as f:
        pickle.dump(examples, f)
    return _examples(examples), _examples(p.load(path))


def case_train_fixes_dispatch(p, mode, tmp):
    files = (("SIGHAN2014/Training/B1_training.sgml", 14),
             ("C1_training.sgml", 14), ("SIGHAN15_CSC_A2_Training.sgml", 15),
             ("SIGHAN15_CSC_B2_Training.sgml", 15),
             ("Bakeoff2013_SampleSet_WithError_00001-00350.txt", 13),
             ("Bakeoff2013_SampleSet_WithoutError.txt", 13),
             ("train.sgml", 27))
    f = p.fixes
    return ([f.train_fixes_for(name, year) for name, year in files],
            f.TRAIN_FIXES, f.TEST_INPUT_FIXES, f.TEST_LABEL_OVERRIDES,
            f.TEST_GLOBAL_STRIP_13)


def case_fix_table_repairs_broken_sgml(p, mode, tmp):
    recs = p.corpus.parse_sighan_training(BROKEN_SGML, year=14,
                                          text_fixes=FIXTURE_FIXES,
                                          t2s=_t2s(p, mode))
    tsv, lbl = str(tmp / "out.tsv"), str(tmp / "out.lbl.tsv")
    p.corpus.write_tsv(recs, tsv)
    p.corpus.write_label_file(recs, lbl)
    return (_outcome(lambda: p.corpus.parse_sighan_training(
        BROKEN_SGML, year=14, t2s=_t2s(p, mode))),
            recs, _read_bytes(tsv), _read_bytes(lbl))


def case_unfixed_mismatch_is_actionable(p, mode, tmp):
    bad = BROKEN_SGML.replace("<WRONG>陪</WRONG>", "<WRONG>伴</WRONG>")
    return p.corpus.parse_sighan_training(bad, year=14, t2s=_t2s(p, mode))


def case_test_fixes_by_pid(p, mode, tmp):
    return [p.fixes.apply_test_fixes(*a) for a in (
        (13, "anything", "好(的)…啊"),
        (15, "A2-0506-1", "所以我在＂義大利麵方子＂已經定位了"),
        (15, "A2-9999-9", "好。"))]


def case_test_label_override(p, mode, tmp):
    return p.corpus.parse_sighan_test(
        "(pid=B1-1430-2)\t我好．．．\n(pid=B1-0001-1)\t我号。",
        "B1-1430-2, 8, 恤, 55, 恤\nB1-0001-1, 2, 好", year=14,
        t2s=_t2s(p, mode))


def case_mistake_offsets_survive_internal_spaces(p, mode, tmp):
    sgml = ('<ESSAY title="t"><TEXT><PASSAGE id="A1">我的 朋有来了。</PASSAGE>'
            "</TEXT>"
            '<MISTAKE id="A1" location="5"><WRONG>朋有</WRONG>'
            "<CORRECTION>朋友</CORRECTION></MISTAKE></ESSAY>")
    return p.corpus.parse_sighan_training(sgml, year=15, t2s=_t2s(p, mode))


def case_ideographic_space_converts_and_strips(p, mode, tmp):
    return (p.corpus.full_to_half_width("你　好"),
            p.corpus.clean_pair("你　好", "你　好", t2s=_t2s(p, mode)))


def case_forbidden_symbols_raise(p, mode, tmp):
    t2s = _t2s(p, mode)
    return [_outcome(lambda src=src: p.corpus.clean_pair(
        src, "你好好吗。", t2s=t2s, collapse_english=False))
        for src in ("你�好吗。", "你<好吗。")]


def case_compute_errors_rejects_misaligned(p, mode, tmp):
    return p.corpus.compute_errors("你好", "你好吗")


def case_t2s_alignment_fallback(p, mode, tmp):
    def bad_t2s(s):  # a phrase conversion that drops a char
        return s.replace("乾燥", "干") if len(s) > 1 else (
            "干" if s == "乾" else s)

    return p.corpus.clean_pair("乾燥的天。", "乾燥的天。", t2s=bad_t2s,
                               collapse_english=False)


def case_wrong_position_quoting_is_minimal(p, mode, tmp):
    layouts = [SIGHAN13,
               SIGHAN13.replace("wrong_position=3>", 'wrong_position="3">'),
               SIGHAN13.replace("wrong_position=3>\n<WRONG>",
                                "wrong_position=3><WRONG>")]
    return [p.corpus.parse_sighan13_sample(t, t2s=_t2s(p, mode))
            for t in layouts]


def _prepare(p, tmp, flags, files):
    """Write ``files`` ({name: text}) and the JAX tokenizer's vocab under
    ``tmp``, run the package's prepare_data on them, return its exit code
    and every file it wrote (bytes; the pkl as the package loads it)."""
    vocab = str(tmp / "vocab.txt")
    with open(vocab, "w", encoding="utf-8") as f:
        f.write("\n".join(jvocab()) + "\n")
    for name, text in files.items():
        (tmp / name).write_text(text, encoding="utf-8")
    outs = {"--output_tsv": "out.tsv", "--output_lbl": "out.lbl.tsv",
            "--output_pkl": "out.pkl"}
    argv = [a.format(tmp=tmp) for a in flags] + ["--vocab_path", vocab]
    for flag, name in outs.items():
        argv += [flag, str(tmp / name)]
    rc = p.prepare.main(argv)
    return (rc, _read_bytes(str(tmp / "out.tsv")),
            _read_bytes(str(tmp / "out.lbl.tsv")),
            _examples(p.load(str(tmp / "out.pkl"))))


def case_prepare_data_sighan_train(p, mode, tmp):
    return _prepare(p, tmp, ["--format", "sighan-train", "--year", "14",
                             "--input", "{tmp}/B1_training.sgml",
                             "--repeat", "2"],
                    {"B1_training.sgml": PREPARE_SGML})


def case_prepare_data_test_format(p, mode, tmp):
    return _prepare(p, tmp, ["--format", "sighan-test", "--year", "15",
                             "--input", "{tmp}/TestInput.txt",
                             "--truth", "{tmp}/TestTruth.txt"],
                    {"TestInput.txt": "(pid=A2-1-1)\t我号。\n(pid=A2-1-2)\t天气好。\n",
                     "TestTruth.txt": "A2-1-1, 2, 好\nA2-1-2, 0\n"})


def case_prepare_data_sighan13_sample(p, mode, tmp):
    return _prepare(p, tmp, ["--format", "sighan13-sample", "--input",
                             "{tmp}/Bakeoff2013_SampleSet_WithoutError.txt"],
                    {"Bakeoff2013_SampleSet_WithoutError.txt": SIGHAN13})


def case_prepare_data_wang271k(p, mode, tmp):
    return _prepare(p, tmp, ["--format", "wang271k", "--input",
                             "{tmp}/train.sgml", "--max_len", "8"],
                    {"train.sgml": WANG + WANG.replace("我爱北经。",
                                                       "我爱北经，天气很好。")})


def case_prepare_data_tsv_merge(p, mode, tmp):
    a = "sighan15-a\t他是我的好朋有。\t他是我的好朋友。\t[(8, '友')]\n"
    b = "sighan15-b\t天气很好。\t天气很好。\t[]\n"
    return _prepare(p, tmp, ["--format", "tsv", "--input",
                             "{tmp}/a.tsv,{tmp}/b.tsv", "--repeat", "3"],
                    {"a.tsv": a, "b.tsv": b})


def _read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _examples(examples):
    """Examples key for key, each value with its type."""
    return [{k: (type(v).__name__, v) for k, v in ex.items()} for ex in examples]


def _outcome(fn):
    """('ok', value) or ('raise', type, message); the port names its own
    copy of a module where the JAX package names its."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the error is the output compared
        return ("raise", type(e).__name__,
                re.sub(r"realise_tpu_torch\b", "realise_tpu", str(e)))


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}
# Cases whose output depends on the t2s converter: run with both.
WITH_T2S = {"clean_pair_appends_terminator", "make_record_multichar_mistake",
            "parse_sighan13", "parse_sighan_training", "parse_wang271k",
            "parse_sighan_test", "tsv_roundtrip",
            "fix_table_repairs_broken_sgml", "unfixed_mismatch_is_actionable",
            "test_label_override", "mistake_offsets_survive_internal_spaces",
            "ideographic_space_converts_and_strips", "forbidden_symbols_raise",
            "wrong_position_quoting_is_minimal"}
PARAMS = [(name, mode) for name in CASES
          for mode in (("identity", "builtin") if name in WITH_T2S
                       else ("builtin",))]

# tests/test_corpus.py's and tests/test_prepare_data.py's own expectations,
# held on the JAX side's outcome so a case that stopped exercising its path
# shows.
def _ok(pred):
    return lambda o: o[0] == "ok" and pred(o[1])


def _raises(text):
    return lambda o: o[0] == "raise" and text in o[2]


EXPECT = {
    "full_to_half_width": _ok(lambda v: v == ["ABC123", "，。", "你 好", "AB1 。"]),
    "collapse_english_words": _ok(lambda v: v == ("我用①看①和②。",) * 2),
    "compute_errors_one_based": _ok(lambda v: v == [(2, "好")]),
    "make_record_multichar_mistake": _ok(lambda v: v["errors"] == [(3, "摇")]),
    "parse_sighan13": _ok(lambda v: v[0]["errors"] == [(4, "各")]),
    "parse_wang271k": _ok(lambda v: v[0]["tgt"] == "我爱北京。"),
    "records_to_examples": _ok(lambda v: [e["id"][1] for e in v[1]] == ["r1"]),
    "fix_table_repairs_broken_sgml": _ok(lambda v: (
        _raises("fixes.py")(v[0]) and v[1][0]["errors"] == [(10, "赔")])),
    "unfixed_mismatch_is_actionable": _raises("fixes.py"),
    "forbidden_symbols_raise": _ok(lambda v: all(
        _raises("forbidden")(o) for o in v)),
    "compute_errors_rejects_misaligned": _raises("mismatch"),
    "t2s_alignment_fallback": _ok(lambda v: v == ("干燥的天。",) * 2),
    "wrong_position_quoting_is_minimal": _ok(lambda v: all(
        r[0]["errors"] == [(4, "各")] for r in v)),
    "prepare_data_sighan_train": _ok(lambda v: v[0] == 0 and len(v[3]) == 4),
    "prepare_data_test_format": _ok(lambda v: (
        v[0] == 0 and [e["id"][1] for e in v[3]] == ["A2-1-1", "A2-1-2"])),
    "prepare_data_wang271k": _ok(lambda v: v[0] == 0 and len(v[3]) == 1),
    "prepare_data_tsv_merge": _ok(lambda v: v[0] == 0 and len(v[3]) == 6),
}


@pytest.mark.parametrize("name,mode", PARAMS,
                         ids=[f"{n}-{m}" for n, m in PARAMS])
def test_case_outputs_equal(packages, tmp_path, name, mode):
    out = {}
    for pkg, p in packages.items():
        scratch = tmp_path / pkg
        scratch.mkdir()
        out[pkg] = _outcome(lambda: CASES[name](p, mode, scratch))
    assert out["port"] == out["jax"]
    if name in EXPECT:
        assert EXPECT[name](out["jax"]), out["jax"]


def test_builtin_t2s_converts_traditional(packages):
    """The fallback both sides compare with does convert: traditional in,
    simplified out, with the reference's 著→着 and 妳→你 exceptions."""
    got = {pkg: p.corpus.make_t2s()("傳說著妳們") for pkg, p in packages.items()}
    assert got["port"] == got["jax"] == "传说着你们"


def test_cli_takes_the_jax_flags():
    """Same option strings, choices and defaults as the JAX parser."""
    def spec(parser):
        return sorted((a.option_strings, a.default, a.choices, a.required)
                      for a in parser._actions if a.option_strings != ["-h", "--help"])

    assert spec(tprepare.build_parser()) == spec(jprepare.build_parser())
