"""Offline corpus pipeline: raw SIGHAN/Wang271K → cleaned TSV → runtime pkl
(the port's own copy of ``realise_tpu.data.corpus``).

Re-implements the reference's offline data layer (reference:
data_process/{trainset,testset,dataset,build_lbl}.py + process_data.py) as
one composable module:

* **Cleaning** (trainset.py:26-74): full→half width for alphanumerics,
  「」→“”, English ?/, → Chinese ？／，, traditional→simplified with the
  著→着 / 妳→你 exceptions, whitespace removal, a Chinese-punctuation
  sentence terminator, and collapsing each distinct embedded English word to
  a single circled-number placeholder ①②… (find_words, trainset.py:61-74 +
  span collapsing :539-556) so alignment stays 1 char = 1 token.
* **Parsers** for the three raw formats:
  - SIGHAN13 sample SGML: ``<DOC Nid=…><P>…</P><TEXT><MISTAKE
    wrong_position=…><WRONG/><CORRECT/>`` (trainset.py:109-225),
  - SIGHAN14/15 training SGML: ``<ESSAY><TEXT><PASSAGE id=…>`` +
    ``<MISTAKE id=… location=…><WRONG/><CORRECTION/>`` (trainset.py:487-610),
  - Wang271K XML: ``<SENTENCE><TEXT/><MISTAKE><WRONG/><CORRECTION/>
    <LOCATION/>`` (trainset.py:645-727),
  - SIGHAN test input+truth pairs: ``(pid=…)\ttext`` + ``id, pos, char``
    truth lines (testset.py:125-254).
* **TSV IO**: rows ``id\tsrc\ttgt\t[(pos, char), …]`` (trainset.py:730-735).
* **Label files** for the scorer (build_lbl.py).
* **Runtime pkl**: TSV rows → the flat per-example dict list the runners
  consume (process_data.py:38-45) via realise_tpu_torch.data.features.make_example.

The reference also carries ~60 hand-written textual patches for corrupt
bytes in specific corpus files (e.g. trainset.py:77-106); pass such patches
via ``text_fixes`` — they are data repairs, not logic.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from typing import Callable, Dict, List, Optional, Sequence, Tuple

CIRCLED_ONE = 0x2460  # ①
_CN_TERMINATORS = "。？！：”"
_FORBIDDEN = set("�．!@#$%^&*()_+=`~\\|<>,/?:;'\"")


# --------------------------------------------------------------------------
# Cleaning primitives
# --------------------------------------------------------------------------
def full_to_half_width(text: str) -> str:
    """Normalize full-width alphanumerics (and －．) to ASCII
    (trainset.py:26-42)."""
    out = []
    for ch in text:
        # Ideographic space first: U+3000 is NOT isalnum(), so checking it
        # inside the alnum branch would never fire and truth positions
        # indexed after ASCII-space stripping would shift.
        if ch == "　":
            out.append(" ")
            continue
        if ch.isalnum() or ch in ("－", "．"):
            code = ord(ch)
            if 0xFF01 <= code <= 0xFF5E:
                code -= 0xFEE0
            ch = chr(code)
        out.append(ch)
    return "".join(out)


_T2S_EXCEPTIONS = {"著": "着", "妳": "你"}


def make_t2s() -> Callable[[str], str]:
    """Traditional→simplified converter with the reference's exceptions
    (trainset.py:45-51). OpenCC when available, built-in map otherwise."""
    try:
        import opencc  # type: ignore

        conv = opencc.OpenCC("t2s.json")
        base = conv.convert
    except Exception:
        from realise_tpu_torch.text.glyphs import _S2T_BUILTIN

        t2s_map = {t: s for s, t in _S2T_BUILTIN.items()}
        base = lambda text: "".join(t2s_map.get(c, c) for c in text)

    def convert(text: str) -> str:
        text = base(text)
        for t, s in _T2S_EXCEPTIONS.items():
            text = text.replace(t, s)
        return text

    return convert


def normalize_punct(text: str) -> str:
    """「」→ curly quotes, English ?/, → Chinese (trainset.py:54-58)."""
    text = text.replace("「", "“").replace("」", "”")
    text = text.replace("?", "？").replace(",", "，")
    return full_to_half_width(text)


def find_english_words(s: str) -> List[Tuple[int, int]]:
    """[l, r) spans of ASCII-letter runs (trainset.py:61-74)."""
    spans = []
    l = 0
    n = len(s)
    while l < n:
        if s[l].isascii() and s[l].isalpha():
            r = l + 1
            while r < n and s[r].isascii() and s[r].isalpha():
                r += 1
            spans.append((l, r))
            l = r
        else:
            l += 1
    return spans


def collapse_english_words(src: str, tgt: str) -> Tuple[str, str]:
    """Replace each English word with one circled-number char per distinct
    word (①②…), identically in src and tgt, preserving 1-char alignment
    (trainset.py:539-556)."""
    spans = find_english_words(src)
    words: List[str] = []
    src_l, tgt_l = list(src), list(tgt)
    for l, r in spans:
        word = src[l:r]
        if src[l:r] != tgt[l:r]:
            raise ValueError(f"English span differs between src/tgt: {word}")
        if word not in words:
            words.append(word)
        marker = chr(CIRCLED_ONE + words.index(word))
        src_l[l] = marker
        tgt_l[l] = marker
        for i in range(l + 1, r):
            src_l[i] = ""
            tgt_l[i] = ""
    return "".join(src_l), "".join(tgt_l)


def strip_whitespace_aligned(src: str, tgt: str) -> Tuple[str, str]:
    src_l, tgt_l = [], []
    for a, b in zip(src, tgt):
        if a.isspace():
            if not b.isspace():
                raise ValueError("whitespace misalignment between src/tgt")
            continue
        src_l.append(a)
        tgt_l.append(b)
    return "".join(src_l), "".join(tgt_l)


def ensure_terminator(src: str, tgt: str) -> Tuple[str, str]:
    """Append 。 when the sentence lacks a Chinese terminator
    (trainset.py:629-632)."""
    if src and src[-1] not in _CN_TERMINATORS:
        src += "。"
        tgt += "。"
    return src, tgt


def compute_errors(src: str, tgt: str) -> List[Tuple[int, str]]:
    """1-based (pos, correct-char) diffs (trainset.py:578-583)."""
    if len(src) != len(tgt):
        # zip would silently truncate the tail, recording edits against
        # shifted positions — misalignment is a data bug, not a diff.
        raise ValueError(
            f"src/tgt length mismatch ({len(src)} vs {len(tgt)})")
    return [(i, b) for i, (a, b) in enumerate(zip(src, tgt), start=1)
            if a != b]


def _convert_aligned(t2s: Callable[[str], str], text: str) -> str:
    """t2s that PRESERVES LENGTH: OpenCC's phrase-based conversion can
    change length (multi-char phrase mappings); fall back to per-char
    conversion — alignment with the paired sentence matters more than
    phrase-context accuracy for the handful of affected chars."""
    out = t2s(text)
    if len(out) == len(text):
        return out
    out = "".join(t2s(ch) if len(t2s(ch)) == 1 else ch for ch in text)
    if len(out) != len(text):  # pragma: no cover - 1->N single-char maps
        raise ValueError("t2s conversion changed sentence length")
    return out


def clean_pair(src: str, tgt: str, t2s: Optional[Callable[[str], str]] = None,
               collapse_english: bool = True) -> Tuple[str, str]:
    """Full cleaning pass over an aligned (src, tgt) pair.

    Ends with the reference's forbidden-symbol invariant
    (trainset.py:204-207): a surviving ``�``/ASCII-junk char means a
    per-corpus fix (data/fixes.py) is missing — raise so the gap is
    visible instead of training on mojibake.
    """
    if len(src) != len(tgt):
        raise ValueError("src/tgt length mismatch before cleaning")
    src, tgt = normalize_punct(src), normalize_punct(tgt)
    if collapse_english:
        src, tgt = collapse_english_words(src, tgt)
    src, tgt = strip_whitespace_aligned(src, tgt)
    src, tgt = ensure_terminator(src, tgt)
    if t2s is None:
        t2s = make_t2s()
    src, tgt = _convert_aligned(t2s, src), _convert_aligned(t2s, tgt)
    for s in (src, tgt):
        bad = _FORBIDDEN.intersection(s)
        if bad:
            raise ValueError(
                f"forbidden symbol(s) {sorted(bad)} survived cleaning in "
                f"{s!r} — add a repair to data/fixes.py "
                f"(reference invariant: trainset.py:204-207)")
    return src, tgt


# --------------------------------------------------------------------------
# Record assembly
# --------------------------------------------------------------------------
def _apply_mistakes(src: str, mistakes: Sequence[Tuple[int, str, str]]) -> str:
    """mistakes: (0-based pos, wrong, correct) single- or multi-char."""
    tgt = list(src)
    for pos, wrong, correct in mistakes:
        if len(wrong) != len(correct):
            raise ValueError(
                f"wrong/correct length mismatch at {pos}: {wrong!r} vs "
                f"{correct!r} — the raw corpus needs a repair entry in "
                f"realise_tpu_torch/data/fixes.py (a length-equalizing "
                f"<CORRECTION> patch, cf. trainset.py:292-299)")
        for i, (w, c) in enumerate(zip(wrong, correct)):
            idx = pos + i
            if idx >= len(tgt) or (tgt[idx] != w and tgt[idx] != c):
                raise ValueError(
                    f"mistake {wrong!r}→{correct!r} does not match source "
                    f"at {idx} (saw {tgt[idx] if idx < len(tgt) else '<oob>'!r} "
                    f"in {src!r}) — likely an off-by-one location in the raw "
                    f"corpus; add a location repair to "
                    f"realise_tpu_torch/data/fixes.py")
            tgt[idx] = c
    return "".join(tgt)


def _locate(src: str, wrong: str, pos: int) -> int:
    """Find the occurrence of ``wrong`` whose span covers ``pos``
    (trainset.py:527-538)."""
    start = 0
    while True:
        left = src.find(wrong, start)
        if left < 0:
            raise ValueError(
                f"{wrong!r} not found covering position {pos} in {src!r} — "
                f"likely a corrupt location/WRONG in the raw corpus; add a "
                f"repair to realise_tpu_torch/data/fixes.py")
        if left <= pos <= left + len(wrong) - 1:
            return left
        start = left + 1


def make_record(sid: str, src: str,
                mistakes: Sequence[Tuple[int, str, str]],
                t2s: Optional[Callable[[str], str]] = None,
                collapse_english: bool = True) -> Dict:
    # NO space stripping here: ``mistakes`` offsets were located on exactly
    # this string, and removing spaces first would shift every offset past
    # an internal space (silent corruption or a spurious mismatch error).
    # Whitespace is removed ALIGNED, after the mistakes are applied, inside
    # clean_pair; only the SIGHAN13 parser pre-strips spaces before
    # locating, matching the reference (trainset.py:132-133 vs :515,:663).
    src = normalize_punct(src.strip())
    tgt = _apply_mistakes(src, mistakes)
    src, tgt = clean_pair(src, tgt, t2s=t2s,
                          collapse_english=collapse_english)
    return {"id": sid, "src": src, "tgt": tgt,
            "errors": compute_errors(src, tgt)}


# --------------------------------------------------------------------------
# Raw-format parsers
# --------------------------------------------------------------------------
def _wrap_xml(text: str) -> ET.Element:
    return ET.fromstring("<xml>" + text + "</xml>")


def _iter_fixes(text_fixes) -> Sequence[Tuple[str, str]]:
    """Accept fix tables as dicts or (old, new) pair sequences
    (realise_tpu_torch.data.fixes ships the per-corpus tables as tuples)."""
    if not text_fixes:
        return ()
    if hasattr(text_fixes, "items"):
        return tuple(text_fixes.items())
    return tuple(text_fixes)


def parse_sighan13_sample(text: str,
                          text_fixes=None,
                          t2s=None) -> List[Dict]:
    """SIGHAN13 sample-set SGML (trainset.py:109-225)."""
    for old, new in _iter_fixes(text_fixes):
        text = text.replace(old, new)
    # Quote the UNQUOTED attribute only: \d+ leaves already-quoted values
    # and same-line '<MISTAKE ...><WRONG>' layouts alone (a greedy \S*
    # would swallow through the tag into the next element).
    text = re.sub(r"wrong_position=(\d+)>", r'wrong_position="\1">', text)
    root = _wrap_xml(text)
    records = []
    t2s = t2s or make_t2s()
    for doc in root:
        sid = f"sighan13-{doc.get('Nid').strip()}"
        src = normalize_punct(doc.find("P").text.strip().replace(" ", ""))
        mistakes = []
        for mk in doc.find("TEXT"):
            pos = int(mk.get("wrong_position")) - 1
            if pos < 0:
                continue
            wrong = normalize_punct(mk.find("WRONG").text.strip())
            correct = normalize_punct(mk.find("CORRECT").text.strip())
            left = _locate(src, wrong, pos)
            mistakes.append((left, wrong, correct))
        records.append(make_record(sid, src, mistakes, t2s=t2s))
    return records


def parse_sighan_training(text: str, year: int,
                          text_fixes=None,
                          t2s=None) -> List[Dict]:
    """SIGHAN14/15 training SGML (trainset.py:487-610)."""
    for old, new in _iter_fixes(text_fixes):
        text = text.replace(old, new)
    root = _wrap_xml(text)
    records = []
    t2s = t2s or make_t2s()
    for essay in root.findall("ESSAY"):
        passages: Dict[str, str] = {}
        mistakes: Dict[str, List[Tuple[int, str, str]]] = {}
        for passage in essay.find("TEXT").findall("PASSAGE"):
            pid = passage.get("id").strip()
            passages[pid] = normalize_punct(passage.text.strip())
            mistakes[pid] = []
        for mk in essay.findall("MISTAKE"):
            pid = mk.get("id").strip()
            src = passages[pid]
            pos = int(mk.get("location")) - 1
            wrong = normalize_punct(mk.find("WRONG").text.strip())
            correct = normalize_punct(mk.find("CORRECTION").text.strip())
            left = _locate(src, wrong, pos)
            mistakes[pid].append((left, wrong, correct))
        for pid, src in passages.items():
            records.append(
                make_record(f"sighan{year}-{pid}", src, mistakes[pid], t2s=t2s))
    return records


def parse_wang271k(text: str, t2s=None) -> List[Dict]:
    """Wang271K XML: single-char mistakes with explicit LOCATION
    (trainset.py:645-727)."""
    root = _wrap_xml(text)
    records = []
    t2s = t2s or make_t2s()
    for idx, doc in enumerate(root):
        sid = f"wang27k-{idx:06}"
        src = normalize_punct(doc.find("TEXT").text.strip())
        mistakes = []
        for mk in doc.findall("MISTAKE"):
            wrong = mk.find("WRONG").text.strip()
            correct = mk.find("CORRECTION").text.strip()
            pos = int(mk.find("LOCATION").text) - 1
            mistakes.append((pos, wrong, correct))
        records.append(make_record(sid, src, mistakes, t2s=t2s,
                                   collapse_english=False))
    return records


_PID_RE = re.compile(r"\(pid=(.+?)\)")


def parse_sighan_test(input_text: str, truth_text: str,
                      year: int, t2s=None,
                      apply_fixes: bool = True) -> List[Dict]:
    """SIGHAN test input (``(pid=…)\ttext``) + truth label lines
    (testset.py:125-254), including the per-year test repairs
    (testset.py:78-124 → realise_tpu_torch.data.fixes, keyed by pid)."""
    from realise_tpu_torch.data.fixes import TEST_LABEL_OVERRIDES, apply_test_fixes

    t2s = t2s or make_t2s()
    inputs = {}
    for line in input_text.splitlines():
        if not line.strip():
            continue
        head, _, sent = line.partition("\t")
        m = _PID_RE.search(head)
        pid = m.group(1) if m else head.strip()
        sent = sent.strip()
        if apply_fixes:
            sent = apply_test_fixes(year, pid, sent)
        inputs[pid] = normalize_punct(sent.replace(" ", ""))

    records = []
    for line in truth_text.splitlines():
        if not line.strip():
            continue
        if apply_fixes:
            pid_head = line.split(",", 1)[0].strip()
            line = TEST_LABEL_OVERRIDES.get((year, pid_head), line)
        parts = [p.strip() for p in re.split(r",\s*", line)]
        pid = parts[0]
        src = inputs[pid]
        mistakes = []
        if not (len(parts) == 2 and parts[1] == "0"):
            for i in range(1, len(parts) - 1, 2):
                pos = int(parts[i]) - 1
                correct = parts[i + 1]
                mistakes.append((pos, src[pos], correct))
        records.append(make_record(pid, src, mistakes, t2s=t2s))
    return records


# --------------------------------------------------------------------------
# TSV / label / pkl emission
# --------------------------------------------------------------------------
def write_tsv(records: Sequence[Dict], path: str) -> None:
    """``id\tsrc\ttgt\terrors`` rows (trainset.py:730-735)."""
    with open(path, "w", encoding="utf-8") as f:
        for r in records:
            errors = repr([(p, c) for p, c in r["errors"]])
            f.write(f"{r['id']}\t{r['src']}\t{r['tgt']}\t{errors}\n")


def read_tsv(path: str) -> List[Dict]:
    records = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            sid, src, tgt, errors = line.split("\t")
            records.append({"id": sid, "src": src, "tgt": tgt,
                            "errors": _parse_errors(errors)})
    return records


def _parse_errors(text: str) -> List[Tuple[int, str]]:
    # errors field is a python literal like "[(3, '好')]" — parse safely.
    import ast

    value = ast.literal_eval(text)
    return [(int(p), str(c)) for p, c in value]


def write_label_file(records: Sequence[Dict], path: str) -> None:
    """Gold label lines for the scorer (build_lbl.py)."""
    lines = []
    for r in records:
        if r["errors"]:
            parts = [r["id"]]
            for pos, c in r["errors"]:
                parts += [str(pos), c]
            lines.append(", ".join(parts))
        else:
            lines.append(f"{r['id']}, 0")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


def records_to_examples(records: Sequence[Dict], tokenizer,
                        max_len: Optional[int] = None) -> List[Dict]:
    """Cleaned records → runtime pkl examples (replaces dataset.py +
    process_data.py in one step — the intermediate batched pickle of the
    reference exists only to be flattened again, process_data.py:9-45)."""
    from realise_tpu_torch.data.features import make_example

    out = []
    for r in records:
        ex = make_example(r["id"], r["src"], r["tgt"], tokenizer)
        if max_len is not None and len(ex["src_idx"]) > max_len:
            continue  # length filter (dataset.py:96-101)
        out.append(ex)
    return out
