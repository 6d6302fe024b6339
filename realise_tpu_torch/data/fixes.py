"""Hand-written data repairs for the raw SIGHAN corpus files (the port's own
copy of ``realise_tpu.data.fixes``).

The upstream SIGHAN SGML/XML releases contain mojibake (U+FFFD from a bad
transcode), off-by-one MISTAKE positions, length-mismatched corrections and
stray ASCII punctuation. The reference patches these with ~60 per-corpus
byte replacements before parsing (reference: data_process/trainset.py
fix_data_train_13 :77-106, fix_data_train_14_B1 :228-326,
fix_data_train_14_C1 :330-336, fix_data_train_15_A2 :338-372,
fix_data_train_15_B2 :375-485) and per-year test-input/label repairs
(data_process/testset.py:78-124).

These are DATA, not logic: the exact replacement strings are dictated by the
corrupt bytes in the published corpus files, so they are carried verbatim as
declarative tables here. Two reference behaviors are intentionally not
replicated:

* testset.py:102 assigns row 957 from row 491 (``input_rows[957][1] =
  input_rows[491][1]...``) — an indexing bug that silently duplicates one
  sentence; we repair row B1-3917-2 in place instead,
* fixes apply keyed by corpus/pid rather than by hard-coded row numbers, so
  a re-released corpus with reordered rows fails loudly instead of patching
  the wrong sentence.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

FixPairs = Sequence[Tuple[str, str]]

# ---------------------------------------------------------------------------
# Training SGML repairs, applied to the raw file text before XML parsing.
# Keyed by the corpus file the reference dispatches on (trainset.py:496-502).
# ---------------------------------------------------------------------------
TRAIN_FIXES: Dict[str, FixPairs] = {
    # SIGHAN13 sample set, WithError file only (trainset.py:77-106,114-115).
    "sighan13-witherror": (
        ("對我洗腦，我�堅定的心，就這樣被他所動遙了。</P>",
         "對我洗腦，我堅定的心，就這樣被他所動遙了。</P>"),
        ("<MISTAKE wrong_position=64>\n<WRONG>動遙</WRONG>\n<CORRECT>動搖</CORRECT>\n",
         "<MISTAKE wrong_position=63>\n<WRONG>動遙</WRONG>\n<CORRECT>動搖</CORRECT>\n"),
        ("<MISTAKE wrong_position=16>\n<WRONG>輕意</WRONG>\n<CORRECT>輕易</CORRECT>\n",
         "<MISTAKE wrong_position=17>\n<WRONG>輕意</WRONG>\n<CORRECT>輕易</CORRECT>\n"),
        ("<MISTAKE wrong_position=21>\n<WRONG>徬惶</WRONG>\n<CORRECT>徬徨</CORRECT>\n",
         "<MISTAKE wrong_position=22>\n<WRONG>徬惶</WRONG>\n<CORRECT>徬徨</CORRECT>\n"),
    ),
    # SIGHAN14 B1_training.sgml (trainset.py:228-326).
    "sighan14-b1": (
        # mojibake (U+FFFD) restorations
        ("他們多很高興�以我也陪他們高空彈跳。</PASSAGE>",
         "他們多很高興所以我也陪他們高空彈跳。</PASSAGE>"),
        ("<WRONG>根也是一個能賺錢��方法</WRONG>",
         "<WRONG>根也是一個能賺錢的方法</WRONG>"),
        ("因為哪裡什麼花都沒有，所以有�點兒奇怪，可是我更喜歡看樹",
         "因為哪裡什麼花都沒有，所以有一點兒奇怪，可是我更喜歡看樹"),
        ("<WRONG>我�的班的同學在台灣學中文含我有些同學</WRONG>",
         "<WRONG>我們的班的同學在台灣學中文含我有些同學</WRONG>"),
        ('<PASSAGE id="B1-1388-1">我在網路上買了新的電子辭典，因為�網路上買的話',
         '<PASSAGE id="B1-1388-1">我在網路上買了新的電子辭典，因為在網路上買的話'),
        ("我去過森林�市、淡水", "我去過森林都市、淡水"),
        ('<PASSAGE id="B1-2358-1">因為我家�近有大安公園',
         '<PASSAGE id="B1-2358-1">因為我家附近有大安公園'),
        ('<PASSAGE id="B1-3102-2">因為我知道他們�戀愛',
         '<PASSAGE id="B1-3102-2">因為我知道他們的戀愛'),
        ("還有��多好朋友們等等。</PASSAGE>", "還有很多好朋友們等等。</PASSAGE>"),
        ("著，�自己要有信心不要為了小事而害上我們的身體。</PASSAGE>",
         "著，对自己要有信心不要為了小事而害上我們的身體。</PASSAGE>"),
        # corrections that contradict their WRONG span
        ("<CORRECTION>跟也是一個能賺錢的方法</CORRECTION>",
         "<CORRECTION>这也是一個能賺錢的方法</CORRECTION>"),
        ("<CORRECTION>累地我把門打開</CORRECTION>",
         "<CORRECTION>累得我把門打開</CORRECTION>"),
        # wrong MISTAKE locations
        ('<MISTAKE id="B1-3202-1" location="19">', '<MISTAKE id="B1-3202-1" location="35">'),
        ('<MISTAKE id="B1-2119-2" location="38">', '<MISTAKE id="B1-2119-2" location="11">'),
        # length-mismatched corrections
        ("<CORRECTION>挑戰性心</CORRECTION>", "<CORRECTION>挑戰性</CORRECTION>"),
        ("<CORRECTION>過時間</CORRECTION>", "<CORRECTION>過的時間</CORRECTION>"),
        # stray ASCII punctuation
        ("真的是人山人海.我不知道我在哪裡。</PASSAGE>",
         "真的是人山人海，我不知道我在哪裡。</PASSAGE>"),
        ("也幫我替你爸媽好!！</PASSAGE>", "也幫我替你爸媽好！</PASSAGE>"),
        ("前三部！但衣服店是滿多了。]</PASSAGE>", "前三部！但衣服店是滿多了。</PASSAGE>"),
        ("大學，見到他我非常高興，</PASSAGE>", "大學，見到他我非常高興。</PASSAGE>"),
        # repeated chars in WRONG span shift the location
        ('<MISTAKE id="B1-1607-3" location="11">', '<MISTAKE id="B1-1607-3" location="12">'),
        ('<MISTAKE id="B1-2399-3" location="9">', '<MISTAKE id="B1-2399-3" location="11">'),
        ('<MISTAKE id="B1-2598-2" location="16">', '<MISTAKE id="B1-2598-2" location="18">'),
    ),
    # SIGHAN14 C1_training.sgml (trainset.py:330-336).
    "sighan14-c1": (
        ('<MISTAKE id="C1-1800-2" location="29">', '<MISTAKE id="C1-1800-2" location="22">'),
    ),
    # SIGHAN15 A2 training (trainset.py:338-372).
    "sighan15-a2": (
        # an essay whose MISTAKE annotations are unrecoverable — dropped
        ('<ESSAY title="難忘的旅遊經驗">\n<TEXT>\n'
         '<PASSAGE id="A2-0782-1">走路的時候他試試看廳路上的汽車，'
         '就一位先生廳還告訴對我弟弟，他也到英國去，所以我弟弟可以跟他一起走。</PASSAGE>\n'
         '</TEXT>\n'
         '<MISTAKE id="A2-0782-1" location="10">\n<WRONG>廳路上</WRONG>\n'
         '<CORRECTION>聽路上</CORRECTION>\n</MISTAKE>\n'
         '<MISTAKE id="A2-0782-1" location="22">\n<WRONG>廰</WRONG>\n'
         '<CORRECTION>停</CORRECTION>\n</MISTAKE>\n</ESSAY>\n', ""),
        ('<MISTAKE id="A2-1291-1" location="16">', '<MISTAKE id="A2-1291-1" location="15">'),
        ('<MISTAKE id="A2-3313-1" location="14">', '<MISTAKE id="A2-3313-1" location="1">'),
        ('<PASSAGE id="A2-0087-3">她提以他們五點晚上去電影院看一個新電影．</PASSAGE>',
         '<PASSAGE id="A2-0087-3">她提以他們五點晚上去電影院看一個新電影。</PASSAGE>'),
        ('<MISTAKE id="A2-3380-1" location="13">', '<MISTAKE id="A2-3380-1" location="14">'),
    ),
    # SIGHAN15 B2 training (trainset.py:375-485).
    "sighan15-b2": (
        ('<PASSAGE id="B2-1454-6">此至，祝大安</PASSAGE>',
         '<PASSAGE id="B2-1454-5">此至，祝大安。</PASSAGE>'),
        ('<PASSAGE id="B2-3859-6">我覺得在網路上很',
         '<PASSAGE id="B2-3859-5">我覺得在網路上很'),
        ('<PASSAGE id="B2-4303-3">當然老', '<PASSAGE id="B2-4303-2">當然老'),
        ("<CORRECTION>同樣</CORRECTION>", "<CORRECTION>同樣地</CORRECTION>"),
        ("<WRONG>須機</WRONG>", "<WRONG>須要</WRONG>"),
        ('<MISTAKE id="B2-1683-2" location="1">', '<MISTAKE id="B2-1683-2" location="7">'),
        ('<MISTAKE id="B2-1683-4" location="31">', '<MISTAKE id="B2-1683-4" location="35">'),
        ('<MISTAKE id="B2-1978-4" location="24">\n<WRONG>華連</WRONG>\n'
         '<CORRECTION>花蓮</CORRECTION>\n</MISTAKE>\n', ""),
        ('<MISTAKE id="B2-2427-1" location="21">\n<WRONG>天天餵牠吃</WRONG>\n'
         '<CORRECTION> </CORRECTION>\n</MISTAKE>\n',
         '<MISTAKE id="B2-2427-1" location="33">\n<WRONG>天天為牠吃</WRONG>\n'
         '<CORRECTION>天天餵牠吃</CORRECTION>\n</MISTAKE>\n'),
        ('<MISTAKE id="B2-3666-4" location="10">\n<WRONG>他有沒有</WRONG>\n'
         '<CORRECTION>她有沒有</CORRECTION>\n</MISTAKE>\n'
         '<MISTAKE id="B2-3666-4" location="24">\n<WRONG>他不需要上班</WRONG>\n'
         '<CORRECTION>她不需要上班</CORRECTION>\n</MISTAKE>\n', ""),
        ('<MISTAKE id="B2-3666-4" location="24">\n<WRONG>做他愛做的事情</WRONG>\n'
         '<CORRECTION>做她愛做的事情</CORRECTION>\n</MISTAKE>\n', ""),
        ('<MISTAKE id="B2-3772-1" location="22">', '<MISTAKE id="B2-3772-1" location="15">'),
        ('<MISTAKE id="B2-3772-2" location="16">', '<MISTAKE id="B2-3772-2" location="22">'),
        ('<MISTAKE id="B2-3772-4" location="13">', '<MISTAKE id="B2-3772-4" location="16">'),
        ('<WRONG>圍週</WRONG>\n<CORRECTION>圍周</CORRECTION>\n',
         '<WRONG>圍周</WRONG>\n<CORRECTION>圍週</CORRECTION>\n'),
        ('<PASSAGE id="B2-4022-3">我們提針下列方法、加一張壁板在',
         '<PASSAGE id="B2-4022-3">我們提針下列方法：加一張壁板在'),
        ('<MISTAKE id="B2-4028-3" location="32">', '<MISTAKE id="B2-4028-3" location="30">'),
        ("把自己跟被偷東西的人換位子想。心</PASSAGE>",
         "把自己跟被偷東西的人換位子想。</PASSAGE>"),
        ("方說空氣阿、水阿、土地阿、越來越壞掉了。]</PASSAGE>",
         "方說空氣阿、水阿、土地阿、越來越壞掉了。</PASSAGE>"),
        ("前的那麼好。他真的賠了夫人又折兵﹗</PASSAGE>",
         "前的那麼好。他真的賠了夫人又折兵！</PASSAGE>"),
        ('<MISTAKE id="B2-4327-3" location="26">', '<MISTAKE id="B2-4327-3" location="30">'),
        ('<PASSAGE id="B2-4350-2">我想網站也��一個東西很好的，',
         '<PASSAGE id="B2-4350-2">我想網站也是一個東西很好的，'),
    ),
}


def train_fixes_for(path: str, year: int) -> FixPairs:
    """Select the repair table for a raw training file the way the
    reference dispatches on filename (trainset.py:113-115,496-502)."""
    name = path.rsplit("/", 1)[-1]
    if year == 13:
        return TRAIN_FIXES["sighan13-witherror"] if "WithError" in name else ()
    if year == 14:
        if "B1" in name:
            return TRAIN_FIXES["sighan14-b1"]
        if "C1" in name:
            return TRAIN_FIXES["sighan14-c1"]
    if year == 15:
        if "A2" in name:
            return TRAIN_FIXES["sighan15-a2"]
        if "B2" in name:
            return TRAIN_FIXES["sighan15-b2"]
    return ()


# ---------------------------------------------------------------------------
# Test-set repairs (testset.py:78-124), keyed by (year, pid) instead of the
# reference's hard-coded row indices so reordered files fail loudly.
# ---------------------------------------------------------------------------
# (old, new) replacements on the input sentence of one pid.
TEST_INPUT_FIXES: Dict[Tuple[int, str], FixPairs] = {
    (14, "B1-0623-2"): (("（", ""), ("）", "")),
    (14, "B1-1430-2"): (("．．．", "。"),),
    # testset.py:102 patches this row from row 491's text (an indexing bug);
    # repaired in place here instead.
    (14, "B1-3917-2"): (("．．．", "。"),),
    (15, "A2-0506-1"): (("所以我在＂義大利麵方子＂已經定位了",
                         "所以我在“義大利麵方子”已經定位了。"),),
    (15, "B2-3625-3"): (("一聲＂爺爺＂。", "一聲“爺爺”。"),),
    (15, "B2-4252-7"): (("他們說＂你的父母", "他們說你的父母"),),
    (15, "B2-4393-2"): (("理：＂對阿，我根", "理：“對阿，我根"),
                        ("相信我嗎？＂", "相信我嗎？”")),
    (15, "B2-4131-1"): (("（", ""), ("）", ""), ("的不好吧！…", "的不好吧！")),
}

# pids whose truth line is replaced outright (both have broken annotations
# in the released labels, testset.py:86-91).
TEST_LABEL_OVERRIDES: Dict[Tuple[int, str], str] = {
    (14, "B1-1430-2"): "B1-1430-2, 0",
    (14, "B1-2164-1"): "B1-2164-1, 0",
}

# Year-13 test inputs: strip ellipses and ASCII parens from every sentence
# (testset.py:80-84).
TEST_GLOBAL_STRIP_13 = ("…", "(", ")")


def apply_test_fixes(year: int, pid: str, sent: str) -> str:
    if year == 13:
        for ch in TEST_GLOBAL_STRIP_13:
            sent = sent.replace(ch, "")
    for old, new in TEST_INPUT_FIXES.get((year, pid), ()):
        sent = sent.replace(old, new)
    return sent
