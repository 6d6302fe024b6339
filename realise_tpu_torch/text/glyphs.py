"""Glyph rasterization for the graphic ("See") stream (the port's own copy
of ``realise_tpu.text.glyphs``, the same tables for the same vocabulary).

Produces the frozen per-vocab glyph tensor ``(vocab, num_fonts, 32, 32)``
consumed by the CharResNet encoder, following the reference recipe
(reference: src/models.py:737-795):

* render each single Chinese character with a TTF font at size 32 via PIL
  ``font.getmask`` (src/models.py:777-778),
* crop to 32×32, center-pad smaller rasters (src/models.py:781-789),
* non-renderable tokens (multi-char word pieces, specials) are all-zeros,
* normalize globally by the mean/std of the *entire vocab tensor* per font
  (src/models.py:792-793 — staging matters: normalization is per-font over
  the full vocab, not per-glyph),
* fonts stack on a channel axis: simhei, xiaozhuan, and traditional-variant
  simhei (via an s2t converter) for the published ``font3_fanti`` preset
  (src/models.py:738-746, src/run.py:386-391).

This is host-side, ahead-of-time work: the result is a constant array baked
once and installed in the model (``Realise.install_glyphs``); the device step
only gathers rows from it.

When the TTF assets are unavailable (they are large binaries not shipped with
the repo), a deterministic procedural glyph generator keeps the full pipeline
runnable end-to-end: each codepoint hashes to a fixed 8×8 bitmap upsampled to
32×32, so distinct characters stay visually distinct and the res-pretrain
objective (classify a char from its glyph, src/run_res_pretrain.py:45-54)
remains learnable. Swap in real fonts for accuracy parity.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, List, Optional, Sequence

import numpy as np

GLYPH_SIZE = 32


# --------------------------------------------------------------------------
# Simplified → Traditional conversion (for the third font channel).
# Uses OpenCC when installed (the reference requires it, src/models.py:747);
# otherwise a small built-in mapping of common simplified/traditional pairs —
# identity for unmapped chars.
_S2T_BUILTIN = {
    "国": "國", "东": "東", "车": "車", "门": "門", "马": "馬", "鸟": "鳥",
    "龙": "龍", "书": "書", "长": "長", "风": "風", "飞": "飛", "云": "雲",
    "电": "電", "学": "學", "体": "體", "万": "萬", "与": "與", "专": "專",
    "业": "業", "丛": "叢", "个": "個", "丰": "豐", "临": "臨", "为": "為",
    "举": "舉", "义": "義", "乐": "樂", "习": "習", "乡": "鄉", "买": "買",
    "乱": "亂", "争": "爭", "于": "於", "亏": "虧", "产": "產", "亲": "親",
    "亿": "億", "仅": "僅", "从": "從", "仓": "倉", "仪": "儀", "们": "們",
    "价": "價", "众": "眾", "优": "優", "会": "會", "伛": "傴", "伞": "傘",
    "伟": "偉", "传": "傳", "伤": "傷", "伦": "倫",
    "华": "華", "协": "協", "单": "單", "卖": "賣", "南": "南", "博": "博",
    "厅": "廳", "历": "歷", "厉": "厲", "压": "壓", "厌": "厭", "县": "縣",
    "发": "發", "变": "變", "叙": "敘", "后": "後", "向": "向", "吓": "嚇",
    "吗": "嗎", "听": "聽", "启": "啟", "员": "員", "响": "響", "哑": "啞",
    "问": "問", "语": "語", "说": "說", "请": "請", "读": "讀",
    "谁": "誰", "调": "調", "谈": "談", "谢": "謝", "贝": "貝", "贡": "貢",
    "财": "財", "责": "責", "败": "敗", "货": "貨", "质": "質", "贵": "貴",
    "费": "費", "资": "資", "赛": "賽", "赵": "趙", "边": "邊",
    "达": "達", "过": "過", "迈": "邁", "运": "運", "还": "還", "这": "這",
    "进": "進", "远": "遠", "违": "違", "连": "連", "迟": "遲", "适": "適",
    "选": "選", "逊": "遜", "递": "遞", "逻": "邏", "遗": "遺", "邓": "鄧",
    "郑": "鄭", "钟": "鐘", "钢": "鋼", "铁": "鐵", "银": "銀", "错": "錯",
    "锦": "錦", "键": "鍵", "镇": "鎮", "间": "間", "闻": "聞",
    "阳": "陽", "阴": "陰", "陈": "陳", "际": "際", "陆": "陸", "队": "隊",
    "难": "難", "雾": "霧", "页": "頁", "顶": "頂", "项": "項", "顺": "順",
    "须": "須", "顾": "顧", "预": "預", "领": "領", "频": "頻", "题": "題",
    "颜": "顏", "额": "額", "饭": "飯", "饮": "飲", "饰": "飾", "馆": "館",
    "驶": "駛", "驻": "駐", "验": "驗", "鱼": "魚", "黄": "黃", "点": "點",
    "党": "黨", "齐": "齊", "济": "濟", "汉": "漢", "汤": "湯", "沟": "溝",
    "没": "沒", "泽": "澤", "浅": "淺", "测": "測", "浑": "渾", "浓": "濃",
    "涛": "濤", "滚": "滾", "满": "滿", "滨": "濱", "灭": "滅", "灯": "燈",
    "炉": "爐", "热": "熱", "爱": "愛", "牵": "牽", "犹": "猶", "独": "獨",
    "猎": "獵", "现": "現", "玛": "瑪", "环": "環", "础": "礎",
    "确": "確", "礼": "禮", "祸": "禍", "离": "離", "种": "種", "积": "積",
    "称": "稱", "窝": "窩", "竞": "競", "笔": "筆", "筛": "篩", "简": "簡",
    "类": "類", "粮": "糧", "紧": "緊", "纠": "糾", "红": "紅", "纤": "纖",
    "约": "約", "级": "級", "纪": "紀", "纯": "純", "纲": "綱", "纳": "納",
    "纵": "縱", "纷": "紛", "纸": "紙", "纹": "紋", "纽": "紐", "线": "線",
    "练": "練", "组": "組", "细": "細", "织": "織", "终": "終", "绍": "紹",
    "经": "經", "结": "結", "绕": "繞", "绘": "繪", "给": "給", "络": "絡",
    "绝": "絕", "统": "統", "继": "繼", "绩": "績", "维": "維", "绵": "綿",
    "缓": "緩", "编": "編", "缩": "縮", "缺": "缺", "网": "網", "罗": "羅",
    "罚": "罰", "罢": "罷", "联": "聯", "聪": "聰",
    "肃": "肅", "肠": "腸", "肤": "膚", "肾": "腎", "肿": "腫", "胀": "脹",
    "胜": "勝", "脏": "臟", "脑": "腦", "脱": "脫", "舰": "艦", "艰": "艱",
    "艺": "藝", "节": "節", "芦": "蘆", "苍": "蒼", "苏": "蘇", "药": "藥",
    "荐": "薦", "荣": "榮", "获": "獲", "莱": "萊", "营": "營", "蒋": "蔣",
    "蓝": "藍", "虑": "慮", "虚": "虛", "虫": "蟲", "蚁": "蟻", "蚂": "螞",
    "蜡": "蠟", "术": "術", "见": "見", "观": "觀", "规": "規", "视": "視",
    "览": "覽", "觉": "覺", "计": "計", "订": "訂", "认": "認", "讨": "討",
    "让": "讓", "训": "訓", "议": "議", "讯": "訊", "记": "記", "讲": "講",
    "许": "許", "论": "論", "设": "設", "访": "訪", "证": "證", "评": "評",
    "识": "識", "诉": "訴", "词": "詞", "译": "譯", "试": "試", "诗": "詩",
    "诚": "誠", "话": "話", "诞": "誕", "询": "詢", "详": "詳", "误": "誤",
}


def make_s2t_converter() -> Callable[[str], str]:
    try:
        import opencc  # type: ignore

        converter = opencc.OpenCC("s2t.json")
        return converter.convert
    except Exception:
        return lambda c: _S2T_BUILTIN.get(c, c)


# --------------------------------------------------------------------------
def _procedural_glyph(char: str, size: int = GLYPH_SIZE,
                      salt: int = 0) -> np.ndarray:
    """Deterministic pseudo-glyph: codepoint-seeded 8×8 bitmap → size×size.

    ``salt`` (the font-channel index) varies the hash so the multi-font
    stack gets pairwise-distinct channels even without real TTFs — the
    reference's three fonts (simhei/xiaozhuan/traditional) are genuinely
    different images (src/models.py:738-760)."""
    key = f"{salt}:{char}".encode("utf-8")
    digest = hashlib.blake2b(key, digest_size=8).digest()
    bits = np.unpackbits(np.frombuffer(digest, dtype=np.uint8))  # 64 bits
    small = bits.reshape(8, 8).astype(np.float32) * 255.0
    scale = max(size // 8, 1)
    img = np.kron(small, np.ones((scale, scale), dtype=np.float32))
    if img.shape[0] != size:  # size not a multiple of 8: pad/crop to exact
        out = np.zeros((size, size), dtype=np.float32)
        n = min(size, img.shape[0])
        out[:n, :n] = img[:n, :n]
        return out
    return img


def _pil_glyph(font, char: str, size: int) -> np.ndarray:
    """Rasterize one char with PIL, crop/center-pad to size×size."""
    mask = font.getmask(char)
    image = np.asarray(mask, dtype=np.float32).reshape(mask.size[::-1])
    image = image[:size, :size]
    if image.shape != (size, size):
        back = np.zeros((size, size), dtype=np.float32)
        off0 = (size - image.shape[0]) // 2
        off1 = (size - image.shape[1]) // 2
        back[off0 : off0 + image.shape[0], off1 : off1 + image.shape[1]] = image
        image = back
    return image


def render_vocab_font(
    vocab: Sequence[str],
    font_path: Optional[str] = None,
    font_size: int = GLYPH_SIZE,
    use_traditional: bool = False,
    is_renderable: Optional[Callable[[str], bool]] = None,
    procedural_salt: int = 0,
) -> np.ndarray:
    """Render all vocab tokens with one font → (V, 32, 32) float32, globally
    mean/std normalized over the whole tensor (src/models.py:792-793)."""
    from realise_tpu_torch.text.tokenizer import is_chinese_char

    if is_renderable is None:
        is_renderable = lambda c: len(c) == 1 and is_chinese_char(ord(c))

    if use_traditional:
        s2t = make_s2t_converter()
        vocab = [s2t(c) if len(c) == 1 else c for c in vocab]

    font = None
    if font_path is not None and os.path.exists(font_path):
        from PIL import ImageFont

        font = ImageFont.truetype(font_path, size=font_size)

    images = np.zeros((len(vocab), font_size, font_size), dtype=np.float32)
    for i, char in enumerate(vocab):
        if not is_renderable(char):
            continue
        if font is not None:
            images[i] = _pil_glyph(font, char, font_size)
        else:
            images[i] = _procedural_glyph(char, font_size,
                                          salt=procedural_salt)

    std = images.std()
    if std == 0:
        std = 1.0
    return (images - images.mean()) / std


def build_glyph_table(
    vocab: Sequence[str],
    num_fonts: int = 3,
    use_traditional_font: bool = True,
    font_paths: Optional[List[str]] = None,
    font_size: int = GLYPH_SIZE,
) -> np.ndarray:
    """Build the (V, num_fonts, 32, 32) multi-font glyph tensor.

    Font plan mirrors the reference presets (src/models.py:738-746 +
    src/run.py:380-391): fonts are [simhei, xiaozhuan, simhei] and when
    ``use_traditional_font`` the last channel renders traditional variants.
    """
    if num_fonts > 3:
        raise ValueError(
            f"num_fonts={num_fonts}: the font plan has 3 channels "
            f"(simhei/xiaozhuan/traditional-simhei, src/models.py:738-746); "
            f"a larger num_fonts would silently shape-mismatch the conv")
    if not font_paths:  # None or [] → procedural fallback on every channel
        font_paths = [None] * 3
    plan = [
        (font_paths[0] if len(font_paths) > 0 else None, False),   # simhei
        (font_paths[1] if len(font_paths) > 1 else None, False),   # xiaozhuan
        (font_paths[2] if len(font_paths) > 2 else font_paths[0], False),
    ][:num_fonts]
    # Traditional variants replace the LAST channel — only meaningful with
    # ≥2 channels (the reference's fanti presets are font2_fanti /
    # font3_fanti; font1 never renders traditional, run.py:380-391 — a
    # single-font model must see the simplified glyphs its input text is
    # written in).
    if use_traditional_font and len(plan) >= 2:
        base = font_paths[0] if font_paths else None
        plan = plan[:-1] + [(base, True)]

    channels = [
        render_vocab_font(vocab, font_path=fp, font_size=font_size,
                          use_traditional=trad, procedural_salt=i)
        for i, (fp, trad) in enumerate(plan)
    ]
    return np.stack(channels, axis=1)
