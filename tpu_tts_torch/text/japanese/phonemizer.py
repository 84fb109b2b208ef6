"""Japanese text → romaji-style phonemes.

Copy of `tpu_tts/text/japanese/phonemizer.py`, the surface of Coqui TTS
`TTS/tts/utils/text/japanese/phonemizer.py` (`japanese_text_to_phonemes`, `kata2phoneme`, `hira2kata`, `text2kata`).
Kana → phoneme conversion is native (standard Hepburn-style tables built
programmatically from the gojūon grid plus yōon digraphs, sokuon gemination,
and chōon vowel lengthening). Kanji reading requires MeCab and is gated —
without it, kanji characters pass through unchanged. Number expansion uses a
native sino-japanese reader instead of num2words."""

import re
import unicodedata
from typing import Dict

# --------------------------------------------------------------------------- #
# kana → romaji tables (Hepburn)                                              #
# --------------------------------------------------------------------------- #

_KATA2ROMA: Dict[str, str] = {
    "ア": "a", "イ": "i", "ウ": "u", "エ": "e", "オ": "o",
    "カ": "ka", "キ": "ki", "ク": "ku", "ケ": "ke", "コ": "ko",
    "サ": "sa", "シ": "shi", "ス": "su", "セ": "se", "ソ": "so",
    "タ": "ta", "チ": "chi", "ツ": "tsu", "テ": "te", "ト": "to",
    "ナ": "na", "ニ": "ni", "ヌ": "nu", "ネ": "ne", "ノ": "no",
    "ハ": "ha", "ヒ": "hi", "フ": "fu", "ヘ": "he", "ホ": "ho",
    "マ": "ma", "ミ": "mi", "ム": "mu", "メ": "me", "モ": "mo",
    "ヤ": "ya", "ユ": "yu", "ヨ": "yo",
    "ラ": "ra", "リ": "ri", "ル": "ru", "レ": "re", "ロ": "ro",
    "ワ": "wa", "ヲ": "o", "ン": "N",
    "ガ": "ga", "ギ": "gi", "グ": "gu", "ゲ": "ge", "ゴ": "go",
    "ザ": "za", "ジ": "ji", "ズ": "zu", "ゼ": "ze", "ゾ": "zo",
    "ダ": "da", "ヂ": "ji", "ヅ": "zu", "デ": "de", "ド": "do",
    "バ": "ba", "ビ": "bi", "ブ": "bu", "ベ": "be", "ボ": "bo",
    "パ": "pa", "ピ": "pi", "プ": "pu", "ペ": "pe", "ポ": "po",
    "ヴ": "vu",
    "ァ": "a", "ィ": "i", "ゥ": "u", "ェ": "e", "ォ": "o",
}

# yōon digraphs: consonant kana (i-column) + small ya/yu/yo
# yōon: onset prefix (no vowel) + small ya/yu/yo vowel. sh/ch/j absorb the
# glide (シャ=sha), the rest keep it (キャ=kya).
_SMALL_Y = {"ャ": "a", "ュ": "u", "ョ": "o"}
_YOON_ONSET = {
    "キ": "ky", "ギ": "gy", "シ": "sh", "ジ": "j", "チ": "ch", "ヂ": "j",
    "ニ": "ny", "ヒ": "hy", "ビ": "by", "ピ": "py", "ミ": "my", "リ": "ry",
}


def hira2kata(text: str) -> str:
    """Hiragana → katakana (ref :348); pure codepoint shift."""
    out = []
    for ch in text:
        c = ord(ch)
        if 0x3041 <= c <= 0x3096:
            out.append(chr(c + 0x60))
        else:
            out.append(ch)
    return "".join(out)


def kata2phoneme(text: str) -> str:
    """Katakana → space-separated romaji phonemes (ref :321)."""
    res = []
    i = 0
    n = len(text)
    while i < n:
        ch = text[i]
        if ch == "ッ":  # sokuon: geminate the next consonant
            nxt_rom = None
            if i + 1 < n:
                j = i + 1
                if j + 1 < n and text[j] in _YOON_ONSET and text[j + 1] in _SMALL_Y:
                    nxt_rom = _YOON_ONSET[text[j]] + _SMALL_Y[text[j + 1]]
                elif text[j] in _KATA2ROMA:
                    nxt_rom = _KATA2ROMA[text[j]]
            if nxt_rom and nxt_rom[0].isalpha():
                res.append(nxt_rom[0])
            else:
                res.append("q")
            i += 1
            continue
        if ch == "ー":  # chōon: lengthen the previous vowel
            if res and res[-1] and res[-1][-1] in "aiueo":
                res.append(res[-1][-1])
            i += 1
            continue
        if i + 1 < n and ch in _YOON_ONSET and text[i + 1] in _SMALL_Y:
            res.append(_YOON_ONSET[ch] + _SMALL_Y[text[i + 1]])
            i += 2
            continue
        if ch in _KATA2ROMA:
            res.append(_KATA2ROMA[ch])
        else:
            res.append(ch)
        i += 1
    return " ".join(res)


def text2kata(text: str) -> str:
    """Mixed text → katakana (ref :358). Kanji reading needs MeCab (fugashi or
    mecab-python3 + a dictionary); hiragana converts natively; kanji pass
    through unchanged when MeCab is unavailable."""
    try:
        import MeCab

        tagger = MeCab.Tagger()
        out = []
        node = tagger.parseToNode(text)
        while node:
            feats = node.feature.split(",")
            reading = feats[7] if len(feats) > 7 and feats[7] != "*" else node.surface
            out.append(reading)
            node = node.next
        return hira2kata("".join(out))
    except Exception:
        return hira2kata(text)


# --------------------------------------------------------------------------- #
# number / symbol expansion                                                   #
# --------------------------------------------------------------------------- #

_JA_DIGITS = ["ゼロ", "イチ", "ニ", "サン", "ヨン", "ゴ", "ロク", "ナナ", "ハチ", "キュウ"]
_JA_UNITS1 = ["", "ジュウ", "ヒャク", "セン"]
_JA_UNITS2 = ["", "マン", "オク", "チョウ"]
# irregular sound changes (rendaku/gemination) for hundreds and thousands
_JA_IRREGULAR = {
    ("サン", "ヒャク"): "サンビャク", ("ロク", "ヒャク"): "ロッピャク", ("ハチ", "ヒャク"): "ハッピャク",
    ("サン", "セン"): "サンゼン", ("ハチ", "セン"): "ハッセン", ("イチ", "チョウ"): "イッチョウ",
}


def _ja_read_group(g: int) -> str:
    out = []
    for pos in range(3, -1, -1):
        d = (g // 10**pos) % 10
        if d == 0:
            continue
        digit = "" if (d == 1 and pos > 0) else _JA_DIGITS[d]
        unit = _JA_UNITS1[pos]
        comb = _JA_IRREGULAR.get((_JA_DIGITS[d], unit))
        out.append(comb if comb else digit + unit)
    return "".join(out)


def _ja_number_to_kata(num: str) -> str:
    integer, _, frac = num.partition(".")
    n = int(integer or "0")
    if n == 0:
        body = _JA_DIGITS[0]
    else:
        parts = []
        gi = 0
        while n > 0:
            g = n % 10000
            if g:
                parts.append(_ja_read_group(g) + _JA_UNITS2[gi])
            n //= 10000
            gi += 1
        body = "".join(reversed(parts))
    if frac:
        body += "テン" + "".join(_JA_DIGITS[int(c)] for c in frac)
    return body


_NUMBER_WITH_SEPARATOR_RX = re.compile("[0-9]{1,3}(,[0-9]{3})+")
_CURRENCY_MAP = {"$": "ドル", "¥": "エン", "£": "ポンド", "€": "ユーロ"}
_CURRENCY_RX = re.compile(r"([$¥£€])([0-9.]*[0-9])")
_NUMBER_RX = re.compile(r"[0-9]+(\.[0-9]+)?")

_ALPHASYMBOL_YOMI = {
    "a": "エー", "b": "ビー", "c": "シー", "d": "ディー", "e": "イー", "f": "エフ",
    "g": "ジー", "h": "エイチ", "i": "アイ", "j": "ジェー", "k": "ケー", "l": "エル",
    "m": "エム", "n": "エヌ", "o": "オー", "p": "ピー", "q": "キュー", "r": "アール",
    "s": "エス", "t": "ティー", "u": "ユー", "v": "ブイ", "w": "ダブリュー",
    "x": "エックス", "y": "ワイ", "z": "ゼット",
    "#": "シャープ", "%": "パーセント", "&": "アンド", "+": "プラス", "-": "マイナス",
    "=": "イコール", "@": "アット", "α": "アルファ", "β": "ベータ", "π": "パイ", "ω": "オメガ",
}


def japanese_convert_numbers_to_words(text: str) -> str:
    res = _NUMBER_WITH_SEPARATOR_RX.sub(lambda m: m[0].replace(",", ""), text)
    res = _CURRENCY_RX.sub(lambda m: m[2] + _CURRENCY_MAP.get(m[1], m[1]), res)
    return _NUMBER_RX.sub(lambda m: _ja_number_to_kata(m[0]), res)


def japanese_convert_alpha_symbols_to_words(text: str) -> str:
    return "".join(_ALPHASYMBOL_YOMI.get(ch, ch) for ch in text.lower())


def japanese_text_to_phonemes(text: str) -> str:
    """Full pipeline (ref :463): NFKC → numbers → letters/symbols → kana →
    romaji phonemes."""
    res = unicodedata.normalize("NFKC", text)
    res = japanese_convert_numbers_to_words(res)
    res = japanese_convert_alpha_symbols_to_words(res)
    res = text2kata(res)
    res = kata2phoneme(res)
    return res.replace(" ", "")
