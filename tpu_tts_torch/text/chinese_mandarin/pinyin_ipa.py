"""Compositional pinyin-syllable → IPA mapping for Mandarin.

A copy of `tpu_tts/text/chinese_mandarin/pinyin_ipa.py`. It replaces Coqui
TTS's hand-written 419-line lookup table
(`TTS/tts/utils/text/chinese_mandarin/pinyinToPhonemes.py`) with
an initial+final composition: every legal syllable is the concatenation of an
initial consonant mapping and a final (rime) mapping, with the standard
orthographic adjustments (y/w onsets, ü spelling rules, and the apical vowels
of zhi/chi/shi/ri/zi/ci/si). Tones (1-5) are appended as digits by the caller.
"""

from typing import Dict

# initials, longest match first
_INITIALS: Dict[str, str] = {
    "zh": "ʈʂ", "ch": "ʈʂʰ", "sh": "ʂ",
    "b": "p", "p": "pʰ", "m": "m", "f": "f",
    "d": "t", "t": "tʰ", "n": "n", "l": "l",
    "g": "k", "k": "kʰ", "h": "x",
    "j": "tɕ", "q": "tɕʰ", "x": "ɕ",
    "r": "ʐ", "z": "ts", "c": "tsʰ", "s": "s",
}

# finals in pinyin orthography (as written after an initial)
_FINALS: Dict[str, str] = {
    "a": "a", "o": "o", "e": "ɤ", "ai": "ai", "ei": "ei", "ao": "au", "ou": "ou",
    "an": "an", "en": "ən", "ang": "aŋ", "eng": "əŋ", "ong": "ʊŋ", "er": "ɚ",
    "i": "i", "ia": "ja", "ie": "jɛ", "iao": "jau", "iu": "jou", "ian": "jɛn",
    "in": "in", "iang": "jaŋ", "ing": "iŋ", "iong": "jʊŋ",
    "u": "u", "ua": "wa", "uo": "wo", "uai": "wai", "ui": "wei", "uan": "wan",
    "un": "wən", "uang": "waŋ", "ueng": "wəŋ",
    "v": "y", "ve": "ɥɛ", "van": "ɥɛn", "vn": "yn",
}

# standalone syllables written with y/w (no initial consonant)
_STANDALONE: Dict[str, str] = {
    "yi": "i", "ya": "ja", "ye": "jɛ", "yao": "jau", "you": "jou", "yan": "jɛn",
    "yin": "in", "yang": "jaŋ", "ying": "iŋ", "yong": "jʊŋ",
    "wu": "u", "wa": "wa", "wo": "wo", "wai": "wai", "wei": "wei", "wan": "wan",
    "wen": "wən", "wang": "waŋ", "weng": "wəŋ",
    "yu": "y", "yue": "ɥɛ", "yuan": "ɥɛn", "yun": "yn",
    "a": "a", "o": "o", "e": "ɤ", "ai": "ai", "ei": "ei", "ao": "au", "ou": "ou",
    "an": "an", "en": "ən", "ang": "aŋ", "eng": "əŋ", "er": "ɚ",
}

# apical vowels: zhi/chi/shi/ri → ʅ ; zi/ci/si → ɿ (written with ɹ̩-style IPA)
_APICAL_RETROFLEX = {"zh", "ch", "sh", "r"}
_APICAL_DENTAL = {"z", "c", "s"}


def pinyin_to_ipa(syllable: str) -> str:
    """Toneless pinyin syllable → IPA string; returns the input unchanged when
    it isn't a recognizable syllable."""
    s = syllable.lower()
    if s in _STANDALONE:
        return _STANDALONE[s]
    for init in sorted(_INITIALS, key=len, reverse=True):
        if s.startswith(init):
            final = s[len(init):]
            if final == "i" and init in _APICAL_RETROFLEX:
                return _INITIALS[init] + "ʐ̩"
            if final == "i" and init in _APICAL_DENTAL:
                return _INITIALS[init] + "z̩"
            # ü is written u after j/q/x
            if init in ("j", "q", "x") and final and final[0] == "u":
                final = "v" + final[1:]
            final = final.replace("ü", "v")
            if final in _FINALS:
                return _INITIALS[init] + _FINALS[final]
            return syllable
    return syllable


def build_pinyin_dict() -> Dict[str, str]:
    """Enumerate every initial+final combination → IPA (drop-in for
    Coqui's PINYIN_DICT lookups)."""
    table = dict(_STANDALONE)
    for init in _INITIALS:
        for final in _FINALS:
            table[init + final] = pinyin_to_ipa(init + final)
        table[init + "i"] = pinyin_to_ipa(init + "i")
    return table
