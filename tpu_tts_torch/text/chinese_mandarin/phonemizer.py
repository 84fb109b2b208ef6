"""Mandarin hanzi → phoneme string.

Copy of `tpu_tts/text/chinese_mandarin/phonemizer.py`, the surface of Coqui
TTS `TTS/tts/utils/text/chinese_mandarin/phonemizer.py` (`chinese_text_to_phonemes`): hanzi → tone3 pinyin (pypinyin,
with jieba word segmentation when available) → IPA via the compositional table
in pinyin_ipa.py, tone digit appended per syllable."""

from typing import List

from tpu_tts_torch.text.chinese_mandarin.pinyin_ipa import pinyin_to_ipa


def _chinese_character_to_pinyin(text: str) -> List[str]:
    import pypinyin  # gated optional dependency

    pinyins = pypinyin.pinyin(text, style=pypinyin.Style.TONE3, heteronym=False, neutral_tone_with_five=True)
    return [item for sublist in pinyins for item in sublist]


def _chinese_pinyin_to_phoneme(pinyin: str) -> str:
    segment, tone = pinyin[:-1], pinyin[-1]
    return pinyin_to_ipa(segment) + tone


def chinese_text_to_phonemes(text: str, seperator: str = "|") -> str:
    try:
        import jieba

        text = " ".join(jieba.cut(text, HMM=False))
    except ImportError:
        pass
    pinyined: List[str] = _chinese_character_to_pinyin(text)
    results: List[str] = []
    for token in pinyined:
        if token and token[-1] in "12345":
            results += list(_chinese_pinyin_to_phoneme(token))
        else:  # punctuation / non-hanzi
            results += list(token)
    return seperator.join(results)
