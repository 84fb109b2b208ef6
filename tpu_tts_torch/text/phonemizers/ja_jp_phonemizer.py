"""Japanese phonemizer wrapper (copy of `tpu_tts/text/phonemizers/
ja_jp_phonemizer.py`; Coqui TTS `TTS/tts/utils/text/phonemizers/ja_jp_phonemizer.py`). Kana → romaji is native; kanji reading
requires MeCab and passes through unchanged without it."""

from tpu_tts_torch.text.japanese.phonemizer import japanese_text_to_phonemes
from tpu_tts_torch.text.phonemizers.base import BasePhonemizer

_DEF_JA_PUNCS = "、.,[]()?!〽~『』「」【】"


class JA_JP_Phonemizer(BasePhonemizer):
    """Japanese text → romaji phonemes (ref ja_jp_phonemizer.py:8)."""

    language = "ja-jp"

    def __init__(self, punctuations=_DEF_JA_PUNCS, keep_puncs=True, **kwargs):
        super().__init__(self.language, punctuations=punctuations, keep_puncs=keep_puncs)

    @staticmethod
    def name():
        return "ja_jp_phonemizer"

    def _phonemize(self, text, separator):
        ph = japanese_text_to_phonemes(text)
        if separator:
            return separator.join(ph)
        return ph

    @staticmethod
    def supported_languages():
        return {"ja-jp": "Japanese (Japan)"}

    def version(self):
        return "0.0.1"

    @classmethod
    def is_available(cls):
        return True

    def is_supported_language(self, language):
        return language in self.supported_languages()
