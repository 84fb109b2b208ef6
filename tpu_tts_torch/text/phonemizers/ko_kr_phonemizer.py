"""Korean phonemizer wrapper (copy of `tpu_tts/text/phonemizers/
ko_kr_phonemizer.py`; Coqui TTS `TTS/tts/utils/text/phonemizers/ko_kr_phonemizer.py`). Jamo decomposition is native; g2pkk
pronunciation rules apply automatically when the package is installed."""

from tpu_tts_torch.text.korean.phonemizer import korean_text_to_phonemes
from tpu_tts_torch.text.phonemizers.base import BasePhonemizer
from tpu_tts_torch.text.punctuation import Punctuation

_DEF_KO_PUNCS = "、.,[]()?!〽~『』「」【】"


class KO_KR_Phonemizer(BasePhonemizer):
    """Korean text → jamo phonemes (ref ko_kr_phonemizer.py:7)."""

    language = "ko-kr"

    def __init__(self, punctuations=_DEF_KO_PUNCS, keep_puncs=True, **kwargs):
        super().__init__(self.language, punctuations=punctuations, keep_puncs=keep_puncs)

    @staticmethod
    def name():
        return "ko_kr_phonemizer"

    def phonemize_ko_kr(self, text: str, separator: str = "", character: str = "hangeul") -> str:
        ph = korean_text_to_phonemes(text, character=character)
        if separator:
            return separator.join(ph)
        return ph

    def _phonemize(self, text, separator):
        return self.phonemize_ko_kr(text, separator)

    @staticmethod
    def supported_languages():
        return {"ko-kr": "hangeul(korean)"}

    def version(self):
        return "0.0.2"

    @classmethod
    def is_available(cls):
        return True

    def is_supported_language(self, language):
        return language in self.supported_languages()
