"""Bangla phonemizer wrapper (copy of `tpu_tts/text/phonemizers/
bn_phonemizer.py`; Coqui TTS `TTS/tts/utils/text/phonemizers/bn_phonemizer.py`). Degrades gracefully when the optional bangla
normalization packages are missing."""

from tpu_tts_torch.text.bangla.phonemizer import bangla_text_to_phonemes
from tpu_tts_torch.text.phonemizers.base import BasePhonemizer

_DEF_BN_PUNCS = ",;:।! '"


class BN_Phonemizer(BasePhonemizer):
    """Bangla text → normalized phoneme text (ref bn_phonemizer.py:7)."""

    language = "bn"

    def __init__(self, punctuations=_DEF_BN_PUNCS, keep_puncs=False, **kwargs):
        super().__init__(self.language, punctuations=punctuations, keep_puncs=keep_puncs)

    @staticmethod
    def name():
        return "bn_phonemizer"

    @staticmethod
    def phonemize_bn(text: str, separator: str = "|") -> str:
        return bangla_text_to_phonemes(text)

    def _phonemize(self, text, separator):
        return self.phonemize_bn(text, separator)

    @staticmethod
    def supported_languages():
        return {"bn": "Bangla"}

    def version(self):
        return "0.0.2"

    @classmethod
    def is_available(cls):
        return True

    def is_supported_language(self, language):
        return language in self.supported_languages()
