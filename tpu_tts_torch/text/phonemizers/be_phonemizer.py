"""Belarusian phonemizer wrapper (copy of `tpu_tts/text/phonemizers/
be_phonemizer.py`; Coqui TTS `TTS/tts/utils/text/phonemizers/belarusian_phonemizer.py`). Requires the external fanetyka
toolchain; gated at construction."""

from tpu_tts_torch.text.belarusian.phonemizer import belarusian_text_to_phonemes
from tpu_tts_torch.text.phonemizers.base import BasePhonemizer

_DEF_BE_PUNCS = ",!."


class BEL_Phonemizer(BasePhonemizer):
    """Belarusian text → phonemes (ref belarusian_phonemizer.py:7)."""

    language = "be"

    def __init__(self, punctuations=_DEF_BE_PUNCS, keep_puncs=True, **kwargs):
        super().__init__(self.language, punctuations=punctuations, keep_puncs=keep_puncs)

    @staticmethod
    def name():
        return "be_phonemizer"

    @staticmethod
    def phonemize_be(text: str, separator: str = "|") -> str:
        return belarusian_text_to_phonemes(text)

    def _phonemize(self, text, separator):
        return self.phonemize_be(text, separator)

    @staticmethod
    def supported_languages():
        return {"be": "Belarusian"}

    def version(self):
        return "0.0.1"

    @classmethod
    def is_available(cls):
        try:
            import belarusian_fanetyka  # noqa: F401

            return True
        except ImportError:
            return False

    def is_supported_language(self, language):
        return language in self.supported_languages()
