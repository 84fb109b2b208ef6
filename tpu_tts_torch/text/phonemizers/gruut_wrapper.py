"""Gruut phonemizer (gated: the `gruut` package is optional).

Counterpart of `tpu_tts/text/phonemizers/gruut_wrapper.py` (Coqui TTS
`TTS/tts/utils/text/phonemizers/gruut_wrapper.py`).
"""

import importlib
from typing import List

from tpu_tts_torch.text.phonemizers.base import BasePhonemizer
from tpu_tts_torch.text.punctuation import Punctuation

try:
    import gruut
    from gruut_ipa import IPA  # noqa: F401

    _GRUUT_OK = True
except ImportError:
    gruut = None
    _GRUUT_OK = False

GRUUT_LANGS = ["ar", "cs", "de", "en", "en-us", "en-gb", "es", "fa", "fr", "it", "lb", "nl", "pt", "ru", "sv", "sw"]


class Gruut(BasePhonemizer):
    def __init__(self, language: str, punctuations=Punctuation.default_puncs(), keep_puncs=False, use_espeak_phonemes=False, keep_stress=False):
        if not _GRUUT_OK:
            raise RuntimeError(" [!] `gruut` is not installed. pip install gruut, or use espeak/en_rules.")
        super().__init__(language, punctuations=punctuations, keep_puncs=keep_puncs)
        self.use_espeak_phonemes = use_espeak_phonemes
        self.keep_stress = keep_stress

    @staticmethod
    def name():
        return "gruut"

    def _phonemize(self, text: str, separator: str) -> str:
        ph_list = []
        for sentence in gruut.sentences(text, lang=self.language, espeak=self.use_espeak_phonemes):
            for word in sentence:
                if word.is_break:
                    if ph_list:
                        ph_list[-1].append(word.text)
                elif word.phonemes:
                    phonemes = [p.replace("ˈ", "").replace("ˌ", "") if not self.keep_stress else p for p in word.phonemes]
                    ph_list.append(phonemes)
        return " ".join(separator.join(w) if separator else "".join(w) for w in ph_list)

    @staticmethod
    def supported_languages() -> List[str]:
        if not _GRUUT_OK:
            return []
        return [l for l in GRUUT_LANGS if gruut.is_language_supported(l)]

    @classmethod
    def version(cls) -> str:
        return getattr(gruut, "__version__", "unknown") if _GRUUT_OK else "not installed"

    @classmethod
    def is_available(cls) -> bool:
        if not _GRUUT_OK:
            return False
        # only trust a real module: a test stub answers every attribute with
        # a mock but has no string __version__
        if not isinstance(getattr(gruut, "__version__", None), str):
            return False
        try:
            return importlib.util.find_spec("gruut") is not None
        except (ImportError, ValueError):  # e.g. stubbed module without __spec__
            return False
