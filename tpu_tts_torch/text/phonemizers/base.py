"""Abstract phonemizer with punctuation-preserving pipeline.

Counterpart of `tpu_tts/text/phonemizers/base.py`, with the contract of Coqui TTS
`TTS/tts/utils/text/phonemizers/base.py`:7 —
`phonemize(text, separator, language)` strips punctuation, phonemizes each
chunk, restores punctuation.
"""

import abc
from typing import List, Tuple

from tpu_tts_torch.text.punctuation import Punctuation


class BasePhonemizer(abc.ABC):
    def __init__(self, language, punctuations=Punctuation.default_puncs(), keep_puncs=False):
        self._language = self._init_language(language)
        self._keep_puncs = keep_puncs
        self._punctuator = Punctuation(punctuations)

    def _init_language(self, language):
        if not self.is_supported_language(language):
            raise RuntimeError(f'language "{language}" is not supported by the {self.name()} backend')
        return language

    @property
    def language(self):
        return self._language

    @staticmethod
    @abc.abstractmethod
    def name():
        ...

    @classmethod
    @abc.abstractmethod
    def is_available(cls) -> bool:
        ...

    @classmethod
    @abc.abstractmethod
    def version(cls) -> str:
        ...

    @staticmethod
    @abc.abstractmethod
    def supported_languages() -> List[str]:
        ...

    def is_supported_language(self, language: str) -> bool:
        return language in self.supported_languages()

    @abc.abstractmethod
    def _phonemize(self, text: str, separator: str) -> str:
        ...

    def _phonemize_preprocess(self, text: str) -> Tuple[List[str], List]:
        text = text.strip()
        if self._keep_puncs:
            return self._punctuator.strip_to_restore(text)
        return [self._punctuator.strip(text)], []

    def _phonemize_postprocess(self, phonemized: List[str], punctuations: List) -> str:
        if self._keep_puncs:
            return self._punctuator.restore(phonemized, punctuations)[0]
        return phonemized[0]

    def phonemize(self, text: str, separator: str = "|", language: str = None) -> str:
        text, punctuations = self._phonemize_preprocess(text)
        phonemized = [self._phonemize(t, separator) for t in text]
        return self._phonemize_postprocess(phonemized, punctuations)

    def print_logs(self, level: int = 0):
        indent = "\t" * level
        print(f"{indent}| > phoneme language: {self.language}")
        print(f"{indent}| > phoneme backend: {self.name()}")
