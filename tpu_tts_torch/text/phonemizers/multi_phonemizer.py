"""Per-language phonemizer dispatch (ref multi_phonemizer.py:6)."""

from typing import Dict, List

from tpu_tts_torch.text.phonemizers import get_phonemizer_by_name


class MultiPhonemizer:
    lang_to_phonemizer: Dict = {}

    def __init__(self, lang_to_phonemizer_name: Dict = None) -> None:
        lang_to_phonemizer_name = lang_to_phonemizer_name or {}
        self.lang_to_phonemizer_name = lang_to_phonemizer_name
        self.lang_to_phonemizer = self.init_phonemizers(lang_to_phonemizer_name)

    @staticmethod
    def init_phonemizers(lang_to_phonemizer_name: Dict) -> Dict:
        return {
            language: get_phonemizer_by_name(name, language=language)
            for language, name in lang_to_phonemizer_name.items()
        }

    @staticmethod
    def name():
        return "multi-phonemizer"

    def phonemize(self, text, separator="|", language=""):
        if language == "":
            raise ValueError("Language must be set for multi-phonemizer to phonemize.")
        return self.lang_to_phonemizer[language].phonemize(text, separator)

    def supported_languages(self) -> List:
        return list(self.lang_to_phonemizer.keys())

    def print_logs(self, level: int = 0):
        indent = "\t" * level
        print(f"{indent}| > phoneme language: {self.supported_languages()}")
        print(f"{indent}| > phoneme backend: {self.name()}")
