"""Mandarin phonemizer wrapper (copy of `tpu_tts/text/phonemizers/
zh_cn_phonemizer.py`; Coqui TTS `TTS/tts/utils/text/phonemizers/zh_cn_phonemizer.py`). Requires pypinyin for hanzi → pinyin; the
pinyin → IPA stage is native (`text/chinese_mandarin/pinyin_ipa.py`)."""

from tpu_tts_torch.text.chinese_mandarin.phonemizer import chinese_text_to_phonemes
from tpu_tts_torch.text.phonemizers.base import BasePhonemizer
from tpu_tts_torch.text.punctuation import Punctuation

_DEF_ZH_PUNCS = "、.,[]()?!〽~『』「」【】"


class ZH_CN_Phonemizer(BasePhonemizer):
    """hanzi → |-separated IPA+tone phonemes (ref zh_cn_phonemizer.py:9)."""

    language = "zh-cn"

    def __init__(self, punctuations=_DEF_ZH_PUNCS, keep_puncs=False, **kwargs):
        if not self.is_available():
            raise RuntimeError(" [!] ZH_CN_Phonemizer requires the `pypinyin` package.")
        super().__init__(self.language, punctuations=punctuations, keep_puncs=keep_puncs)

    @staticmethod
    def name():
        return "zh_cn_phonemizer"

    @staticmethod
    def phonemize_zh_cn(text: str, separator: str = "|") -> str:
        return chinese_text_to_phonemes(text, separator)

    def _phonemize(self, text, separator):
        return self.phonemize_zh_cn(text, separator)

    @staticmethod
    def supported_languages():
        return {"zh-cn": "Chinese (China)"}

    def version(self):
        return "0.0.1"

    @classmethod
    def is_available(cls):
        try:
            import pypinyin  # noqa: F401

            return True
        except ImportError:
            return False

    def is_supported_language(self, language):
        return language in self.supported_languages()
