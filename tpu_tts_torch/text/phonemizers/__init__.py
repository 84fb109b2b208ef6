"""Phonemizer registry and the default phonemizer of each language.

Counterpart of `tpu_tts/text/phonemizers/__init__.py` (Coqui TTS
`TTS/tts/utils/text/phonemizers/__init__.py`) with its built-in `en_rules`
English G2P. ESpeak and Gruut gate themselves: they raise at construction
where the espeak binary or the `gruut` package is missing. As in JAX, the
Japanese (kana rules; MeCab for kanji when installed), Korean (jamo; g2pkk
when installed) and Bangla phonemizers run natively; the Mandarin one raises
at construction without `pypinyin`, and the Belarusian one raises when it
phonemizes without `belarusian_fanetyka`. A backend whose module fails to
import is registered as a placeholder that raises when built.
"""

from typing import Dict

from tpu_tts_torch.text.phonemizers.base import BasePhonemizer
from tpu_tts_torch.text.phonemizers.en_rules import EnglishRules
from tpu_tts_torch.text.phonemizers.espeak_wrapper import ESpeak
from tpu_tts_torch.text.phonemizers.gruut_wrapper import GRUUT_LANGS, Gruut


def _gated(name: str, package: str):
    """A placeholder phonemizer class for a backend that cannot be imported."""

    class _Gated(BasePhonemizer):
        def __init__(self, *args, **kwargs):  # pylint: disable=super-init-not-called
            raise RuntimeError(f" [!] Phonemizer `{name}` requires the `{package}` package which is not installed.")

        @staticmethod
        def name():
            return name

        @classmethod
        def is_available(cls):
            return False

        @classmethod
        def version(cls):
            return "not installed"

        @staticmethod
        def supported_languages():
            return []

        def _phonemize(self, text, separator):
            raise NotImplementedError

    _Gated.__name__ = f"Gated_{name}"
    return _Gated


try:
    from tpu_tts_torch.text.phonemizers.zh_cn_phonemizer import ZH_CN_Phonemizer
except ImportError:
    ZH_CN_Phonemizer = _gated("zh_cn_phonemizer", "pypinyin")
try:
    from tpu_tts_torch.text.phonemizers.ko_kr_phonemizer import KO_KR_Phonemizer
except ImportError:
    KO_KR_Phonemizer = _gated("ko_kr_phonemizer", "g2pkk/jamo")
try:
    from tpu_tts_torch.text.phonemizers.ja_jp_phonemizer import JA_JP_Phonemizer
except ImportError:
    JA_JP_Phonemizer = _gated("ja_jp_phonemizer", "mecab/cutlet")
try:
    from tpu_tts_torch.text.phonemizers.bn_phonemizer import BN_Phonemizer
except ImportError:
    BN_Phonemizer = _gated("bn_phonemizer", "bangla")
try:
    from tpu_tts_torch.text.phonemizers.be_phonemizer import BEL_Phonemizer
except ImportError:
    BEL_Phonemizer = _gated("be_phonemizer", "belarusian text normalizer")


PHONEMIZERS = {
    b.name(): b
    for b in (ESpeak, Gruut, EnglishRules, KO_KR_Phonemizer, BN_Phonemizer, ZH_CN_Phonemizer, JA_JP_Phonemizer,
              BEL_Phonemizer)
}

ESPEAK_LANGS = list(ESpeak.supported_languages().keys())

# default phonemizer per language: gruut first, espeak overrides, then specials
DEF_LANG_TO_PHONEMIZER: Dict[str, str] = {}
DEF_LANG_TO_PHONEMIZER.update({lang: Gruut.name() for lang in GRUUT_LANGS if Gruut.is_available()})
DEF_LANG_TO_PHONEMIZER.update({lang: ESpeak.name() for lang in ESPEAK_LANGS})
for _lang in ("en", "en-us", "en-gb"):
    if _lang not in DEF_LANG_TO_PHONEMIZER:
        DEF_LANG_TO_PHONEMIZER[_lang] = EnglishRules.name()
if "en-us" in DEF_LANG_TO_PHONEMIZER:
    DEF_LANG_TO_PHONEMIZER["en"] = DEF_LANG_TO_PHONEMIZER["en-us"]
DEF_LANG_TO_PHONEMIZER["zh-cn"] = ZH_CN_Phonemizer.name()
DEF_LANG_TO_PHONEMIZER["ko-kr"] = KO_KR_Phonemizer.name()
DEF_LANG_TO_PHONEMIZER["ja-jp"] = JA_JP_Phonemizer.name()
DEF_LANG_TO_PHONEMIZER["bn"] = BN_Phonemizer.name()
DEF_LANG_TO_PHONEMIZER["be"] = BEL_Phonemizer.name()


def get_phonemizer_by_name(name: str, **kwargs) -> BasePhonemizer:
    """Build a phonemizer by its registry name."""
    if name == "espeak":
        return ESpeak(**kwargs)
    if name == "gruut":
        return Gruut(**kwargs)
    if name == "en_rules":
        return EnglishRules(**kwargs)
    if name in PHONEMIZERS:
        kwargs.pop("language", None)  # each of the others serves one language
        return PHONEMIZERS[name](**kwargs)
    raise ValueError(f"Phonemizer {name} not found")


__all__ = [
    "BasePhonemizer",
    "ESpeak",
    "Gruut",
    "EnglishRules",
    "PHONEMIZERS",
    "DEF_LANG_TO_PHONEMIZER",
    "get_phonemizer_by_name",
]
