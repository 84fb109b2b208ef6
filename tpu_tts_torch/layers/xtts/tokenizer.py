"""XTTS BPE tokenizer (HF `tokenizers`) and its multilingual text cleaning.

Counterpart of `tpu_tts/layers/xtts/tokenizer.py` (`VoiceBpeTokenizer`:39):
the BPE vocab of the model directory, language-tagged encoding
(`[lang]text`, spaces as `[SPACE]`), a per-language character limit. The
`tokenizers` package is imported only when a vocab is given. No XTTS vocab
ships with the repository, so without one `encode` raises and the callers
pass token ids.
"""

from typing import List, Optional

from tpu_tts_torch.layers.xtts.text_norm import (
    expand_abbreviations_multilingual,
    expand_numbers_multilingual,
    expand_symbols_multilingual,
)
from tpu_tts_torch.text.cleaners import collapse_whitespace, lowercase
from tpu_tts_torch.text.sentence_split import split_sentences

# per-language input character limits (Coqui's `char_limits`)
CHAR_LIMITS = {
    "en": 250, "de": 253, "fr": 273, "es": 239, "it": 213, "pt": 203,
    "pl": 224, "zh": 82, "ar": 166, "cs": 186, "ru": 182, "nl": 251,
    "tr": 226, "ja": 71, "hu": 224, "ko": 95,
}


def multilingual_cleaners(text: str, lang: str) -> str:
    text = text.replace('"', "")
    if lang == "tr":
        text = text.replace("İ", "i").replace("Ö", "ö").replace("Ü", "ü")
    text = lowercase(text)
    text = expand_numbers_multilingual(text, lang)
    text = expand_abbreviations_multilingual(text, lang)
    text = expand_symbols_multilingual(text, lang)
    return collapse_whitespace(text)


class VoiceBpeTokenizer:
    def __init__(self, vocab_file: Optional[str] = None):
        self.tokenizer = None
        if vocab_file is not None:
            from tokenizers import Tokenizer

            self.tokenizer = Tokenizer.from_file(vocab_file)

    @property
    def is_loaded(self) -> bool:
        return self.tokenizer is not None

    def check_input_length(self, txt: str, lang: str):
        lang = lang.split("-")[0]
        limit = CHAR_LIMITS.get(lang, 250)
        if len(txt) > limit:
            print(f"[!] Warning: The text length exceeds the character limit of {limit} for language '{lang}', "
                  "this might cause truncated audio.")

    def preprocess_text(self, txt: str, lang: str) -> str:
        return multilingual_cleaners(txt, lang.split("-")[0])

    def encode(self, txt: str, lang: str) -> List[int]:
        if self.tokenizer is None:
            raise RuntimeError(" [!] XTTS BPE vocab not loaded: give the model a `vocab.json` (`model_dir` or "
                               "`model_args.tokenizer_file`), or pass token ids")
        lang = lang.split("-")[0]
        self.check_input_length(txt, lang)
        txt = self.preprocess_text(txt, lang)
        lang_tag = "zh-cn" if lang == "zh" else lang
        txt = f"[{lang_tag}]{txt}".replace(" ", "[SPACE]")
        return self.tokenizer.encode(txt).ids

    def decode(self, seq: List[int]) -> str:
        if self.tokenizer is None:
            raise RuntimeError(" [!] XTTS BPE vocab not loaded.")
        txt = self.tokenizer.decode(seq, skip_special_tokens=False)
        return txt.replace("[SPACE]", " ").replace("[STOP]", "").replace("[UNK]", "")

    def split_into_sentences(self, text: str) -> List[str]:
        return split_sentences(text)
