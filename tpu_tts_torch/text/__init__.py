from tpu_tts_torch.text.characters import BaseCharacters, BaseVocabulary, Graphemes, IPAPhonemes
from tpu_tts_torch.text.tokenizer import TTSTokenizer

__all__ = ["BaseCharacters", "BaseVocabulary", "Graphemes", "IPAPhonemes", "TTSTokenizer"]
