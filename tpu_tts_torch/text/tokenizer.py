"""TTSTokenizer: clean → phonemize → encode → blank-intersperse → BOS/EOS.

Behavioral mirror of Coqui TTS `TTS/tts/utils/text/tokenizer.py`:10
(`text_to_ids`:87, `intersperse_blank_char`:126, `init_from_config`:149).
"""

from typing import Callable, List

from tpu_tts_torch.text import characters as _characters
from tpu_tts_torch.text import cleaners
from tpu_tts_torch.text.characters import Graphemes, IPAPhonemes
from tpu_tts_torch.text.phonemizers import DEF_LANG_TO_PHONEMIZER, get_phonemizer_by_name


def _characters_class(path: str):
    """The port's class for a stored `characters_class` path. A config.json
    written by the JAX package names its own module; the port maps it onto
    the class of the same name here instead of importing that package."""
    return getattr(_characters, path.rsplit(".", 1)[-1])


def _import_path(obj) -> str:
    return f"{type(obj).__module__}.{type(obj).__name__}"


class TTSTokenizer:
    """Convert input text to token IDs and back. OOV characters are discarded
    but recorded in `self.not_found_characters`."""

    def __init__(
        self,
        use_phonemes=False,
        text_cleaner: Callable = None,
        characters=None,
        phonemizer=None,
        add_blank: bool = False,
        use_eos_bos=False,
    ):
        self.text_cleaner = text_cleaner
        self.use_phonemes = use_phonemes
        self.add_blank = add_blank
        self.use_eos_bos = use_eos_bos
        self.characters = characters
        self.not_found_characters = []
        self.phonemizer = phonemizer

    @property
    def characters(self):
        return self._characters

    @characters.setter
    def characters(self, new_characters):
        self._characters = new_characters
        self.pad_id = self.characters.char_to_id(self.characters.pad) if self.characters and self.characters.pad else None
        self.blank_id = (
            self.characters.char_to_id(self.characters.blank) if self.characters and self.characters.blank else None
        )

    def encode(self, text: str) -> List[int]:
        token_ids = []
        for char in text:
            try:
                token_ids.append(self.characters.char_to_id(char))
            except KeyError:
                if char not in self.not_found_characters:
                    self.not_found_characters.append(char)
                    print(text)
                    print(f" [!] Character {repr(char)} not found in the vocabulary. Discarding it.")
        return token_ids

    def decode(self, token_ids: List[int]) -> str:
        return "".join(self.characters.id_to_char(t) for t in token_ids)

    def text_to_ids(self, text: str, language: str = None) -> List[int]:
        """1. clean  2. phonemize  3. encode  4. blank-intersperse  5. BOS/EOS."""
        if self.text_cleaner is not None:
            text = self.text_cleaner(text)
        if self.use_phonemes:
            text = self.phonemizer.phonemize(text, separator="", language=language)
        ids = self.encode(text)
        if self.add_blank:
            ids = self.intersperse_blank_char(ids, True)
        if self.use_eos_bos:
            ids = self.pad_with_bos_eos(ids)
        return ids

    def ids_to_text(self, id_sequence: List[int]) -> str:
        return self.decode(id_sequence)

    def pad_with_bos_eos(self, char_sequence: List[int]) -> List[int]:
        return [self.characters.bos_id] + list(char_sequence) + [self.characters.eos_id]

    def intersperse_blank_char(self, char_sequence: List[int], use_blank_char: bool = False) -> List[int]:
        char_to_use = self.blank_id if use_blank_char else self.characters.pad
        result = [char_to_use] * (len(char_sequence) * 2 + 1)
        result[1::2] = char_sequence
        return result

    def print_logs(self, level: int = 0):
        indent = "\t" * level
        print(f"{indent}| > add_blank: {self.add_blank}")
        print(f"{indent}| > use_eos_bos: {self.use_eos_bos}")
        print(f"{indent}| > use_phonemes: {self.use_phonemes}")
        if self.use_phonemes and self.phonemizer:
            print(f"{indent}| > phonemizer:")
            self.phonemizer.print_logs(level + 1)

    @staticmethod
    def init_from_config(config, characters=None):
        """Build tokenizer + (possibly updated) config from a model config."""
        text_cleaner = None
        if isinstance(config.text_cleaner, (str, list)):
            text_cleaner = getattr(cleaners, config.text_cleaner)

        if characters is None:
            if config.characters and getattr(config.characters, "characters_class", None):
                CharactersClass = _characters_class(config.characters.characters_class)
                characters, new_config = CharactersClass.init_from_config(config)
            elif config.use_phonemes:
                characters, new_config = IPAPhonemes.init_from_config(config)
            else:
                characters, new_config = Graphemes.init_from_config(config)
        else:
            characters, new_config = characters.init_from_config(config)

        new_config.characters.characters_class = _import_path(characters)

        phonemizer = None
        if config.use_phonemes:
            if "phonemizer" in config and config.phonemizer == "multi_phonemizer":
                from tpu_tts_torch.text.phonemizers.multi_phonemizer import MultiPhonemizer

                lang_to_phonemizer_name = {}
                for dataset in config.datasets:
                    if dataset.language != "":
                        lang_to_phonemizer_name[dataset.language] = dataset.phonemizer
                    else:
                        raise ValueError("Multi phonemizer requires language to be set for each dataset.")
                phonemizer = MultiPhonemizer(lang_to_phonemizer_name)
            else:
                phonemizer_kwargs = {"language": config.phoneme_language}
                if "phonemizer" in config and config.phonemizer:
                    phonemizer = get_phonemizer_by_name(config.phonemizer, **phonemizer_kwargs)
                else:
                    try:
                        phonemizer = get_phonemizer_by_name(
                            DEF_LANG_TO_PHONEMIZER[config.phoneme_language], **phonemizer_kwargs
                        )
                        new_config.phonemizer = phonemizer.name()
                    except KeyError as e:
                        raise ValueError(f"No phonemizer found for language {config.phoneme_language}.") from e

        return (
            TTSTokenizer(
                config.use_phonemes, text_cleaner, characters, phonemizer, config.add_blank,
                config.enable_eos_bos_chars,
            ),
            new_config,
        )
