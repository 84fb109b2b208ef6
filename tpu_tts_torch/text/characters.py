"""Character/phoneme vocabularies.

Mirrors the vocabulary semantics of
Coqui TTS `TTS/tts/utils/text/characters.py` (`BaseVocabulary`:38,
`BaseCharacters`:138, `IPAPhonemes`:348, `Graphemes`:426): the *ordering* of
the constructed vocab ([pad][eos][bos][blank] + sorted chars + punctuations)
defines embedding indices, so it is mirrored exactly for checkpoint parity.
The character-set constants are shared interop data (IPA alphabet), not code.
"""

from dataclasses import dataclass, replace
from typing import Dict, Optional

from tpu_tts_torch.config.base import Coqpit

# DEFAULT SET OF GRAPHEMES
_pad = "<PAD>"
_eos = "<EOS>"
_bos = "<BOS>"
_blank = "<BLNK>"
_characters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_punctuations = "!'(),-.:;? "

# DEFAULT SET OF IPA PHONEMES (same partition as reference characters.py:29-35)
_vowels = "iyɨʉɯuɪʏʊeøɘəɵɤoɛœɜɞʌɔæɐaɶɑɒᵻ"
_non_pulmonic_consonants = "ʘɓǀɗǃʄǂɠǁʛ"
_pulmonic_consonants = "pbtdʈɖcɟkɡqɢʔɴŋɲɳnɱmʙrʀⱱɾɽɸβfvθðszʃʒʂʐçʝxɣχʁħʕhɦɬɮʋɹɻjɰlɭʎʟ"
_suprasegmentals = "ˈˌːˑ"
_other_symbols = "ʍwɥʜʢʡɕʑɺɧʲ"
_diacrilics = "ɚ˞ɫ"
_phonemes = (
    _vowels + _non_pulmonic_consonants + _pulmonic_consonants + _suprasegmentals + _other_symbols + _diacrilics
)


def parse_symbols():
    return {
        "pad": _pad,
        "eos": _eos,
        "bos": _bos,
        "characters": _characters,
        "punctuations": _punctuations,
        "phonemes": _phonemes,
    }


@dataclass
class CharactersConfig(Coqpit):
    """Serialized character-set definition (ref tts/configs/shared_configs.py:96)."""

    characters_class: Optional[str] = None
    vocab_dict: Optional[Dict] = None
    pad: Optional[str] = None
    eos: Optional[str] = None
    bos: Optional[str] = None
    blank: Optional[str] = None
    characters: Optional[str] = None
    punctuations: Optional[str] = None
    phonemes: Optional[str] = None
    is_unique: bool = True
    is_sorted: bool = True


class BaseVocabulary:
    """Vocabulary driven purely by a dict (used by BPE-style models)."""

    def __init__(self, vocab: Dict, pad: str = None, blank: str = None, bos: str = None, eos: str = None):
        self.vocab = vocab
        self.pad = pad
        self.blank = blank
        self.bos = bos
        self.eos = eos

    @property
    def pad_id(self) -> int:
        return self.char_to_id(self.pad) if self.pad else len(self.vocab)

    @property
    def blank_id(self) -> int:
        return self.char_to_id(self.blank) if self.blank else len(self.vocab)

    @property
    def bos_id(self) -> int:
        return self.char_to_id(self.bos) if self.bos else len(self.vocab)

    @property
    def eos_id(self) -> int:
        return self.char_to_id(self.eos) if self.eos else len(self.vocab)

    @property
    def vocab(self):
        return self._vocab

    @vocab.setter
    def vocab(self, vocab):
        self._vocab = vocab
        if vocab is not None:
            self._char_to_id = {char: idx for idx, char in enumerate(self._vocab)}
            self._id_to_char = {idx: char for idx, char in enumerate(self._vocab)}

    @property
    def num_chars(self):
        return len(self._vocab)

    def char_to_id(self, char: str) -> int:
        try:
            return self._char_to_id[char]
        except KeyError as e:
            raise KeyError(f" [!] {repr(char)} is not in the vocabulary.") from e

    def id_to_char(self, idx: int) -> str:
        return self._id_to_char[idx]

    @staticmethod
    def init_from_config(config, **kwargs):
        if config.characters is not None and "vocab_dict" in config.characters and config.characters.vocab_dict:
            return (
                BaseVocabulary(
                    config.characters.vocab_dict,
                    config.characters.pad,
                    config.characters.blank,
                    config.characters.bos,
                    config.characters.eos,
                ),
                config,
            )
        return BaseVocabulary(vocab=kwargs.get("vocab")), config

    def to_config(self) -> CharactersConfig:
        return CharactersConfig(
            vocab_dict=self.vocab, pad=self.pad, eos=self.eos, bos=self.bos, blank=self.blank,
            is_unique=False, is_sorted=False,
        )


class BaseCharacters:
    """Character set with deterministic id assignment.

    Vocab layout (must match reference `_create_vocab`, characters.py:280):
    `[pad] [eos] [bos] [blank] + characters (opt. unique/sorted) + punctuations`.
    """

    def __init__(
        self,
        characters: str = None,
        punctuations: str = None,
        pad: str = None,
        eos: str = None,
        bos: str = None,
        blank: str = None,
        is_unique: bool = False,
        is_sorted: bool = True,
    ) -> None:
        self._characters = characters
        self._punctuations = punctuations
        self._pad = pad
        self._eos = eos
        self._bos = bos
        self._blank = blank
        self.is_unique = is_unique
        self.is_sorted = is_sorted
        self._create_vocab()

    # properties with vocab rebuild on set --------------------------------
    @property
    def pad_id(self) -> int:
        return self.char_to_id(self.pad) if self.pad else len(self.vocab)

    @property
    def blank_id(self) -> int:
        return self.char_to_id(self.blank) if self.blank else len(self.vocab)

    @property
    def eos_id(self) -> int:
        return self.char_to_id(self.eos) if self.eos else len(self.vocab)

    @property
    def bos_id(self) -> int:
        return self.char_to_id(self.bos) if self.bos else len(self.vocab)

    def _prop(name):  # noqa: N805 - tiny property factory
        def getter(self):
            return getattr(self, "_" + name)

        def setter(self, value):
            setattr(self, "_" + name, value)
            self._create_vocab()

        return property(getter, setter)

    characters = _prop("characters")
    punctuations = _prop("punctuations")
    pad = _prop("pad")
    eos = _prop("eos")
    bos = _prop("bos")
    blank = _prop("blank")
    del _prop

    @property
    def vocab(self):
        return self._vocab

    @vocab.setter
    def vocab(self, vocab):
        self._vocab = vocab
        self._char_to_id = {char: idx for idx, char in enumerate(self.vocab)}
        self._id_to_char = {idx: char for idx, char in enumerate(self.vocab)}

    @property
    def num_chars(self):
        return len(self._vocab)

    def _create_vocab(self):
        _vocab = self._characters
        if self.is_unique:
            _vocab = list(set(_vocab))
        if self.is_sorted:
            _vocab = sorted(_vocab)
        _vocab = list(_vocab)
        _vocab = [self._blank] + _vocab if self._blank is not None and len(self._blank) > 0 else _vocab
        _vocab = [self._bos] + _vocab if self._bos is not None and len(self._bos) > 0 else _vocab
        _vocab = [self._eos] + _vocab if self._eos is not None and len(self._eos) > 0 else _vocab
        _vocab = [self._pad] + _vocab if self._pad is not None and len(self._pad) > 0 else _vocab
        self.vocab = _vocab + list(self._punctuations)
        if self.is_unique:
            duplicates = {x for x in self.vocab if self.vocab.count(x) > 1}
            assert len(self.vocab) == len(self._char_to_id) == len(self._id_to_char), (
                f" [!] There are duplicate characters in the character set. {duplicates}"
            )

    def char_to_id(self, char: str) -> int:
        try:
            return self._char_to_id[char]
        except KeyError as e:
            raise KeyError(f" [!] {repr(char)} is not in the vocabulary.") from e

    def id_to_char(self, idx: int) -> str:
        return self._id_to_char[idx]

    def print_log(self, level: int = 0):
        indent = "\t" * level
        for k in ("characters", "punctuations", "pad", "eos", "bos", "blank"):
            print(f"{indent}| > {k}: {getattr(self, '_' + k)}")
        print(f"{indent}| > Num chars: {self.num_chars}")

    @staticmethod
    def init_from_config(config):
        if config.characters is not None:
            return BaseCharacters(**_charset_kwargs(config.characters)), config
        characters = BaseCharacters()
        new_config = replace(config, characters=characters.to_config())
        return characters, new_config

    def to_config(self) -> CharactersConfig:
        return CharactersConfig(
            characters=self._characters,
            punctuations=self._punctuations,
            pad=self._pad,
            eos=self._eos,
            bos=self._bos,
            blank=self._blank,
            is_unique=self.is_unique,
            is_sorted=self.is_sorted,
        )


def _charset_kwargs(ch_cfg) -> Dict:
    """Extract BaseCharacters kwargs from a CharactersConfig-ish object."""
    get = ch_cfg.get if hasattr(ch_cfg, "get") else lambda k, d=None: getattr(ch_cfg, k, d)
    return dict(
        characters=get("characters"),
        punctuations=get("punctuations"),
        pad=get("pad"),
        eos=get("eos"),
        bos=get("bos"),
        blank=get("blank"),
        is_unique=get("is_unique", False),
        is_sorted=get("is_sorted", True),
    )


class IPAPhonemes(BaseCharacters):
    """Default IPA phoneme vocabulary (ref characters.py:348)."""

    def __init__(
        self,
        characters: str = _phonemes,
        punctuations: str = _punctuations,
        pad: str = _pad,
        eos: str = _eos,
        bos: str = _bos,
        blank: str = _blank,
        is_unique: bool = False,
        is_sorted: bool = True,
    ) -> None:
        super().__init__(characters, punctuations, pad, eos, bos, blank, is_unique, is_sorted)

    @staticmethod
    def init_from_config(config):
        if config.characters is not None:
            ch = config.characters
            if "phonemes" in ch and ch["phonemes"]:
                ch["characters"] = ch["phonemes"]
            return IPAPhonemes(**_charset_kwargs(ch)), config
        characters = IPAPhonemes()
        new_config = replace(config, characters=characters.to_config())
        return characters, new_config


class Graphemes(BaseCharacters):
    """Default grapheme vocabulary (ref characters.py:426)."""

    def __init__(
        self,
        characters: str = _characters,
        punctuations: str = _punctuations,
        pad: str = _pad,
        eos: str = _eos,
        bos: str = _bos,
        blank: str = _blank,
        is_unique: bool = False,
        is_sorted: bool = True,
    ) -> None:
        super().__init__(characters, punctuations, pad, eos, bos, blank, is_unique, is_sorted)

    @staticmethod
    def init_from_config(config):
        if config.characters is not None:
            return Graphemes(**_charset_kwargs(config.characters)), config
        characters = Graphemes()
        new_config = replace(config, characters=characters.to_config())
        return characters, new_config
