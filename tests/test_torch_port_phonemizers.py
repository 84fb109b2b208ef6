"""The port's Japanese, Korean, Bangla, Mandarin and Belarusian front ends against `tpu_tts`.

- ja-jp (kana rules), ko-kr (jamo) and bn run natively on both sides: the
  same phoneme strings, and the same token ids from tokenizers built from
  equal configs (`use_phonemes`, the language's default phonemizer, a
  phoneme set that covers every symbol the sentences give, blanks);
- zh-cn and be are gated exactly where `tpu_tts` gates them: both registries
  report the same backends available, the Mandarin phonemizer raises when
  built without `pypinyin`, the Belarusian one when it phonemizes without
  `belarusian_fanetyka`;
- the registries map each language to the same phonemizer.
"""

import pytest

SENTENCES = {
    "ja-jp": ["こんにちは、せかい。", "ラーメンをたべます!", "キャットは123ひき?", "ちょっとまって、シャツ。"],
    "ko-kr": ["안녕하세요, 세계!", "IT 1+1 하늘", "오늘은 날씨가 좋아요.", "CEO는 100% 확신해요?"],
    "bn": ["আমি বাংলায় গান গাই।", "তুমি কেমন আছ? ভালো!", "এটা ১২৩ টাকা, ঠিক আছে।"],
}
PUNCTUATIONS = "!'(),-.:;? 、。।%+"


def _configs(lang, phonemes):
    from tpu_tts.configs.vits_config import VitsConfig as JaxConfig
    from tpu_tts.text.characters import CharactersConfig as JaxCharacters
    from tpu_tts_torch.configs.vits_config import VitsConfig
    from tpu_tts_torch.text.characters import CharactersConfig

    chars = dict(characters_class="IPAPhonemes", pad="<PAD>", eos="<EOS>", bos="<BOS>", blank="<BLNK>",
                 phonemes=phonemes, punctuations=PUNCTUATIONS)
    kw = dict(use_phonemes=True, phoneme_language=lang, text_cleaner="multilingual_cleaners", add_blank=True)
    jax_chars = JaxCharacters(**{**chars, "characters_class": "tpu_tts.text.characters.IPAPhonemes"})
    return JaxConfig(characters=jax_chars, **kw), VitsConfig(characters=CharactersConfig(**chars), **kw)


@pytest.mark.parametrize("lang", sorted(SENTENCES))
def test_native_front_end_ids_match_jax(lang):
    from tpu_tts.text import cleaners as jax_cleaners
    from tpu_tts.text.phonemizers import DEF_LANG_TO_PHONEMIZER as JAX_DEF
    from tpu_tts.text.phonemizers import get_phonemizer_by_name as jax_get
    from tpu_tts.text.tokenizer import TTSTokenizer as JaxTokenizer
    from tpu_tts_torch.text import cleaners
    from tpu_tts_torch.text.phonemizers import DEF_LANG_TO_PHONEMIZER, get_phonemizer_by_name
    from tpu_tts_torch.text.tokenizer import TTSTokenizer

    name = DEF_LANG_TO_PHONEMIZER[lang]
    assert name == JAX_DEF[lang] == {"ja-jp": "ja_jp_phonemizer", "ko-kr": "ko_kr_phonemizer", "bn": "bn_phonemizer"}[lang]
    ph, jph = get_phonemizer_by_name(name, language=lang), jax_get(name, language=lang)
    phonemes = []
    for s in SENTENCES[lang]:
        text = cleaners.multilingual_cleaners(s)
        assert text == jax_cleaners.multilingual_cleaners(s)
        out = ph.phonemize(text, separator="")
        assert out == jph.phonemize(text, separator="") and out.strip()
        phonemes.append(out)
    symbols = "".join(sorted(set("".join(phonemes)) - set(PUNCTUATIONS)))

    jcfg, cfg = _configs(lang, symbols)
    tok, _ = TTSTokenizer.init_from_config(cfg)
    jtok, _ = JaxTokenizer.init_from_config(jcfg)
    assert tok.phonemizer.name() == jtok.phonemizer.name() == name
    for s in SENTENCES[lang]:
        ids = tok.text_to_ids(s)
        assert ids == jtok.text_to_ids(s)
        assert len(ids) > 2 * len(s.split())
    assert tok.not_found_characters == jtok.not_found_characters == []


def test_zh_and_be_gated_as_in_jax():
    from tpu_tts.text.phonemizers import PHONEMIZERS as JAX_PHONEMIZERS
    from tpu_tts.text.phonemizers import get_phonemizer_by_name as jax_get
    from tpu_tts_torch.text.phonemizers import PHONEMIZERS, get_phonemizer_by_name

    assert {k: v.is_available() for k, v in PHONEMIZERS.items()} == {
        k: v.is_available() for k, v in JAX_PHONEMIZERS.items()}
    try:
        import pypinyin  # noqa: F401
    except ImportError:
        for get in (get_phonemizer_by_name, jax_get):
            with pytest.raises(RuntimeError, match="pypinyin"):
                get("zh_cn_phonemizer", language="zh-cn")
    else:
        assert get_phonemizer_by_name("zh_cn_phonemizer").phonemize("你好", separator="|") == \
            jax_get("zh_cn_phonemizer").phonemize("你好", separator="|")
    try:
        import belarusian_fanetyka  # noqa: F401
    except ImportError:
        for get in (get_phonemizer_by_name, jax_get):
            be = get("be_phonemizer", language="be")  # built, as in JAX; phonemizing raises
            with pytest.raises(RuntimeError, match="belarusian"):
                be.phonemize("Прывітанне.", separator="")
