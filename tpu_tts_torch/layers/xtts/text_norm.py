"""XTTS multilingual text normalization: abbreviations, symbols, numbers.

A copy of `tpu_tts/layers/xtts/text_norm.py`, the behavioural mirror of
Coqui TTS `TTS/tts/layers/xtts/tokenizer.py`
(`expand_abbreviations_multilingual`:~232, `expand_symbols_multilingual`:431,
`expand_numbers_multilingual`:522, zh via `zh_num2words.py`). The tables are
the reference's public normalization data; the number expansion is built on
our own converters: English through `tpu_tts_torch.text.english.number_norm`,
Chinese through `tpu_tts_torch.text.chinese_mandarin.numbers`, and the remaining
languages through the optional `num2words` package (graceful no-op when it is
not installed — digits then pass through the BPE vocabulary unexpanded).
"""

import re

from tpu_tts_torch.text.chinese_mandarin.numbers import replace_numbers_to_characters_in_text
from tpu_tts_torch.text.english.number_norm import normalize_numbers as _en_normalize_numbers
from tpu_tts_torch.text.english.number_norm import number_to_words as _en_number_to_words

# --------------------------------------------------------------- abbreviations
# (abbrev, expansion); matched as `\bABBREV\.` case-insensitively, except the
# Russian hyphenated forms which carry no trailing dot.
_ABBREV_TABLES = {
    "en": [("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
           ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
           ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
           ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
           ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort")],
    "es": [("sra", "señora"), ("sr", "señor"), ("dr", "doctor"), ("dra", "doctora"),
           ("st", "santo"), ("co", "compañía"), ("jr", "junior"), ("ltd", "limitada")],
    "fr": [("mme", "madame"), ("mr", "monsieur"), ("dr", "docteur"), ("st", "saint"),
           ("co", "compagnie"), ("jr", "junior"), ("ltd", "limitée")],
    "de": [("fr", "frau"), ("dr", "doktor"), ("st", "sankt"), ("co", "firma"),
           ("jr", "junior")],
    "pt": [("sra", "senhora"), ("sr", "senhor"), ("dr", "doutor"), ("dra", "doutora"),
           ("st", "santo"), ("co", "companhia"), ("jr", "júnior"), ("ltd", "limitada")],
    "it": [("sig", "signore"), ("dr", "dottore"), ("st", "santo"), ("co", "compagnia"),
           ("jr", "junior"), ("ltd", "limitata")],
    "pl": [("p", "pani"), ("m", "pan"), ("dr", "doktor"), ("sw", "święty"),
           ("jr", "junior")],
    "ar": [],
    "zh": [],
    "cs": [("dr", "doktor"), ("ing", "inženýr"), ("p", "pan")],
    "ru": [("г-жа", "госпожа"), ("г-н", "господин"), ("д-р", "доктор")],
    "nl": [("dhr", "de heer"), ("mevr", "mevrouw"), ("dr", "dokter"), ("jhr", "jonkheer")],
    "tr": [("b", "bay"), ("byk", "büyük"), ("dr", "doktor")],
    "hu": [("dr", "doktor"), ("b", "bácsi"), ("nőv", "nővér")],
    "ko": [],
}

_abbreviations = {
    lang: [
        (re.compile(("\\b%s\\b" if lang == "ru" else "\\b%s\\.") % abbrev, re.IGNORECASE), expansion)
        for abbrev, expansion in pairs
    ]
    for lang, pairs in _ABBREV_TABLES.items()
}


def expand_abbreviations_multilingual(text: str, lang: str = "en") -> str:
    for regex, replacement in _abbreviations.get(lang, []):
        text = re.sub(regex, replacement, text)
    return text


# -------------------------------------------------------------------- symbols
_SYMBOL_TABLES = {
    "en": [("&", "and"), ("@", "at"), ("%", "percent"), ("#", "hash"),
           ("$", "dollar"), ("£", "pound"), ("°", "degree")],
    "es": [("&", "y"), ("@", "arroba"), ("%", "por ciento"), ("#", "numeral"),
           ("$", "dolar"), ("£", "libra"), ("°", "grados")],
    "fr": [("&", "et"), ("@", "arobase"), ("%", "pour cent"), ("#", "dièse"),
           ("$", "dollar"), ("£", "livre"), ("°", "degrés")],
    "de": [("&", "und"), ("@", "at"), ("%", "prozent"), ("#", "raute"),
           ("$", "dollar"), ("£", "pfund"), ("°", "grad")],
    "pt": [("&", "e"), ("@", "arroba"), ("%", "por cento"), ("#", "cardinal"),
           ("$", "dólar"), ("£", "libra"), ("°", "graus")],
    "it": [("&", "e"), ("@", "chiocciola"), ("%", "per cento"), ("#", "cancelletto"),
           ("$", "dollaro"), ("£", "sterlina"), ("°", "gradi")],
    "pl": [("&", "i"), ("@", "małpa"), ("%", "procent"), ("#", "krzyżyk"),
           ("$", "dolar"), ("£", "funt"), ("°", "stopnie")],
    "ar": [("&", "و"), ("@", "على"), ("%", "في المئة"), ("#", "رقم"),
           ("$", "دولار"), ("£", "جنيه"), ("°", "درجة")],
    "zh": [("&", "和"), ("@", "在"), ("%", "百分之"), ("#", "号"),
           ("$", "美元"), ("£", "英镑"), ("°", "度")],
    "cs": [("&", "a"), ("@", "na"), ("%", "procento"), ("#", "křížek"),
           ("$", "dolar"), ("£", "libra"), ("°", "stupně")],
    "ru": [("&", "и"), ("@", "собака"), ("%", "процентов"), ("#", "номер"),
           ("$", "доллар"), ("£", "фунт"), ("°", "градус")],
    "nl": [("&", "en"), ("@", "bij"), ("%", "procent"), ("#", "hekje"),
           ("$", "dollar"), ("£", "pond"), ("°", "graden")],
    "tr": [("&", "ve"), ("@", "at"), ("%", "yüzde"), ("#", "diyez"),
           ("$", "dolar"), ("£", "sterlin"), ("°", "derece")],
    "hu": [("&", "és"), ("@", "kukac"), ("%", "százalék"), ("#", "kettőskereszt"),
           ("$", "dollár"), ("£", "font"), ("°", "fok")],
    "ko": [("&", "그리고"), ("@", "에"), ("%", "퍼센트"), ("#", "번호"),
           ("$", "달러"), ("£", "파운드"), ("°", "도")],
}

_symbols_multilingual = {
    # Korean attaches particles directly to the symbol word (14 퍼센트입니다),
    # so no trailing space there
    lang: [
        (re.compile(re.escape(sym), re.IGNORECASE), f" {word}" if lang == "ko" else f" {word} ")
        for sym, word in pairs
    ]
    for lang, pairs in _SYMBOL_TABLES.items()
}


def expand_symbols_multilingual(text: str, lang: str = "en") -> str:
    for regex, replacement in _symbols_multilingual.get(lang, []):
        text = re.sub(regex, replacement, text)
        text = text.replace("  ", " ")
    return text.strip()


# -------------------------------------------------------------------- numbers
_ordinal_re = {
    "en": re.compile(r"([0-9]+)(st|nd|rd|th)"),
    "es": re.compile(r"([0-9]+)(º|ª|er|o|a|os|as)"),
    "fr": re.compile(r"([0-9]+)(º|ª|er|re|e|ème)"),
    "de": re.compile(r"([0-9]+)(st|nd|rd|th|º|ª|\.(?=\s|$))"),
    "pt": re.compile(r"([0-9]+)(º|ª|o|a|os|as)"),
    "it": re.compile(r"([0-9]+)(º|°|ª|o|a|i|e)"),
    "pl": re.compile(r"([0-9]+)(º|ª|st|nd|rd|th)"),
    "ar": re.compile(r"([0-9]+)(ون|ين|ث|ر|ى)"),
    "cs": re.compile(r"([0-9]+)\.(?=\s|$)"),
    "ru": re.compile(r"([0-9]+)(-й|-я|-е|-ое|-ье|-го)"),
    "nl": re.compile(r"([0-9]+)(de|ste|e)"),
    "tr": re.compile(r"([0-9]+)(\.|inci|nci|uncu|üncü|\.)"),
    "hu": re.compile(r"([0-9]+)(\.|adik|edik|odik|edik|ödik|ödike|ik)"),
    "ko": re.compile(r"([0-9]+)(번째|번|차|째)"),
}
_number_re = re.compile(r"[0-9]+")
_currency_re = {
    "USD": re.compile(r"((\$[0-9\.\,]*[0-9]+)|([0-9\.\,]*[0-9]+\$))"),
    "GBP": re.compile(r"((£[0-9\.\,]*[0-9]+)|([0-9\.\,]*[0-9]+£))"),
    "EUR": re.compile(r"(([0-9\.\,]*[0-9]+€)|((€[0-9\.\,]*[0-9]+)))"),
}
_comma_number_re = re.compile(r"\b\d{1,3}(,\d{3})*(\.\d+)?\b")
_dot_number_re = re.compile(r"\b\d{1,3}(.\d{3})*(\,\d+)?\b")
_decimal_number_re = re.compile(r"([0-9]+[.,][0-9]+)")

# "and"-equivalents joining whole and fractional currency parts
_AND_EQUIVALENTS = {
    "en": ", ", "es": " con ", "fr": " et ", "de": " und ", "pt": " e ",
    "it": " e ", "pl": ", ", "cs": ", ", "ru": ", ", "nl": ", ", "ar": ", ",
    "tr": ", ", "hu": ", ", "ko": ", ",
}

_EN_CURRENCY_WORDS = {"EUR": ("euro", "euro", "cent", "cents"),
                      "GBP": ("pound", "pounds", "penny", "pence")}


def _num2words(value, *, lang="en", to="cardinal", ordinal=False, currency=None, **kwargs):
    """The real num2words when installed (exact reference behavior),
    otherwise the from-scratch converter in num_words.py — so number
    expansion works offline for every supported language."""
    if _has_num2words():
        from num2words import num2words  # optional dependency

        return num2words(value, lang=lang, to=to, ordinal=ordinal,
                         **({"currency": currency} if currency else {}), **kwargs)
    from tpu_tts_torch.layers.xtts import num_words

    lang = "cs" if lang == "cz" else lang.split("_")[0]
    if to == "currency":
        return num_words.currency_words(float(value), currency, lang)
    if ordinal:
        return num_words.ordinal(int(value), lang)
    fval = float(value)
    if not fval.is_integer():
        s = f"{fval}"
        int_part, _, frac = s.partition(".")
        return num_words.decimal_words(int(int_part), frac, lang)
    return num_words.cardinal(int(fval), lang)


def _has_num2words() -> bool:
    try:
        from num2words import num2words

        # only trust a real string result — a stubbed/broken module must not
        # pass the gate (same policy as the bangla phonemizer)
        return isinstance(num2words(1, lang="en"), str)
    except Exception:
        return False


def _number_words_available(lang: str) -> bool:
    from tpu_tts_torch.layers.xtts import num_words

    return _has_num2words() or ("cs" if lang == "cz" else lang) in num_words.SUPPORTED


def _expand_en_currency(m: re.Match, currency: str) -> str:
    amount = re.sub(r"[^\d.]", "", m.group(0))
    whole, _, frac = amount.partition(".")
    whole_n = int(whole or 0)
    cents = int((frac + "00")[:2]) if frac else 0
    one, many, cent_one, cent_many = _EN_CURRENCY_WORDS[currency]
    out = _en_number_to_words(whole_n) + " " + (one if whole_n == 1 else many)
    if cents:
        out += ", " + _en_number_to_words(cents) + " " + (cent_one if cents == 1 else cent_many)
    return out


def _expand_currency(m: re.Match, lang: str, currency: str) -> str:
    amount = float(re.sub(r"[^\d.]", "", m.group(0).replace(",", ".")))
    full_amount = _num2words(amount, to="currency", currency=currency,
                             lang=lang if lang != "cs" else "cz")
    if amount.is_integer():
        last_and = full_amount.rfind(_AND_EQUIVALENTS[lang])
        if last_and != -1:
            full_amount = full_amount[:last_and]
    return full_amount


def _remove_commas(m: re.Match) -> str:
    return m.group(0).replace(",", "")


def _remove_dots(m: re.Match) -> str:
    return m.group(0).replace(".", "")


def expand_numbers_multilingual(text: str, lang: str = "en") -> str:
    lang = lang.split("-")[0]
    if lang == "zh":
        return replace_numbers_to_characters_in_text(text)
    if lang == "en":
        text = re.sub(_comma_number_re, _remove_commas, text)
        text = re.sub(_currency_re["GBP"], lambda m: _expand_en_currency(m, "GBP"), text)
        text = re.sub(_currency_re["EUR"], lambda m: _expand_en_currency(m, "EUR"), text)
        return _en_normalize_numbers(text)
    if not _number_words_available(lang):
        return text  # digits pass through the BPE vocab unexpanded
    n2w_lang = lang if lang != "cs" else "cz"
    if lang == "ru":
        text = re.sub(_comma_number_re, _remove_commas, text)
    else:
        text = re.sub(_dot_number_re, _remove_dots, text)
    try:
        text = re.sub(_currency_re["GBP"], lambda m: _expand_currency(m, lang, "GBP"), text)
        text = re.sub(_currency_re["USD"], lambda m: _expand_currency(m, lang, "USD"), text)
        text = re.sub(_currency_re["EUR"], lambda m: _expand_currency(m, lang, "EUR"), text)
    except Exception:
        pass
    if lang != "tr":
        text = re.sub(_decimal_number_re,
                      lambda m: _num2words(float(m.group(1).replace(",", ".")), lang=n2w_lang), text)
    if lang in _ordinal_re:
        text = re.sub(_ordinal_re[lang],
                      lambda m: _num2words(int(m.group(1)), ordinal=True, lang=n2w_lang), text)
    text = re.sub(_number_re, lambda m: _num2words(int(m.group(0)), lang=n2w_lang), text)
    return text
