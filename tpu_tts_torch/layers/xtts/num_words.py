"""From-scratch multilingual number→words — the offline fallback for the
optional `num2words` dependency used by the XTTS text normalizer (a copy of
`tpu_tts/layers/xtts/num_words.py`; Coqui TTS `TTS/tts/layers/xtts/tokenizer.py`:546 imports num2words
unconditionally; here the real package is preferred when installed and this
module serves the same calls otherwise, so no language silently passes
digits through to the BPE).

Covers cardinals 0..999,999,999 for fr de es pt it ru nl tr hu ko pl cs,
decimals (integer part + point word + fraction digits read one by one, the
num2words float behavior), ordinals for fr/de (other languages fall back to
the cardinal — an approximation, stated here), and a simple currency form
compatible with text_norm's integer-amount truncation.
"""

from typing import List

# --------------------------------------------------------------------- tables
_FR_UNITS = ["zéro", "un", "deux", "trois", "quatre", "cinq", "six", "sept", "huit",
             "neuf", "dix", "onze", "douze", "treize", "quatorze", "quinze", "seize",
             "dix-sept", "dix-huit", "dix-neuf"]
_DE_UNITS = ["null", "eins", "zwei", "drei", "vier", "fünf", "sechs", "sieben", "acht",
             "neun", "zehn", "elf", "zwölf", "dreizehn", "vierzehn", "fünfzehn",
             "sechzehn", "siebzehn", "achtzehn", "neunzehn"]
_DE_TENS = {20: "zwanzig", 30: "dreißig", 40: "vierzig", 50: "fünfzig", 60: "sechzig",
            70: "siebzig", 80: "achtzig", 90: "neunzig"}
_ES_UNDER30 = ["cero", "uno", "dos", "tres", "cuatro", "cinco", "seis", "siete", "ocho",
               "nueve", "diez", "once", "doce", "trece", "catorce", "quince",
               "dieciséis", "diecisiete", "dieciocho", "diecinueve", "veinte",
               "veintiuno", "veintidós", "veintitrés", "veinticuatro", "veinticinco",
               "veintiséis", "veintisiete", "veintiocho", "veintinueve"]
_ES_TENS = {30: "treinta", 40: "cuarenta", 50: "cincuenta", 60: "sesenta",
            70: "setenta", 80: "ochenta", 90: "noventa"}
_ES_HUNDREDS = {1: "ciento", 2: "doscientos", 3: "trescientos", 4: "cuatrocientos",
                5: "quinientos", 6: "seiscientos", 7: "setecientos", 8: "ochocientos",
                9: "novecientos"}
_PT_UNITS = ["zero", "um", "dois", "três", "quatro", "cinco", "seis", "sete", "oito",
             "nove", "dez", "onze", "doze", "treze", "catorze", "quinze", "dezasseis",
             "dezassete", "dezoito", "dezanove"]
_PT_TENS = {20: "vinte", 30: "trinta", 40: "quarenta", 50: "cinquenta", 60: "sessenta",
            70: "setenta", 80: "oitenta", 90: "noventa"}
_PT_HUNDREDS = {1: "cento", 2: "duzentos", 3: "trezentos", 4: "quatrocentos",
                5: "quinhentos", 6: "seiscentos", 7: "setecentos", 8: "oitocentos",
                9: "novecentos"}
_IT_UNITS = ["zero", "uno", "due", "tre", "quattro", "cinque", "sei", "sette", "otto",
             "nove", "dieci", "undici", "dodici", "tredici", "quattordici", "quindici",
             "sedici", "diciassette", "diciotto", "diciannove"]
_IT_TENS = {20: "venti", 30: "trenta", 40: "quaranta", 50: "cinquanta", 60: "sessanta",
            70: "settanta", 80: "ottanta", 90: "novanta"}
_RU_UNITS = ["ноль", "один", "два", "три", "четыре", "пять", "шесть", "семь", "восемь",
             "девять", "десять", "одиннадцать", "двенадцать", "тринадцать",
             "четырнадцать", "пятнадцать", "шестнадцать", "семнадцать",
             "восемнадцать", "девятнадцать"]
_RU_TENS = {20: "двадцать", 30: "тридцать", 40: "сорок", 50: "пятьдесят",
            60: "шестьдесят", 70: "семьдесят", 80: "восемьдесят", 90: "девяносто"}
_RU_HUNDREDS = {1: "сто", 2: "двести", 3: "триста", 4: "четыреста", 5: "пятьсот",
                6: "шестьсот", 7: "семьсот", 8: "восемьсот", 9: "девятьсот"}
_NL_UNITS = ["nul", "een", "twee", "drie", "vier", "vijf", "zes", "zeven", "acht",
             "negen", "tien", "elf", "twaalf", "dertien", "veertien", "vijftien",
             "zestien", "zeventien", "achttien", "negentien"]
_NL_TENS = {20: "twintig", 30: "dertig", 40: "veertig", 50: "vijftig", 60: "zestig",
            70: "zeventig", 80: "tachtig", 90: "negentig"}
_TR_UNITS = ["sıfır", "bir", "iki", "üç", "dört", "beş", "altı", "yedi", "sekiz", "dokuz"]
_TR_TENS = {10: "on", 20: "yirmi", 30: "otuz", 40: "kırk", 50: "elli", 60: "altmış",
            70: "yetmiş", 80: "seksen", 90: "doksan"}
_HU_UNITS = ["nulla", "egy", "kettő", "három", "négy", "öt", "hat", "hét", "nyolc", "kilenc"]
_HU_UNITS_C = ["", "egy", "két", "három", "négy", "öt", "hat", "hét", "nyolc", "kilenc"]
_HU_TENS = {10: "tíz", 20: "húsz", 30: "harminc", 40: "negyven", 50: "ötven",
            60: "hatvan", 70: "hetven", 80: "nyolcvan", 90: "kilencven"}
_HU_TENS_C = {10: "tizen", 20: "huszon", 30: "harminc", 40: "negyven", 50: "ötven",
              60: "hatvan", 70: "hetven", 80: "nyolcvan", 90: "kilencven"}
_KO_DIGITS = ["", "일", "이", "삼", "사", "오", "육", "칠", "팔", "구"]
_PL_UNITS = ["zero", "jeden", "dwa", "trzy", "cztery", "pięć", "sześć", "siedem",
             "osiem", "dziewięć", "dziesięć", "jedenaście", "dwanaście", "trzynaście",
             "czternaście", "piętnaście", "szesnaście", "siedemnaście", "osiemnaście",
             "dziewiętnaście"]
_PL_TENS = {20: "dwadzieścia", 30: "trzydzieści", 40: "czterdzieści", 50: "pięćdziesiąt",
            60: "sześćdziesiąt", 70: "siedemdziesiąt", 80: "osiemdziesiąt",
            90: "dziewięćdziesiąt"}
_PL_HUNDREDS = {1: "sto", 2: "dwieście", 3: "trzysta", 4: "czterysta", 5: "pięćset",
                6: "sześćset", 7: "siedemset", 8: "osiemset", 9: "dziewięćset"}
_CS_UNITS = ["nula", "jedna", "dva", "tři", "čtyři", "pět", "šest", "sedm", "osm",
             "devět", "deset", "jedenáct", "dvanáct", "třináct", "čtrnáct", "patnáct",
             "šestnáct", "sedmnáct", "osmnáct", "devatenáct"]
_CS_TENS = {20: "dvacet", 30: "třicet", 40: "čtyřicet", 50: "padesát", 60: "šedesát",
            70: "sedmdesát", 80: "osmdesát", 90: "devadesát"}

POINT_WORDS = {"fr": "virgule", "de": "Komma", "es": "punto", "pt": "vírgula",
               "it": "virgola", "ru": "запятая", "nl": "komma", "tr": "virgül",
               "hu": "egész", "ko": "점", "pl": "przecinek", "cs": "celá"}

SUPPORTED = set(POINT_WORDS)


# ------------------------------------------------------------------ per-lang
def _fr_under100(n: int) -> str:
    if n < 20:
        return _FR_UNITS[n]
    t, u = divmod(n, 10)
    if 2 <= t <= 6:
        base = ["vingt", "trente", "quarante", "cinquante", "soixante"][t - 2]
        if u == 0:
            return base
        if u == 1:
            return base + " et un"
        return base + "-" + _FR_UNITS[u]
    if t == 7:
        return "soixante et onze" if u == 1 else "soixante-" + _FR_UNITS[10 + u]
    if t == 8:
        return "quatre-vingts" if u == 0 else "quatre-vingt-" + _FR_UNITS[u]
    return "quatre-vingt-" + _FR_UNITS[10 + u]


def _fr(n: int) -> str:
    if n < 100:
        return _fr_under100(n)
    if n < 1000:
        h, r = divmod(n, 100)
        head = "cent" if h == 1 else _FR_UNITS[h] + (" cents" if r == 0 else " cent")
        return head if r == 0 else head + " " + _fr_under100(r)
    if n < 10**6:
        k, r = divmod(n, 1000)
        head = "mille" if k == 1 else _fr(k) + " mille"
        return head if r == 0 else head + " " + _fr(r)
    m, r = divmod(n, 10**6)
    head = ("un million" if m == 1 else _fr(m) + " millions")
    return head if r == 0 else head + " " + _fr(r)


def _de_unit_c(u: int) -> str:
    return "ein" if u == 1 else _DE_UNITS[u]


def _de_under100(n: int, compound: bool = False) -> str:
    if n < 20:
        return (_de_unit_c(n) if compound and n == 1 else _DE_UNITS[n])
    t, u = divmod(n, 10)
    if u == 0:
        return _DE_TENS[t * 10]
    return _de_unit_c(u) + "und" + _DE_TENS[t * 10]


def _de(n: int) -> str:
    if n < 100:
        return _de_under100(n)
    if n < 1000:
        h, r = divmod(n, 100)
        head = _de_unit_c(h) + "hundert"
        return head if r == 0 else head + _de_under100(r, compound=True)
    if n < 10**6:
        k, r = divmod(n, 1000)
        head = (_de_under100(k, compound=True) if k < 100 else _de(k)) + "tausend"
        if r == 0:
            return head
        return head + (_de(r) if r >= 100 else _de_under100(r, compound=True))
    m, r = divmod(n, 10**6)
    head = "eine Million" if m == 1 else _de(m) + " Millionen"
    return head if r == 0 else head + " " + _de(r)


def _es(n: int) -> str:
    if n < 30:
        return _ES_UNDER30[n]
    if n < 100:
        t, u = divmod(n, 10)
        return _ES_TENS[t * 10] + ("" if u == 0 else " y " + _ES_UNDER30[u])
    if n < 1000:
        h, r = divmod(n, 100)
        if h == 1 and r == 0:
            return "cien"
        head = _ES_HUNDREDS[h]
        return head if r == 0 else head + " " + _es(r)
    if n < 10**6:
        k, r = divmod(n, 1000)
        head = "mil" if k == 1 else _es(k) + " mil"
        return head if r == 0 else head + " " + _es(r)
    m, r = divmod(n, 10**6)
    head = "un millón" if m == 1 else _es(m) + " millones"
    return head if r == 0 else head + " " + _es(r)


def _pt(n: int) -> str:
    if n < 20:
        return _PT_UNITS[n]
    if n < 100:
        t, u = divmod(n, 10)
        return _PT_TENS[t * 10] + ("" if u == 0 else " e " + _PT_UNITS[u])
    if n < 1000:
        h, r = divmod(n, 100)
        if h == 1 and r == 0:
            return "cem"
        head = _PT_HUNDREDS[h]
        return head if r == 0 else head + " e " + _pt(r)
    if n < 10**6:
        k, r = divmod(n, 1000)
        head = "mil" if k == 1 else _pt(k) + " mil"
        if r == 0:
            return head
        joiner = " e " if (r < 100 or r % 100 == 0) else " "
        return head + joiner + _pt(r)
    m, r = divmod(n, 10**6)
    head = "um milhão" if m == 1 else _pt(m) + " milhões"
    return head if r == 0 else head + " e " + _pt(r)


def _it_join(base: str, unit_word: str) -> str:
    if unit_word and unit_word[0] in "aeiou" and base[-1] in "aeiou":
        base = base[:-1]
    out = base + unit_word
    return out


def _it(n: int) -> str:
    if n < 20:
        return _IT_UNITS[n]
    if n < 100:
        t, u = divmod(n, 10)
        if u == 0:
            return _IT_TENS[t * 10]
        w = _it_join(_IT_TENS[t * 10], _IT_UNITS[u] if u != 3 else "tre")
        if u == 3:
            w = w[:-3] + "tré"
        return w
    if n < 1000:
        h, r = divmod(n, 100)
        head = ("" if h == 1 else _IT_UNITS[h]) + "cento"
        return head if r == 0 else head + _it(r)
    if n < 10**6:
        k, r = divmod(n, 1000)
        head = "mille" if k == 1 else _it(k) + "mila"
        return head if r == 0 else head + _it(r)
    m, r = divmod(n, 10**6)
    head = "un milione" if m == 1 else _it(m) + " milioni"
    return head if r == 0 else head + " " + _it(r)


def _slavic_plural(n: int, forms) -> str:
    """(one, few, many) Slavic agreement by the last two digits."""
    one, few, many = forms
    if 11 <= n % 100 <= 14:
        return many
    d = n % 10
    if d == 1:
        return one
    if 2 <= d <= 4:
        return few
    return many


def _ru(n: int) -> str:
    if n < 20:
        return _RU_UNITS[n]
    if n < 100:
        t, u = divmod(n, 10)
        return _RU_TENS[t * 10] + ("" if u == 0 else " " + _RU_UNITS[u])
    if n < 1000:
        h, r = divmod(n, 100)
        head = _RU_HUNDREDS[h]
        return head if r == 0 else head + " " + _ru(r)
    if n < 10**6:
        k, r = divmod(n, 1000)
        # thousands count is feminine: один→одна, два→две on the last digit
        count = _ru(k)
        if not 11 <= k % 100 <= 14:
            if k % 10 == 1:
                count = ("" if k == 1 else _ru(k - 1) + " ") + "одна"
            elif k % 10 == 2:
                count = ("" if k == 2 else _ru(k - 2) + " ") + "две"
        head = count + " " + _slavic_plural(k, ("тысяча", "тысячи", "тысяч"))
        return head if r == 0 else head + " " + _ru(r)
    m, r = divmod(n, 10**6)
    head = _ru(m) + " " + _slavic_plural(m, ("миллион", "миллиона", "миллионов")) if m != 1 \
        else "один миллион"
    return head if r == 0 else head + " " + _ru(r)


def _nl(n: int) -> str:
    if n < 20:
        return _NL_UNITS[n]
    if n < 100:
        t, u = divmod(n, 10)
        if u == 0:
            return _NL_TENS[t * 10]
        unit = _NL_UNITS[u]
        join = "ën" if unit[-1] == "e" else "en"
        return unit + join + _NL_TENS[t * 10]
    if n < 1000:
        h, r = divmod(n, 100)
        head = ("" if h == 1 else _NL_UNITS[h]) + "honderd"
        return head if r == 0 else head + _nl(r)
    if n < 10**6:
        k, r = divmod(n, 1000)
        head = "duizend" if k == 1 else _nl(k) + "duizend"
        return head if r == 0 else head + " " + _nl(r)
    m, r = divmod(n, 10**6)
    head = ("een miljoen" if m == 1 else _nl(m) + " miljoen")
    return head if r == 0 else head + " " + _nl(r)


def _tr(n: int) -> str:
    if n == 0:
        return _TR_UNITS[0]
    parts: List[str] = []
    m, n = divmod(n, 10**6)
    if m:
        parts.append("bir milyon" if m == 1 else _tr(m) + " milyon")
    k, n = divmod(n, 1000)
    if k:
        parts.append("bin" if k == 1 else _tr(k) + " bin")
    h, n = divmod(n, 100)
    if h:
        parts.append("yüz" if h == 1 else _TR_UNITS[h] + " yüz")
    t, u = divmod(n, 10)
    if t:
        parts.append(_TR_TENS[t * 10])
    if u:
        parts.append(_TR_UNITS[u])
    return " ".join(parts)


def _hu(n: int) -> str:
    if n < 10:
        return _HU_UNITS[n]
    if n < 100:
        t, u = divmod(n, 10)
        if u == 0:
            return _HU_TENS[t * 10]
        return _HU_TENS_C[t * 10] + _HU_UNITS[u]
    if n < 1000:
        h, r = divmod(n, 100)
        head = ("" if h == 1 else _HU_UNITS_C[h]) + "száz"
        return head if r == 0 else head + _hu(r)
    if n < 10**6:
        k, r = divmod(n, 1000)
        head = "ezer" if k == 1 else _hu(k) + "ezer"
        return head if r == 0 else head + ("" if n < 2000 else "-") + _hu(r)
    m, r = divmod(n, 10**6)
    head = ("egymillió" if m == 1 else _hu(m) + "millió")
    return head if r == 0 else head + "-" + _hu(r)


def _ko(n: int) -> str:
    if n == 0:
        return "영"
    if n >= 10**8:
        m, r = divmod(n, 10**8)
        return _ko(m) + "억" + ("" if r == 0 else " " + _ko(r))
    if n >= 10**4:
        m, r = divmod(n, 10**4)
        head = ("" if m == 1 else _ko(m)) + "만"
        return head if r == 0 else head + " " + _ko(r)
    out = ""
    for unit_val, unit in ((1000, "천"), (100, "백"), (10, "십")):
        d, n = divmod(n, unit_val)
        if d:
            out += ("" if d == 1 else _KO_DIGITS[d]) + unit
    if n:
        out += _KO_DIGITS[n]
    return out


def _pl(n: int) -> str:
    if n < 20:
        return _PL_UNITS[n]
    if n < 100:
        t, u = divmod(n, 10)
        return _PL_TENS[t * 10] + ("" if u == 0 else " " + _PL_UNITS[u])
    if n < 1000:
        h, r = divmod(n, 100)
        head = _PL_HUNDREDS[h]
        return head if r == 0 else head + " " + _pl(r)
    if n < 10**6:
        k, r = divmod(n, 1000)
        head = "tysiąc" if k == 1 else _pl(k) + " " + _slavic_plural(k, ("tysiąc", "tysiące", "tysięcy"))
        return head if r == 0 else head + " " + _pl(r)
    m, r = divmod(n, 10**6)
    head = "milion" if m == 1 else _pl(m) + " " + _slavic_plural(m, ("milion", "miliony", "milionów"))
    return head if r == 0 else head + " " + _pl(r)


def _cs(n: int) -> str:
    if n < 20:
        return _CS_UNITS[n]
    if n < 100:
        t, u = divmod(n, 10)
        return _CS_TENS[t * 10] + ("" if u == 0 else " " + _CS_UNITS[u])
    if n < 1000:
        h, r = divmod(n, 100)
        head = {1: "sto", 2: "dvě stě", 3: "tři sta", 4: "čtyři sta"}.get(h, _CS_UNITS[h] + " set")
        return head if r == 0 else head + " " + _cs(r)
    if n < 10**6:
        k, r = divmod(n, 1000)
        head = "tisíc" if k == 1 else _cs(k) + " " + _slavic_plural(k, ("tisíc", "tisíce", "tisíc"))
        return head if r == 0 else head + " " + _cs(r)
    m, r = divmod(n, 10**6)
    head = "milion" if m == 1 else _cs(m) + " " + _slavic_plural(m, ("milion", "miliony", "milionů"))
    return head if r == 0 else head + " " + _cs(r)


_CARDINALS = {"fr": _fr, "de": _de, "es": _es, "pt": _pt, "it": _it, "ru": _ru,
              "nl": _nl, "tr": _tr, "hu": _hu, "ko": _ko, "pl": _pl, "cs": _cs}


def cardinal(n: int, lang: str) -> str:
    fn = _CARDINALS.get(lang)
    if fn is None:
        raise NotImplementedError(f"no built-in number words for lang {lang!r}")
    if n < 0:
        # minus words (rarely hit through the normalizer's regexes)
        minus = {"fr": "moins", "de": "minus", "es": "menos", "pt": "menos",
                 "it": "meno", "ru": "минус", "nl": "min", "tr": "eksi",
                 "hu": "mínusz", "ko": "마이너스", "pl": "minus", "cs": "minus"}[lang]
        return minus + " " + fn(-n)
    return fn(int(n))


_KO_POINT_DIGITS = ["영", "일", "이", "삼", "사", "오", "육", "칠", "팔", "구"]


def decimal_words(int_part: int, frac_digits: str, lang: str) -> str:
    """num2words float behavior: integer cardinal + point word + each
    fractional digit spelled separately."""
    point = POINT_WORDS[lang]
    if lang == "ko":
        digits = "".join(_KO_POINT_DIGITS[int(d)] for d in frac_digits)
        return cardinal(int_part, lang) + " " + point + " " + digits
    digits = " ".join(cardinal(int(d), lang) for d in frac_digits)
    return cardinal(int_part, lang) + " " + point + " " + digits


def ordinal(n: int, lang: str) -> str:
    """fr/de get real ordinals; every other language falls back to the
    cardinal (stated approximation — install num2words for exact forms)."""
    if lang == "fr":
        if n == 1:
            return "premier"
        c = cardinal(n, "fr")
        if c.endswith("e"):
            c = c[:-1]
        elif c.endswith("cinq"):
            c = c + "u"
        elif c.endswith("neuf"):
            c = c[:-1] + "v"
        elif c.endswith("cents") or c.endswith("quatre-vingts"):
            c = c[:-1]
        return c + "ième"
    if lang == "de":
        if n == 1:
            return "erste"
        if n == 3:
            return "dritte"
        if n == 7:
            return "siebte"
        if n == 8:
            return "achte"
        c = cardinal(n, "de")
        return c + ("te" if n < 20 else "ste")
    return cardinal(n, lang)


_CURRENCY_WORDS = {
    # lang -> {code: (unit word, cent word)} — used only by the fallback
    # currency form; text_norm truncates integer amounts at the language's
    # "and" word, which this form includes.
    "fr": {"EUR": ("euros", "centimes"), "USD": ("dollars", "cents"), "GBP": ("livres", "pence")},
    "de": {"EUR": ("Euro", "Cent"), "USD": ("Dollar", "Cent"), "GBP": ("Pfund", "Pence")},
    "es": {"EUR": ("euros", "céntimos"), "USD": ("dólares", "centavos"), "GBP": ("libras", "peniques")},
    "pt": {"EUR": ("euros", "cêntimos"), "USD": ("dólares", "cêntimos"), "GBP": ("libras", "pence")},
    "it": {"EUR": ("euro", "centesimi"), "USD": ("dollari", "centesimi"), "GBP": ("sterline", "penny")},
    "ru": {"EUR": ("евро", "центов"), "USD": ("долларов", "центов"), "GBP": ("фунтов", "пенсов")},
    "nl": {"EUR": ("euro", "cent"), "USD": ("dollar", "cent"), "GBP": ("pond", "pence")},
    "tr": {"EUR": ("avro", "sent"), "USD": ("dolar", "sent"), "GBP": ("sterlin", "peni")},
    "hu": {"EUR": ("euró", "cent"), "USD": ("dollár", "cent"), "GBP": ("font", "penny")},
    "ko": {"EUR": ("유로", "센트"), "USD": ("달러", "센트"), "GBP": ("파운드", "펜스")},
    "pl": {"EUR": ("euro", "centów"), "USD": ("dolarów", "centów"), "GBP": ("funtów", "pensów")},
    "cs": {"EUR": ("eur", "centů"), "USD": ("dolarů", "centů"), "GBP": ("liber", "pencí")},
}

_AND_WORDS = {"fr": "et", "de": "und", "es": "con", "pt": "e", "it": "e", "ru": "и",
              "nl": "en", "tr": "ve", "hu": "és", "ko": "и", "pl": "i", "cs": "a"}


def currency_words(amount: float, currency: str, lang: str) -> str:
    words = _CURRENCY_WORDS.get(lang, {}).get(currency)
    if words is None:
        raise NotImplementedError(f"no currency words for {lang}/{currency}")
    unit_word, cent_word = words
    whole = int(amount)
    cents = int(round((amount - whole) * 100))
    out = cardinal(whole, lang) + " " + unit_word
    out += " " + _AND_WORDS.get(lang, "") + " " + cardinal(cents, lang) + " " + cent_word
    return out
