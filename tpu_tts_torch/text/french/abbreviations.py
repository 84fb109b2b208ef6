"""French abbreviation expansion (copy of `tpu_tts/text/french/abbreviations.py`;
Coqui TTS `TTS/tts/utils/text/french/abbreviations.py`)."""

import re

abbreviations_fr = [
    (re.compile(r"\b%s\." % abbr, re.IGNORECASE), expansion)
    for abbr, expansion in [
        ("M", "monsieur"),
        ("Mlle", "mademoiselle"),
        ("Mlles", "mesdemoiselles"),
        ("Mme", "madame"),
        ("Mmes", "mesdames"),
        ("N\\.B", "nota bene"),
        ("p\\.c\\.q", "parce que"),
        ("Pr", "professeur"),
        ("qqch", "quelque chose"),
        ("rdv", "rendez-vous"),
        ("max", "maximum"),
        ("min", "minimum"),
        ("no", "numéro"),
        ("adr", "adresse"),
        ("dr", "docteur"),
        ("st", "saint"),
        ("co", "companie"),
        ("jr", "junior"),
        ("sgt", "sergent"),
        ("capt", "capitaine"),
        ("col", "colonel"),
        ("av", "avenue"),
        ("av\\. J\\.-C", "avant Jésus-Christ"),
        ("apr\\. J\\.-C", "après Jésus-Christ"),
        ("art", "article"),
        ("boul", "boulevard"),
        ("c\\.-à-d", "c'est-à-dire"),
        ("etc", "et cetera"),
        ("ex", "exemple"),
        ("excl", "exclusivement"),
        ("boul", "boulevard"),
    ]
] + [
    (re.compile(r"\b%s" % abbr), expansion)
    for abbr, expansion in [
        ("Mlle", "mademoiselle"),
        ("Mlles", "mesdemoiselles"),
        ("Mme", "madame"),
        ("Mmes", "mesdames"),
    ]
]
