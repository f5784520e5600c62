"""OpenAI's EnglishTextNormalizer for the WER harness (port of the JAX
package's tools/english_normalizer.py, with the pipeline itself in this file).

The reference harness runs `whisper.normalizers.EnglishTextNormalizer`
before scoring, so a WER is comparable to the reference's only if the same
normalization runs. The JAX tool borrows transformers' line-faithful port of
it; the port's machines have no transformers, so this module carries the
same pipeline:

  lower-case; drop [bracketed] / <angled> / (parenthesised) spans and the
  fillers hmm, mm, mhm, mmm, uh, um; expand contractions and titles; drop
  commas between digits and periods not before a digit; NFKD with symbols,
  marks and punctuation made spaces (keeping . % $ ¢ € £); spoken numbers to
  digits (EnglishNumberNormalizer: ordinals, plurals, currency, percent,
  "point", "double" / "triple", "and a half"); British to American spelling;
  drop the kept symbols where no digit stands beside them; squeeze spaces.

Resolution order, as in the JAX tool:
  1. `whisper.normalizers.EnglishTextNormalizer` if openai-whisper is
     installed (exact, with its full english.json spelling table);
  2. this module's pipeline, with the British-to-American table from
     OWK_ENGLISH_SPELLING_JSON or an explicit path (OpenAI's english.json),
     else the common-word table below.

Use `build_normalizer()` / `normalize_english(text)`.
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from fractions import Fraction
from pathlib import Path

# Common British->American spellings (a subset of OpenAI's english.json,
# covering the frequent cases in speech corpora); the JAX tool's table.
FALLBACK_SPELLING = {
    "accessorise": "accessorize", "acknowledgement": "acknowledgment",
    "aeroplane": "airplane", "ageing": "aging", "aluminium": "aluminum",
    "amortise": "amortize", "analogue": "analog", "analyse": "analyze",
    "apologise": "apologize", "arbour": "arbor", "ardour": "ardor",
    "armour": "armor", "authorise": "authorize", "behaviour": "behavior",
    "behavioural": "behavioral", "calibre": "caliber", "cancelled": "canceled",
    "capitalise": "capitalize", "catalogue": "catalog", "categorise": "categorize",
    "centimetre": "centimeter", "centre": "center", "characterise": "characterize",
    "cheque": "check", "civilisation": "civilization", "civilise": "civilize",
    "colour": "color", "colourful": "colorful", "counselling": "counseling",
    "criticise": "criticize", "customise": "customize", "defence": "defense",
    "dialogue": "dialog", "digitise": "digitize", "draught": "draft",
    "emphasise": "emphasize", "endeavour": "endeavor", "favour": "favor",
    "favourable": "favorable", "favourite": "favorite", "fibre": "fiber",
    "flavour": "flavor", "fulfil": "fulfill", "generalise": "generalize",
    "glamour": "glamor", "grey": "gray", "harbour": "harbor",
    "honour": "honor", "honourable": "honorable", "humour": "humor",
    "jewellery": "jewelry", "judgement": "judgment", "kilometre": "kilometer",
    "labelled": "labeled", "labour": "labor", "licence": "license",
    "litre": "liter", "localise": "localize", "manoeuvre": "maneuver",
    "marvellous": "marvelous", "maximise": "maximize", "memorise": "memorize",
    "metre": "meter", "millimetre": "millimeter", "minimise": "minimize",
    "mobilise": "mobilize", "modelling": "modeling", "modernise": "modernize",
    "mould": "mold", "neighbour": "neighbor", "neighbourhood": "neighborhood",
    "normalise": "normalize", "odour": "odor", "offence": "offense",
    "optimise": "optimize", "organisation": "organization",
    "organise": "organize", "oxidise": "oxidize", "paralyse": "paralyze",
    "parlour": "parlor", "plough": "plow", "practise": "practice",
    "prioritise": "prioritize", "programme": "program", "publicise": "publicize",
    "realise": "realize", "recognise": "recognize", "rumour": "rumor",
    "sabre": "saber", "saviour": "savior", "savour": "savor",
    "signalling": "signaling", "specialise": "specialize",
    "splendour": "splendor", "stabilise": "stabilize",
    "standardise": "standardize", "subsidise": "subsidize",
    "summarise": "summarize", "symbolise": "symbolize",
    "sympathise": "sympathize", "theatre": "theater", "travelled": "traveled",
    "travelling": "traveling", "tumour": "tumor", "tyre": "tire",
    "utilise": "utilize", "valour": "valor", "vapour": "vapor",
    "vigour": "vigor", "whisky": "whiskey",
}

# letters that NFKD does not split into a base letter and a mark
_LETTER_FOLDS = {"œ": "oe", "Œ": "OE", "ø": "o", "Ø": "O", "æ": "ae", "Æ": "AE",
                 "ß": "ss", "ẞ": "SS", "đ": "d", "Đ": "D", "ð": "d", "Ð": "D",
                 "þ": "th", "Þ": "th", "ł": "l", "Ł": "L"}

_FILLERS = r"\b(hmm|mm|mhm|mmm|uh|um)\b"

# applied in this order
_REPLACERS = [
    # common contractions
    (r"\bwon't\b", "will not"), (r"\bcan't\b", "can not"), (r"\blet's\b", "let us"),
    (r"\bain't\b", "aint"), (r"\by'all\b", "you all"), (r"\bwanna\b", "want to"),
    (r"\bgotta\b", "got to"), (r"\bgonna\b", "going to"), (r"\bi'ma\b", "i am going to"),
    (r"\bimma\b", "i am going to"), (r"\bwoulda\b", "would have"),
    (r"\bcoulda\b", "could have"), (r"\bshoulda\b", "should have"),
    (r"\bma'am\b", "madam"),
    # titles and prefixes
    *((rf"\b{short}\b", f"{full} ") for short, full in (
        ("mr", "mister"), ("mrs", "missus"), ("st", "saint"), ("dr", "doctor"),
        ("prof", "professor"), ("capt", "captain"), ("gov", "governor"),
        ("ald", "alderman"), ("gen", "general"), ("sen", "senator"),
        ("rep", "representative"), ("pres", "president"), ("rev", "reverend"),
        ("hon", "honorable"), ("asst", "assistant"), ("assoc", "associate"),
        ("lt", "lieutenant"), ("col", "colonel"), ("jr", "junior"), ("sr", "senior"),
        ("esq", "esquire"))),
    # perfect tenses ("'s done" is ambiguous)
    (r"'d been\b", " had been"), (r"'s been\b", " has been"), (r"'d gone\b", " had gone"),
    (r"'s gone\b", " has gone"), (r"'d done\b", " had done"), (r"'s got\b", " has got"),
    # general contractions
    (r"n't\b", " not"), (r"'re\b", " are"), (r"'s\b", " is"), (r"'d\b", " would"),
    (r"'ll\b", " will"), (r"'t\b", " not"), (r"'ve\b", " have"), (r"'m\b", " am"),
]


def remove_symbols_and_diacritics(s: str, keep: str = "") -> str:
    """NFKD; drop combining marks, fold the letters NFKD leaves whole, and
    make every other mark, symbol and punctuation (but `keep`) a space."""
    out = []
    for c in unicodedata.normalize("NFKD", s):
        cat = unicodedata.category(c)
        if c in keep:
            out.append(c)
        elif c in _LETTER_FOLDS:
            out.append(_LETTER_FOLDS[c])
        elif cat == "Mn":
            continue
        else:
            out.append(" " if cat[0] in "MSP" else c)
    return "".join(out)


_NUMERIC = re.compile(r"^\d+(\.\d+)?$")


class EnglishNumberNormalizer:
    """Spoken numbers to digits: drops commas, keeps suffixes (1960s, 274th,
    32nd), spells currency before the number ($20 million -> $20000000),
    reads runs of single digits as nominal (one oh one -> 101), and writes
    "one(s)" rather than "1(s)"."""

    _ONES = ["one", "two", "three", "four", "five", "six", "seven", "eight", "nine", "ten",
             "eleven", "twelve", "thirteen", "fourteen", "fifteen", "sixteen", "seventeen",
             "eighteen", "nineteen"]
    _TENS = ["twenty", "thirty", "forty", "fifty", "sixty", "seventy", "eighty", "ninety"]
    _MULTIPLIERS = ["hundred", "thousand", "million", "billion", "trillion", "quadrillion",
                    "quintillion", "sextillion", "septillion", "octillion", "nonillion",
                    "decillion"]

    def __init__(self):
        self.zeros = {"o", "oh", "zero"}
        self.ones = {w: i for i, w in enumerate(self._ONES, start=1)}
        self.ones_suffixed = {("sixes" if w == "six" else w + "s"): (v, "s")
                              for w, v in self.ones.items()}
        self.ones_suffixed.update({"zeroth": (0, "th"), "first": (1, "st"),
                                   "second": (2, "nd"), "third": (3, "rd"),
                                   "fifth": (5, "th"), "twelfth": (12, "th")})
        self.ones_suffixed.update({w + ("h" if w.endswith("t") else "th"): (v, "th")
                                   for w, v in self.ones.items()
                                   if v > 3 and v not in (5, 12)})
        self.tens = {w: 20 + 10 * i for i, w in enumerate(self._TENS)}
        self.tens_suffixed = {w.replace("y", "ies"): (v, "s") for w, v in self.tens.items()}
        self.tens_suffixed.update({w.replace("y", "ieth"): (v, "th")
                                   for w, v in self.tens.items()})
        self.multipliers = {w: 10 ** (2 if i == 0 else 3 * i)
                            for i, w in enumerate(self._MULTIPLIERS)}
        self.multipliers_suffixed = {w + "s": (v, "s") for w, v in self.multipliers.items()}
        self.multipliers_suffixed.update({w + "th": (v, "th")
                                          for w, v in self.multipliers.items()})
        self.decimals = {*self.ones, *self.tens, *self.zeros}
        self.preceding_prefixers = {"minus": "-", "negative": "-", "plus": "+",
                                    "positive": "+"}
        self.following_prefixers = {"pound": "£", "pounds": "£", "euro": "€", "euros": "€",
                                    "dollar": "$", "dollars": "$", "cent": "¢", "cents": "¢"}
        self.prefixes = {*self.preceding_prefixers.values(),
                         *self.following_prefixers.values()}
        self.suffixers = {"per": {"cent": "%"}, "percent": "%"}
        self.specials = {"and", "double", "triple", "point"}
        self.words = {*self.zeros, *self.ones, *self.ones_suffixed, *self.tens,
                      *self.tens_suffixed, *self.multipliers, *self.multipliers_suffixed,
                      *self.preceding_prefixers, *self.following_prefixers,
                      *self.suffixers, *self.specials}

    @staticmethod
    def _fraction(s):
        try:
            return Fraction(s)
        except ValueError:
            return None

    @staticmethod
    def _join(value, tail: int, replace_last_zero: bool, modulus: int):
        """`value` followed by the number word `tail` (a one or a ten): a
        string takes it written after it (over its last zero where a ten
        stood before a digit); an integer adds it where it ends in enough
        zeros (`modulus`), else takes it written after it."""
        if isinstance(value, str):
            return (value[:-1] if replace_last_zero else value) + str(tail)
        if value % modulus == 0:
            return value + tail
        return str(value) + str(tail)

    def process_words(self, words: list[str]):
        prefix = value = None
        skip = False

        def output(result):
            nonlocal prefix, value
            result = str(result)
            if prefix is not None:
                result = prefix + result
            prefix = value = None
            return result

        for i, current in enumerate(words):
            if skip:
                skip = False
                continue
            prev = words[i - 1] if i else None
            nxt = words[i + 1] if i + 1 < len(words) else None
            next_is_numeric = nxt is not None and _NUMERIC.match(nxt)
            has_prefix = current[0] in self.prefixes
            bare = current[1:] if has_prefix else current

            if _NUMERIC.match(bare):
                # arabic numbers, possibly signed, possibly with a fraction
                f = self._fraction(bare)
                if f is None:
                    raise ValueError("Converting the fraction failed")
                if value is not None:
                    if isinstance(value, str) and value.endswith("."):
                        value = value + current      # decimals, address parts
                        continue
                    yield output(value)
                prefix = current[0] if has_prefix else prefix
                value = f.numerator if f.denominator == 1 else bare
            elif current not in self.words:
                if value is not None:
                    yield output(value)
                yield output(current)
            elif current in self.zeros:
                value = str(value or "") + "0"
            elif current in self.ones or current in self.ones_suffixed:
                suffixed = current not in self.ones
                ones, suffix = (self.ones_suffixed[current] if suffixed
                                else (self.ones[current], ""))
                if value is None:
                    got = ones
                elif isinstance(value, str) or prev in self.ones:
                    got = self._join(str(value), ones, prev in self.tens and ones < 10, 0)
                else:
                    got = self._join(value, ones, False, 10 if ones < 10 else 100)
                if suffixed:
                    yield output(str(got) + suffix)
                    value = None
                else:
                    value = got
            elif current in self.tens or current in self.tens_suffixed:
                suffixed = current not in self.tens
                tens, suffix = (self.tens_suffixed[current] if suffixed
                                else (self.tens[current], ""))
                if value is None:
                    got = tens
                elif isinstance(value, str):
                    got = value + str(tens)
                else:
                    got = self._join(value, tens, False, 100)
                if suffixed:
                    yield output(str(got) + suffix)
                else:
                    value = got
            elif current in self.multipliers:
                multiplier = self.multipliers[current]
                if value is None:
                    value = multiplier
                elif isinstance(value, str) or value == 0:
                    f = self._fraction(value)
                    p = f * multiplier if f is not None else None
                    if f is not None and p.denominator == 1:
                        value = p.numerator
                    else:
                        yield output(value)
                        value = multiplier
                else:
                    value = value // 1000 * 1000 + value % 1000 * multiplier
            elif current in self.multipliers_suffixed:
                multiplier, suffix = self.multipliers_suffixed[current]
                if value is None:
                    yield output(str(multiplier) + suffix)
                elif isinstance(value, str):
                    f = self._fraction(value)
                    p = f * multiplier if f is not None else None
                    if f is not None and p.denominator == 1:
                        yield output(str(p.numerator) + suffix)
                    else:
                        yield output(value)
                        yield output(str(multiplier) + suffix)
                else:
                    yield output(str(value // 1000 * 1000 + value % 1000 * multiplier)
                                 + suffix)
                value = None
            elif current in self.preceding_prefixers:
                # a sign, where a number follows
                if value is not None:
                    yield output(value)
                if nxt in self.words or next_is_numeric:
                    prefix = self.preceding_prefixers[current]
                else:
                    yield output(current)
            elif current in self.following_prefixers:
                # a currency, after a number
                if value is not None:
                    prefix = self.following_prefixers[current]
                    yield output(value)
                else:
                    yield output(current)
            elif current in self.suffixers:
                # percent
                if value is None:
                    yield output(current)
                    continue
                suffix = self.suffixers[current]
                if not isinstance(suffix, dict):
                    yield output(str(value) + suffix)
                elif nxt in suffix:
                    yield output(str(value) + suffix[nxt])
                    skip = True
                else:
                    yield output(value)
                    yield output(current)
            elif nxt not in self.words and not next_is_numeric:
                # a special word (and, double, triple, point) before no number
                if value is not None:
                    yield output(value)
                yield output(current)
            elif current == "and":
                # dropped after hundred, thousand, ...
                if prev not in self.multipliers:
                    if value is not None:
                        yield output(value)
                    yield output(current)
            elif current in ("double", "triple"):
                if nxt in self.ones or nxt in self.zeros:
                    repeats = 2 if current == "double" else 3
                    value = str(value or "") + str(self.ones.get(nxt, 0)) * repeats
                    skip = True
                else:
                    if value is not None:
                        yield output(value)
                    yield output(current)
            elif current == "point":
                if nxt in self.decimals or next_is_numeric:
                    value = str(value or "") + "."
            else:
                raise ValueError(f"Unexpected token: {current}")

        if value is not None:
            yield output(value)

    def preprocess(self, s: str) -> str:
        # "<number> and a half" -> "<number> point five"
        parts = re.split(r"\band\s+a\s+half\b", s)
        out = []
        for i, part in enumerate(parts):
            if not part.strip():
                continue
            out.append(part)
            if i < len(parts) - 1:
                last = part.rsplit(maxsplit=2)[-1]
                out.append("point five" if last in self.decimals or last in self.multipliers
                           else "and a half")
        s = " ".join(out)
        # a space at each number/letter boundary, but not before a suffix
        s = re.sub(r"([a-z])([0-9])", r"\1 \2", s)
        s = re.sub(r"([0-9])([a-z])", r"\1 \2", s)
        return re.sub(r"([0-9])\s+(st|nd|rd|th|s)\b", r"\1\2", s)

    @staticmethod
    def postprocess(s: str) -> str:
        def combine_cents(m):
            try:
                return f"{m.group(1)}{m.group(2)}.{int(m.group(3)):02d}"
            except ValueError:
                return m.string

        def extract_cents(m):
            try:
                return f"¢{int(m.group(1))}"
            except ValueError:
                return m.string

        # "$2 and ¢7" -> "$2.07"
        s = re.sub(r"([€£$])([0-9]+) (?:and )?¢([0-9]{1,2})\b", combine_cents, s)
        s = re.sub(r"[€£$]0.([0-9]{1,2})\b", extract_cents, s)
        return re.sub(r"\b1(s?)\b", r"one\1", s)

    def __call__(self, s: str) -> str:
        s = self.preprocess(s)
        s = " ".join(w for w in self.process_words(s.split()) if w is not None)
        return self.postprocess(s)


class EnglishTextNormalizer:
    """The whole pipeline (module docstring); `spelling` maps British to
    American words."""

    def __init__(self, spelling: dict):
        self.spelling = spelling
        self.numbers = EnglishNumberNormalizer()

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)     # words between brackets
        s = re.sub(r"\(([^)]+?)\)", "", s)          # words between parentheses
        s = re.sub(_FILLERS, "", s)
        s = re.sub(r"\s+'", "'", s)                  # no space before an apostrophe
        for pattern, replacement in _REPLACERS:
            s = re.sub(pattern, replacement, s)
        s = re.sub(r"(\d),(\d)", r"\1\2", s)         # commas between digits
        s = re.sub(r"\.([^0-9]|$)", r" \1", s)       # periods not before a digit
        s = remove_symbols_and_diacritics(s, keep=".%$¢€£")
        s = self.numbers(s)
        s = " ".join(self.spelling.get(w, w) for w in s.split())
        # the kept symbols where no digit stands beside them
        s = re.sub(r"[.$¢€£]([^0-9])", r" \1", s)
        s = re.sub(r"([^0-9])%", r"\1 ", s)
        return re.sub(r"\s+", " ", s)


def _load_spelling(path: str | Path | None = None) -> dict:
    path = path or os.environ.get("OWK_ENGLISH_SPELLING_JSON")
    if path and Path(path).exists():
        return json.loads(Path(path).read_text())
    return dict(FALLBACK_SPELLING)


def build_normalizer(spelling_json: str | Path | None = None):
    """-> callable(str) -> str, the reference harness's normalization."""
    try:
        from whisper.normalizers import EnglishTextNormalizer as Exact
        return Exact()
    except ImportError:
        pass
    return EnglishTextNormalizer(_load_spelling(spelling_json))


_default = None


def normalize_english(text: str) -> str:
    global _default
    if _default is None:
        _default = build_normalizer()
    return _default(text)
