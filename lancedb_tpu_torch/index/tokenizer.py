"""Text analysis for the FTS index: tokenizers, Porter stemming,
stop words, ascii folding.

Covers the reference tokenizer surface (python index.py:111-188:
base_tokenizer simple/whitespace/raw/ngram, language stemming, stop
words, ascii_folding, max_token_length, ngram options). 'icu' maps to
UAX #29 word-boundary segmentation, 'jieba' to real dictionary
segmentation (DAG + unigram DP), and 'lindera' to forward maximum
matching over a bundled Japanese seed lexicon (data/ja_seed.txt;
dict_path= extends or replaces it). The tokenizer registry is the
extension point.
"""

from __future__ import annotations

import functools
import logging
import os
import re
import unicodedata
from dataclasses import dataclass

logger = logging.getLogger(__name__)

_WORD_RE = re.compile(r"[A-Za-z0-9_]+")
_WS_RE = re.compile(r"\S+")

# classic english stop word list (lucene's)
ENGLISH_STOP_WORDS = frozenset(
    """a an and are as at be but by for if in into is it no not of on or such
    that the their then there these they this to was will with""".split()
)


@functools.lru_cache(maxsize=65536)
def _porter_stem(w: str) -> str:
    """Compact Porter stemmer (standard algorithm, steps 1a–5b).
    Memoized: query terms and corpus vocabulary repeat heavily, and the
    pure-python steps cost ~30µs per distinct word."""
    if len(w) <= 2:
        return w

    def cons(word, i):
        c = word[i]
        if c in "aeiou":
            return False
        if c == "y":
            return i == 0 or not cons(word, i - 1)
        return True

    def measure(stem):
        # number of VC sequences
        form = ""
        for i in range(len(stem)):
            form += "C" if cons(stem, i) else "V"
        form = re.sub(r"C+", "C", form)
        form = re.sub(r"V+", "V", form)
        return form.count("VC")

    def has_vowel(stem):
        return any(not cons(stem, i) for i in range(len(stem)))

    def ends_double_cons(word):
        return len(word) >= 2 and word[-1] == word[-2] and cons(word, len(word) - 1)

    def cvc(word):
        if len(word) < 3:
            return False
        if not (cons(word, len(word) - 3) and not cons(word, len(word) - 2) and cons(word, len(word) - 1)):
            return False
        return word[-1] not in "wxy"

    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]
    # step 1b
    flag = False
    if w.endswith("eed"):
        if measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed"):
        if has_vowel(w[:-2]):
            w = w[:-2]
            flag = True
    elif w.endswith("ing"):
        if has_vowel(w[:-3]):
            w = w[:-3]
            flag = True
    if flag:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif ends_double_cons(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif measure(w) == 1 and cvc(w):
            w += "e"
    # step 1c
    if w.endswith("y") and has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # step 2
    pairs2 = [
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
        ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"),
        ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
        ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
        ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
    ]
    for suf, rep in pairs2:
        if w.endswith(suf):
            if measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 3
    pairs3 = [
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ]
    for suf, rep in pairs3:
        if w.endswith(suf):
            if measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 4
    sufs4 = [
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
    ]
    for suf in sorted(sufs4, key=len, reverse=True):
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if measure(stem) > 1:
                w = stem
            break
    else:
        if w.endswith("ion") and measure(w[:-3]) > 1 and w[:-3].endswith(("s", "t")):
            w = w[:-3]
    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = measure(stem)
        if m > 1 or (m == 1 and not cvc(stem)):
            w = stem
    # step 5b
    if measure(w) > 1 and ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


def _ascii_fold(text: str) -> str:
    return unicodedata.normalize("NFKD", text).encode("ascii", "ignore").decode()


def _accent_fold(text: str) -> str:
    """Strip combining marks but KEEP non-latin scripts (the ascii fold
    would delete CJK outright) — used by the unicode tokenizer. The
    final NFC pass recomposes what decomposition took apart and
    survives mark-stripping — notably Hangul syllables, which NFKD
    breaks into conjoining jamo."""
    stripped = "".join(
        c for c in unicodedata.normalize("NFKD", text)
        # keep kana voicing marks (U+3099/309A): folding だ→た or ぱ→は
        # conflates distinct Japanese words
        if unicodedata.category(c) != "Mn" or 0x3099 <= ord(c) <= 0x309A
    )
    return unicodedata.normalize("NFC", stripped)


def _is_cjk(c: str) -> bool:
    o = ord(c)
    return (
        0x4E00 <= o <= 0x9FFF      # CJK unified
        or 0x3400 <= o <= 0x4DBF   # CJK ext A
        or 0x3040 <= o <= 0x30FF   # hiragana + katakana
        or 0xAC00 <= o <= 0xD7AF   # hangul syllables
        or 0xF900 <= o <= 0xFAFF   # CJK compat
    )


_UNI_WORD_RE = re.compile(r"\w+", re.UNICODE)


def _unicode_tokens(text: str, cjk_bigrams: bool = False) -> list[str]:
    """ICU-style segmentation: unicode word boundaries; CJK runs split
    into single-character tokens, or overlapping character bigrams when
    cjk_bigrams=True (Lucene CJKAnalyzer behavior — the reference's
    jieba/lindera tokenizers are dictionary-backed segmenters; bigram
    indexing is the standard dictionary-free equivalent with comparable
    recall on han/kana/hangul text)."""
    out: list[str] = []
    for run in _UNI_WORD_RE.findall(text):
        seg = ""
        cjk_run = ""
        for c in run:
            if _is_cjk(c):
                if seg:
                    out.append(seg)
                    seg = ""
                cjk_run += c
            else:
                if cjk_run:
                    out.extend(_emit_cjk(cjk_run, cjk_bigrams))
                    cjk_run = ""
                seg += c
        if seg:
            out.append(seg)
        if cjk_run:
            out.extend(_emit_cjk(cjk_run, cjk_bigrams))
    return out


def _emit_cjk(run: str, bigrams: bool) -> list[str]:
    if not bigrams or len(run) == 1:
        return list(run)
    return [run[i : i + 2] for i in range(len(run) - 1)]


# ---- UAX #29 word segmentation (the algorithm ICU implements) --------
# The reference's `icu` tokenizer is ICU's word-break iterator
# (python/python/lancedb/index.py:111-188 base_tokenizer="icu"); ICU's
# word breaks are UAX #29 (Unicode TR29 "Text Segmentation"). This is a
# direct implementation of the WB rules over property classes derived
# from unicodedata + the (small, stable) explicit code-point lists in
# WordBreakProperty.txt, so "don't", "3.14", "1,000", "e.g", "foo_bar"
# and katakana runs segment exactly as ICU segments them — the prior
# `\w+` approximation split all of those. Han / Hiragana take UAX #29's
# default (every pair breaks → single-character tokens), which is also
# what ICU does without its CJK dictionary; Hangul is ALetter (whole
# words), matching ICU.

_WB_OTHER, _WB_AL, _WB_HL, _WB_NUM, _WB_KA, _WB_ML, _WB_MN, _WB_MNL, \
    _WB_SQ, _WB_DQ, _WB_ENL, _WB_EXT, _WB_FMT, _WB_ZWJ, _WB_RI, _WB_NL, \
    _WB_WS = range(17)

_WB_MIDLETTER = {0x3A, 0xB7, 0x387, 0x55F, 0x5F4, 0x2027, 0xFE13, 0xFE55,
                 0xFF1A}
_WB_MIDNUM = {0x2C, 0x3B, 0x37E, 0x589, 0x60C, 0x60D, 0x66C, 0x7F8,
              0x2044, 0xFE10, 0xFE14, 0xFE50, 0xFE54, 0xFF0C, 0xFF1B}
_WB_MIDNUMLET = {0x2E, 0x2018, 0x2019, 0x2024, 0xFE52, 0xFF07, 0xFF0E}
_WB_NEWLINES = {0x0A, 0x0B, 0x0C, 0x0D, 0x85, 0x2028, 0x2029}

_WB_CLASS_CACHE: dict[str, int] = {}


def _wb_class_uncached(c: str) -> int:
    o = ord(c)
    if o in _WB_NEWLINES:
        return _WB_NL
    if o == 0x27:
        return _WB_SQ
    if o == 0x22:
        return _WB_DQ
    if o == 0x200D:
        return _WB_ZWJ
    if o in _WB_MIDLETTER:
        return _WB_ML
    if o in _WB_MIDNUM:
        return _WB_MN
    if o in _WB_MIDNUMLET:
        return _WB_MNL
    if 0x1F1E6 <= o <= 0x1F1FF:
        return _WB_RI
    if (0x30A1 <= o <= 0x30FA or 0x30FC <= o <= 0x30FE
            or 0x31F0 <= o <= 0x31FF or 0xFF66 <= o <= 0xFF9F
            or 0x32D0 <= o <= 0x32FE or o == 0x3357):
        return _WB_KA
    cat = unicodedata.category(c)
    if cat in ("Mn", "Mc", "Me") or o == 0x200C:
        return _WB_EXT
    if cat == "Cf":
        return _WB_FMT
    if cat == "Pc":          # ExtendNumLet: '_' and friends
        return _WB_ENL
    if cat == "Nd":
        return _WB_NUM
    if cat == "Zs" or c.isspace():
        return _WB_WS
    if c.isalpha():
        # Han (no WB rule joins — default break both sides) and
        # Hiragana are excluded from ALetter by UAX #29
        if (0x4E00 <= o <= 0x9FFF or 0x3400 <= o <= 0x4DBF
                or 0xF900 <= o <= 0xFAFF or 0x20000 <= o <= 0x2FA1F
                or 0x3041 <= o <= 0x3096 or 0x309D <= o <= 0x309F):
            return _WB_OTHER
        if 0x5D0 <= o <= 0x5EA or 0x5EF <= o <= 0x5F2 or 0xFB1D <= o <= 0xFB4F:
            return _WB_HL
        return _WB_AL
    return _WB_OTHER


def _wb_class(c: str) -> int:
    v = _WB_CLASS_CACHE.get(c)
    if v is None:
        v = _WB_CLASS_CACHE[c] = _wb_class_uncached(c)
    return v


_WB_AHL = (_WB_AL, _WB_HL)
_WB_MID_WORD = (_WB_ML, _WB_MNL, _WB_SQ)
_WB_MID_NUM = (_WB_MN, _WB_MNL, _WB_SQ)
_WB_IGNORE = (_WB_EXT, _WB_FMT, _WB_ZWJ)
_WB_JOINABLE = (_WB_AL, _WB_HL, _WB_NUM, _WB_KA, _WB_ENL)


def _uax29_segments(text: str) -> list[str]:
    """Split ``text`` at UAX #29 word boundaries (rules WB3–WB13b +
    the WB999 default; WB4 collapses Extend/Format/ZWJ onto the
    preceding character)."""
    n = len(text)
    if n == 0:
        return []
    cls = [_wb_class(c) for c in text]

    def prev_base(i: int) -> int:
        while i >= 0 and cls[i] in _WB_IGNORE:
            i -= 1
        return cls[i] if i >= 0 else -1

    def prev_base_idx(i: int) -> int:
        while i >= 0 and cls[i] in _WB_IGNORE:
            i -= 1
        return i

    def next_base(i: int) -> int:
        while i < n and cls[i] in _WB_IGNORE:
            i += 1
        return cls[i] if i < n else -1

    breaks = [0]
    for i in range(1, n):
        c1, c2 = cls[i - 1], cls[i]
        # WB3/WB3a/WB3b: newlines break around, except CR x LF
        if c1 == _WB_NL or c2 == _WB_NL:
            if not (text[i - 1] == "\r" and text[i] == "\n"):
                breaks.append(i)
            continue
        # WB4: X (Extend|Format|ZWJ)* -> X
        if c2 in _WB_IGNORE:
            continue
        p_idx = prev_base_idx(i - 1)
        p = cls[p_idx] if p_idx >= 0 else -1
        q = c2
        if p in _WB_AHL and q in _WB_AHL:               # WB5
            continue
        if p in _WB_AHL and q in _WB_MID_WORD and next_base(i + 1) in _WB_AHL:
            continue                                     # WB6
        if p in _WB_MID_WORD and q in _WB_AHL and \
                prev_base(p_idx - 1) in _WB_AHL:
            continue                                     # WB7
        if p == _WB_HL and q == _WB_SQ:                  # WB7a
            continue
        if p == _WB_HL and q == _WB_DQ and next_base(i + 1) == _WB_HL:
            continue                                     # WB7b
        if p == _WB_DQ and q == _WB_HL and prev_base(p_idx - 1) == _WB_HL:
            continue                                     # WB7c
        if p == _WB_NUM and q == _WB_NUM:                # WB8
            continue
        if p in _WB_AHL and q == _WB_NUM:                # WB9
            continue
        if p == _WB_NUM and q in _WB_AHL:                # WB10
            continue
        if p in _WB_MID_NUM and q == _WB_NUM and \
                prev_base(p_idx - 1) == _WB_NUM:
            continue                                     # WB11
        if p == _WB_NUM and q in _WB_MID_NUM and next_base(i + 1) == _WB_NUM:
            continue                                     # WB12
        if p == _WB_KA and q == _WB_KA:                  # WB13
            continue
        if p in _WB_JOINABLE and q == _WB_ENL:           # WB13a
            continue
        if p == _WB_ENL and q in (_WB_AL, _WB_HL, _WB_NUM, _WB_KA):
            continue                                     # WB13b
        if p == _WB_RI and q == _WB_RI:                  # WB15/16: pair RIs
            j, run = p_idx, 0
            while j >= 0 and cls[j] == _WB_RI:
                run += 1
                j = prev_base_idx(j - 1)
            if run % 2 == 1:
                continue
        breaks.append(i)
    breaks.append(n)
    return [text[breaks[j]: breaks[j + 1]] for j in range(len(breaks) - 1)]


_ASCII_SIMPLE_RE = re.compile(r"[A-Za-z0-9_]+")


def _uax29_tokens(text: str) -> list[str]:
    """UAX #29 word tokens: segment, keep segments containing an
    alphanumeric. Whitespace always breaks (no WB rule joins across a
    space), so chunks split fast on whitespace and an all-[A-Za-z0-9_]
    chunk — the common case in latin text — is one token by WB5/8/9/
    10/13a/b without running the automaton."""
    out: list[str] = []
    for chunk in text.split():
        if chunk.isascii() and _ASCII_SIMPLE_RE.fullmatch(chunk):
            out.append(chunk)
            continue
        for seg in _uax29_segments(chunk):
            for ch in seg:
                if ch.isalnum():
                    out.append(seg)
                    break
    return out


# ---- dictionary-backed CJK segmentation ------------------------------
# The reference's jieba/lindera tokenizers are dictionary-backed
# segmenters (python/python/lancedb/index.py:111-188). 'jieba' uses the
# installed jieba package (DAG + unigram DP over its frequency dict,
# optional user dict); 'lindera' runs forward maximum matching over a
# bundled Japanese seed lexicon (the reference ships full ipadic via
# the lindera crate; the seed lexicon gives working out-of-the-box
# Japanese, dict_path= supplies a bigger dictionary), falling back to
# character bigrams for out-of-dictionary runs so recall never drops
# below the dictionary-free baseline.

_JIEBA_CACHE: dict = {}
_MM_DICT_CACHE: dict = {}

# bundled Japanese seed lexicon; scheme string stays machine-independent
# ("builtin-ja-seed", not the absolute path) so an index built on one
# host verifies cleanly on another
_BUILTIN_JA_DICT = os.path.join(os.path.dirname(__file__), "data", "ja_seed.txt")
_BUILTIN_JA_SCHEME = "mm-dict:builtin-ja-seed"


def _jieba_tokenizer(dict_path: str | None):
    key = dict_path or ""
    tok = _JIEBA_CACHE.get(key)
    if tok is None:
        import jieba

        tok = jieba.Tokenizer()
        if dict_path:
            tok.load_userdict(dict_path)
        tok.initialize()
        _JIEBA_CACHE[key] = tok
    return tok


def _load_mm_dict(dict_path: str) -> tuple[set, int]:
    """jieba-format dictionary ('word [freq [tag]]' per line) → (set of
    words, max word length) for maximum matching."""
    got = _MM_DICT_CACHE.get(dict_path)
    if got is None:
        words = set()
        max_len = 1
        with open(dict_path, encoding="utf-8") as f:
            for line in f:
                if line.startswith("#"):
                    continue
                w = line.strip().split()
                if w and w[0]:
                    words.add(w[0])
                    max_len = max(max_len, len(w[0]))
        got = (words, min(max_len, 16))
        _MM_DICT_CACHE[dict_path] = got
    return got


def _max_match_cjk(run: str, words: set, max_len: int) -> list[str]:
    """Forward maximum matching; unmatched spans degrade to bigrams."""
    out: list[str] = []
    oov = ""
    i, n = 0, len(run)
    while i < n:
        for ln in range(min(max_len, n - i), 1, -1):
            if run[i : i + ln] in words:
                if oov:
                    out.extend(_emit_cjk(oov, True))
                    oov = ""
                out.append(run[i : i + ln])
                i += ln
                break
        else:
            if run[i] in words:
                if oov:
                    out.extend(_emit_cjk(oov, True))
                    oov = ""
                out.append(run[i])
            else:
                oov += run[i]
            i += 1
    if oov:
        out.extend(_emit_cjk(oov, True))
    return out


_FALLBACK_WARNED: set = set()


def _warn_bigram_fallback(engine: str, reason: str) -> None:
    """Warn ONCE per (engine, reason) when a dictionary engine degrades to
    character bigrams — an index built with the dictionary engine queried
    through the bigram fallback silently mismatches its own postings."""
    key = (engine, reason)
    if key not in _FALLBACK_WARNED:
        _FALLBACK_WARNED.add(key)
        logger.warning(
            "FTS tokenizer %r unavailable (%s); falling back to CJK character "
            "bigrams. Queries against an index built with the dictionary "
            "engine will mis-match its postings — fix the engine or rebuild "
            "the index with base_tokenizer='cjk'.",
            engine, reason,
        )


def effective_cjk_scheme(engine: str, dict_path: str | None) -> str:
    """The segmentation scheme a jieba/lindera base ACTUALLY uses right now
    (persisted into the index config and re-verified at query time)."""
    if engine == "jieba":
        try:
            _jieba_tokenizer(dict_path)
            return "jieba-dict" + (f":{dict_path}" if dict_path else "")
        except Exception as exc:  # jieba missing or dict unreadable
            _warn_bigram_fallback("jieba", repr(exc))
            return "cjk-bigram"
    if not dict_path:
        try:
            _load_mm_dict(_BUILTIN_JA_DICT)
            return _BUILTIN_JA_SCHEME
        except Exception as exc:  # seed lexicon missing/unreadable
            _warn_bigram_fallback("lindera", repr(exc))
            return "cjk-bigram"
    try:
        _load_mm_dict(dict_path)
        return f"mm-dict:{dict_path}"
    except Exception as exc:
        _warn_bigram_fallback("lindera", repr(exc))
        return "cjk-bigram"


def _dict_cjk_tokens(text: str, engine: str, dict_path: str | None) -> list[str]:
    """Segment with a dictionary engine; non-CJK spans use unicode word
    boundaries (matching the reference's jieba/lindera wrappers, which
    delegate latin text to the default pipeline)."""
    if engine == "jieba":
        try:
            tok = _jieba_tokenizer(dict_path)
            return [t for t in tok.lcut(text, HMM=True)
                    if t.strip() and any(ch.isalnum() for ch in t)]
        except Exception as exc:
            _warn_bigram_fallback("jieba", repr(exc))
            return _unicode_tokens(text, cjk_bigrams=True)
    # lindera-style maximum matching (no dict_path → bundled JA seed)
    try:
        words, max_len = _load_mm_dict(dict_path or _BUILTIN_JA_DICT)
    except Exception as exc:
        _warn_bigram_fallback("lindera", repr(exc))
        return _unicode_tokens(text, cjk_bigrams=True)
    out: list[str] = []
    for run in _UNI_WORD_RE.findall(text):
        seg = ""
        cjk_run = ""
        for c in run:
            if _is_cjk(c):
                if seg:
                    out.append(seg)
                    seg = ""
                cjk_run += c
            else:
                if cjk_run:
                    out.extend(_max_match_cjk(cjk_run, words, max_len))
                    cjk_run = ""
                seg += c
        if seg:
            out.append(seg)
        if cjk_run:
            out.extend(_max_match_cjk(cjk_run, words, max_len))
    return out


# ---- multi-language stemming + stop words ----------------------------
# Simplified snowball-style suffix strippers (ordered longest-first,
# stripped only when the remaining stem keeps >= 3 chars). The reference
# delegates to tantivy's full snowball stemmers; these cover the same
# language parameter with lighter rules.
_SUFFIX_RULES: dict[str, list[tuple[str, str]]] = {
    "french": [
        ("issements", ""), ("issement", ""), ("atrices", ""), ("atrice", ""),
        ("ations", ""), ("ation", ""), ("ateurs", ""), ("ateur", ""),
        ("ements", ""), ("ement", ""), ("euses", "eu"), ("euse", "eu"),
        ("ances", ""), ("ance", ""), ("ences", "ent"), ("ence", "ent"),
        ("ités", ""), ("ité", ""), ("ives", "if"), ("ive", "if"),
        ("eaux", "eau"), ("aux", "al"), ("ées", ""), ("ée", ""),
        ("ts", "t"), ("es", ""), ("s", ""), ("e", ""),
    ],
    "german": [
        ("ungen", ""), ("ung", ""), ("heiten", ""), ("heit", ""),
        ("keiten", ""), ("keit", ""), ("isch", ""), ("lich", ""),
        ("erin", ""), ("ern", ""), ("em", ""), ("en", ""), ("er", ""),
        ("es", ""), ("e", ""), ("s", ""),
    ],
    "spanish": [
        ("amientos", ""), ("amiento", ""), ("aciones", ""), ("ación", ""),
        ("adores", ""), ("adora", ""), ("ador", ""), ("idades", ""),
        ("idad", ""), ("mente", ""), ("anzas", ""), ("anza", ""),
        ("ismos", ""), ("ismo", ""), ("ivas", "iv"), ("iva", "iv"),
        ("es", ""), ("os", "o"), ("as", "a"), ("s", ""),
    ],
    "italian": [
        ("azioni", ""), ("azione", ""), ("amenti", ""), ("amento", ""),
        ("mente", ""), ("atori", ""), ("atore", ""), ("ibili", ""),
        ("ibile", ""), ("anze", ""), ("anza", ""), ("iche", "ic"),
        ("ica", "ic"), ("i", ""), ("e", ""), ("o", ""), ("a", ""),
    ],
    "portuguese": [
        ("amentos", ""), ("amento", ""), ("adores", ""), ("ador", ""),
        ("aço~es", ""), ("ações", ""), ("ação", ""), ("idades", ""),
        ("idade", ""), ("mente", ""), ("ismos", ""), ("ismo", ""),
        ("es", ""), ("os", "o"), ("as", "a"), ("s", ""),
    ],
}

FRENCH_STOP_WORDS = frozenset(
    """au aux avec ce ces dans de des du elle en et eux il je la le les leur
    lui ma mais me même mes moi mon ne nos notre nous on ou par pas pour qu
    que qui sa se ses son sur ta te tes toi ton tu un une vos votre vous""".split()
)
GERMAN_STOP_WORDS = frozenset(
    """aber alle als also am an auch auf aus bei bin bis bist da damit das
    dass dein der den des dem die dies dir du ein eine einem einen einer es
    für hat hatte ich ihr im in ist ja kann mein mit nach nicht noch nun nur
    oder sein sich sie sind so über um und uns vom von vor war was wie wir
    zu zum zur""".split()
)
SPANISH_STOP_WORDS = frozenset(
    """al algo ante como con de del desde donde durante el ella ellas ellos
    en entre era es esa ese eso esta este esto fue ha hay la las le les lo
    los muy más mi mis no nos o otra otro para pero por que se sin sobre su
    sus también te tu tus un una uno y ya yo""".split()
)

_STOP_WORDS: dict[str, frozenset] = {
    "english": ENGLISH_STOP_WORDS,
    "french": FRENCH_STOP_WORDS,
    "german": GERMAN_STOP_WORDS,
    "spanish": SPANISH_STOP_WORDS,
}


def _stem_word(w: str, language: str) -> str:
    lang = language.lower()
    if lang == "english":
        return _porter_stem(w)
    rules = _SUFFIX_RULES.get(lang)
    if rules is None:
        return w
    for suf, rep in rules:
        if w.endswith(suf) and len(w) - len(suf) + len(rep) >= 3:
            return w[: -len(suf)] + rep
    return w


@dataclass
class Tokenizer:
    base: str = "simple"  # simple | whitespace | raw | ngram | unicode
    lower_case: bool = True
    stem: bool = True
    remove_stop_words: bool = True
    ascii_folding: bool = True
    max_token_length: int | None = 40
    language: str = "English"
    ngram_min_length: int = 3
    ngram_max_length: int = 3
    prefix_only: bool = False
    dict_path: str | None = None  # user dictionary for jieba/lindera
    # set by FtsIndex.load for indexes persisted before the UAX #29
    # segmenter: keeps querying them with the \w+ segmentation their
    # postings were built with (scheme "unicode") instead of raising
    legacy_unicode: bool = False
    # set by FtsIndex.load for lindera indexes persisted before the
    # bundled Japanese seed lexicon: keeps querying them with the
    # character bigrams their postings were built with
    legacy_bigram: bool = False

    # reference tokenizer names accepted as aliases: icu → unicode
    # word-boundary segmentation (index.py:111-188)
    _ALIASES = {"icu": "unicode"}

    def effective_scheme(self) -> str:
        """The segmentation scheme this tokenizer resolves to RIGHT NOW.

        Persisted into the FTS index config at build and re-verified at
        load so an index built with a dictionary engine is never silently
        queried through the bigram fallback (near-zero recall)."""
        base = self._ALIASES.get(self.base, self.base)
        if base == "lindera" and self.legacy_bigram:
            return "cjk-bigram"
        if base in ("jieba", "lindera"):
            return effective_cjk_scheme(base, self.dict_path)
        if base == "unicode":
            return "unicode" if self.legacy_unicode else "uax29"
        return base

    def tokenize(self, text: str | None) -> list[str]:
        if not text:
            return []
        base = self._ALIASES.get(self.base, self.base)
        if base == "lindera" and self.legacy_bigram:
            toks = _unicode_tokens(
                _accent_fold(text) if self.ascii_folding else text,
                cjk_bigrams=True,
            )
        elif base in ("jieba", "lindera"):
            toks = _dict_cjk_tokens(
                _accent_fold(text) if self.ascii_folding else text,
                base, self.dict_path,
            )
        elif base == "unicode" and not self.legacy_unicode:
            # real ICU behavior: UAX #29 word boundaries (the legacy
            # flag pins pre-uax29 indexes to the \w+ segmentation their
            # postings were built with)
            toks = _uax29_tokens(_accent_fold(text) if self.ascii_folding else text)
        elif base in ("unicode", "cjk"):
            # accent folding keeps non-latin scripts alive
            toks = _unicode_tokens(
                _accent_fold(text) if self.ascii_folding else text,
                cjk_bigrams=base == "cjk",
            )
        else:
            if self.ascii_folding:
                text = _ascii_fold(text)
            if self.base == "raw":
                toks = [text.strip()] if text.strip() else []
            elif self.base == "whitespace":
                toks = _WS_RE.findall(text)
            elif self.base == "ngram":
                return self._ngrams(text)
            else:  # simple
                toks = _WORD_RE.findall(text)
        stops = _STOP_WORDS.get(self.language.lower(), frozenset())
        out = []
        for t in toks:
            if self.lower_case:
                t = t.lower()
            if self.max_token_length and len(t) > self.max_token_length:
                continue
            if self.remove_stop_words and t in stops:
                continue
            if self.stem:
                t = _stem_word(t, self.language)
            if t:
                out.append(t)
        return out

    def _ngrams(self, text: str) -> list[str]:
        t = text.lower() if self.lower_case else text
        t = re.sub(r"\s+", " ", t).strip()
        out = []
        words = t.split(" ")
        for word in words:
            if self.prefix_only:
                for n in range(self.ngram_min_length, self.ngram_max_length + 1):
                    if len(word) >= n:
                        out.append(word[:n])
            else:
                for n in range(self.ngram_min_length, self.ngram_max_length + 1):
                    for i in range(0, len(word) - n + 1):
                        out.append(word[i : i + n])
        return out

    def to_json(self) -> dict:
        return {
            "base": self.base,
            "lower_case": self.lower_case,
            "stem": self.stem,
            "remove_stop_words": self.remove_stop_words,
            "ascii_folding": self.ascii_folding,
            "max_token_length": self.max_token_length,
            "language": self.language,
            "ngram_min_length": self.ngram_min_length,
            "ngram_max_length": self.ngram_max_length,
            "prefix_only": self.prefix_only,
            "dict_path": self.dict_path,
        }

    @staticmethod
    def from_json(d: dict) -> "Tokenizer":
        return Tokenizer(**d)
