"""ctypes loader for the C++ native runtime (native/lancedb_native.cpp).

The repository's C++ source (FTS builder, DAAT BM25 scorers, hash join,
suffix array, varint codecs; a plain C ABI) compiles with g++ at first
use into ``lancedb_tpu_torch/_build/``, under a name that carries a hash
of the source and of the host's CPU (the build targets ``-march=native``),
so neither an edited source nor another machine's build ever loads. Nothing
builds at import time. Every consumer has a pure-Python fallback: without
a compiler the package is slower, not different.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "lancedb_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False


def _host_cpu() -> bytes:
    """The CPU's model and feature flags (what ``-march=native`` compiles for)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        lines = []
    keep = [ln for ln in lines if ln.startswith((b"model name", b"flags", b"Features"))]
    return platform.machine().encode() + b"".join(sorted(set(keep)))


def _so_path() -> str:
    h = hashlib.sha256(_host_cpu())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR, f"liblancedb_native-{h.hexdigest()[:16]}.so")


def _compile(so: str) -> bool:
    """g++ into a file of this process's own, then an atomic rename, so
    processes that build at once never load a half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
        "-march=native", _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except Exception:
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def get_lib() -> ctypes.CDLL | None:
    """The loaded native library, or None if unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        so_path = _so_path() if os.path.exists(_SRC) else None
        if so_path is not None and not os.path.exists(so_path) and not _compile(so_path):
            so_path = None
        if so_path is None:
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(so_path)
        except OSError:
            _load_failed = True
            return None
        # signatures
        i64 = ctypes.c_int64
        p = ctypes.c_void_p
        lib.ldb_fts_build.restype = p
        lib.ldb_fts_build.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(i64), i64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        for name in ("ldb_fts_num_terms", "ldb_fts_num_postings", "ldb_fts_num_positions",
                     "ldb_fts_vocab_bytes", "ldb_fts_num_docs"):
            fn = getattr(lib, name)
            fn.restype = i64
            fn.argtypes = [p]
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(i64)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.ldb_fts_export.restype = None
        lib.ldb_fts_export.argtypes = [
            p, ctypes.c_char_p, i64p, i32p, i64p, i32p, f32p, i64p, i32p, i32p,
        ]
        lib.ldb_fts_free.restype = None
        lib.ldb_fts_free.argtypes = [p]
        lib.ldb_hash_join.restype = None
        lib.ldb_hash_join.argtypes = [
            ctypes.c_char_p, i64p, i64, ctypes.c_char_p, i64p, i64, i64p,
        ]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.ldb_suffix_array.restype = None
        lib.ldb_suffix_array.argtypes = [ctypes.c_char_p, i64, i32p]
        lib.ldb_varint_encode.restype = i64
        lib.ldb_varint_encode.argtypes = [i64p, i64, u8p]
        lib.ldb_varint_decode.restype = i64
        lib.ldb_varint_decode.argtypes = [u8p, i64, i64, i64p]
        lib.ldb_bm25_maxscore_topk.restype = i64
        lib.ldb_bm25_maxscore_topk.argtypes = [
            i64p, i64p, i64p, i32p, f32p, f32p, f32p, i64p, ctypes.c_int32,
            f32p, u8p, i64, ctypes.c_int32, ctypes.c_float,
            ctypes.c_float, i64p, f32p, ctypes.c_int32, ctypes.c_int32,
            i64p, f32p,
        ]
        lib.ldb_bm25_impact_topk.restype = i64
        lib.ldb_bm25_impact_topk.argtypes = [
            i64p, i64p, i64p, i32p, i32p, f32p, ctypes.c_int32, f32p, u8p,
            ctypes.c_int32, ctypes.c_float, i64, i64p, f32p,
        ]
        lib.ldb_bm25_impact2_topk.restype = i64
        lib.ldb_bm25_impact2_topk.argtypes = [
            i64p, i64p, i64p, i32p, f32p, i64p, i64p, f32p, i32p, f32p,
            f32p, u8p, ctypes.c_int32, ctypes.c_float, i64, i64p, f32p,
        ]
        lib.ldb_bm25_and_topk.restype = i64
        lib.ldb_bm25_and_topk.argtypes = [
            i64p, i64p, i64p, i32p, f32p, ctypes.c_int32, f32p, u8p,
            ctypes.c_int32, ctypes.c_float, i64p, f32p,
        ]
        lib.ldb_phrase_topk.restype = i64
        lib.ldb_phrase_topk.argtypes = [
            i64p, i64p, i64p, i64p, i64p, i32p, f32p, ctypes.c_int32, f32p,
            u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_float, i64p, f32p,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def _np_ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def fts_build_native(
    texts: list[str | None],
    *,
    lower_case: bool = True,
    stem: bool = True,
    remove_stop_words: bool = True,
    max_token_length: int | None = 40,
    with_positions: bool = True,
):
    """Build CSR postings in C++. Returns the same tuple shape the
    python builder produces: (vocab list, df, post_offsets, post_docs,
    post_tf, pos_offsets, positions, doc_lens) — or None if the native
    library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    blob_parts = []
    offsets = np.zeros(len(texts) + 1, dtype=np.int64)
    total = 0
    for i, t in enumerate(texts):
        b = (t or "").encode("utf-8", errors="ignore")
        blob_parts.append(b)
        total += len(b)
        offsets[i + 1] = total
    blob = b"".join(blob_parts)
    h = lib.ldb_fts_build(
        blob,
        _np_ptr(offsets, ctypes.c_int64),
        len(texts),
        int(lower_case),
        int(stem),
        int(remove_stop_words),
        int(max_token_length or 0),
        int(with_positions),
    )
    try:
        T = lib.ldb_fts_num_terms(h)
        P = lib.ldb_fts_num_postings(h)
        PP = lib.ldb_fts_num_positions(h)
        VB = lib.ldb_fts_vocab_bytes(h)
        ND = lib.ldb_fts_num_docs(h)
        vocab_buf = ctypes.create_string_buffer(max(int(VB), 1))
        vocab_offsets = np.zeros(T + 1, dtype=np.int64)
        df = np.zeros(T, dtype=np.int32)
        post_offsets = np.zeros(T + 1, dtype=np.int64)
        post_docs = np.zeros(max(P, 1), dtype=np.int32)
        post_tf = np.zeros(max(P, 1), dtype=np.float32)
        doc_lens = np.zeros(max(ND, 1), dtype=np.int32)
        if with_positions:
            pos_offsets = np.zeros(P + 1, dtype=np.int64)
            positions = np.zeros(max(PP, 1), dtype=np.int32)
            pos_ptr = _np_ptr(pos_offsets, ctypes.c_int64)
            positions_ptr = _np_ptr(positions, ctypes.c_int32)
        else:
            pos_offsets = positions = None
            pos_ptr = None
            positions_ptr = None
        lib.ldb_fts_export(
            h, vocab_buf, _np_ptr(vocab_offsets, ctypes.c_int64),
            _np_ptr(df, ctypes.c_int32), _np_ptr(post_offsets, ctypes.c_int64),
            _np_ptr(post_docs, ctypes.c_int32), _np_ptr(post_tf, ctypes.c_float),
            pos_ptr, positions_ptr, _np_ptr(doc_lens, ctypes.c_int32),
        )
        raw = vocab_buf.raw[: int(VB)]
        vocab = [
            raw[vocab_offsets[t] : vocab_offsets[t + 1]].decode("utf-8", errors="ignore")
            for t in range(T)
        ]
        return (
            vocab, df, post_offsets, post_docs[:P], post_tf[:P],
            pos_offsets, positions[:PP] if positions is not None else None,
            doc_lens[:ND],
        )
    finally:
        lib.ldb_fts_free(h)


def hash_join_native(src_keys: list[bytes], tgt_keys: list[bytes]) -> np.ndarray | None:
    """For each target key, the index of the matching source key or -1."""
    lib = get_lib()
    if lib is None:
        return None

    def pack(keys):
        offs = np.zeros(len(keys) + 1, dtype=np.int64)
        total = 0
        for i, k in enumerate(keys):
            total += len(k)
            offs[i + 1] = total
        return b"".join(keys), offs

    src_blob, src_off = pack(src_keys)
    tgt_blob, tgt_off = pack(tgt_keys)
    out = np.empty(len(tgt_keys), dtype=np.int64)
    lib.ldb_hash_join(
        src_blob, _np_ptr(src_off, ctypes.c_int64), len(src_keys),
        tgt_blob, _np_ptr(tgt_off, ctypes.c_int64), len(tgt_keys),
        _np_ptr(out, ctypes.c_int64),
    )
    return out


def suffix_array_native(text: bytes) -> np.ndarray | None:
    """Suffix array of a byte string in C++ (prefix doubling + radix
    sort) — ~20x the numpy doubling loop for FM index builds. Returns
    None when the native library is unavailable or the text exceeds
    int32 addressing."""
    lib = get_lib()
    n = len(text)
    if lib is None or n == 0 or n >= (1 << 31):
        return None
    out = np.zeros(n, dtype=np.int32)
    lib.ldb_suffix_array(text, n, _np_ptr(out, ctypes.c_int32))
    return out.astype(np.int64)


def varint_encode_native(values: np.ndarray) -> bytes | None:
    """Delta+LEB128 encode a sorted int64 array (posting persistence)."""
    lib = get_lib()
    if lib is None:
        return None
    values = np.ascontiguousarray(values, dtype=np.int64)
    out = np.zeros(max(1, len(values) * 10), dtype=np.uint8)
    nb = lib.ldb_varint_encode(
        _np_ptr(values, ctypes.c_int64), len(values), _np_ptr(out, ctypes.c_uint8)
    )
    return out[:nb].tobytes()


def varint_decode_native(data: bytes, count: int) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    out = np.zeros(max(1, count), dtype=np.int64)
    buf = np.frombuffer(data, dtype=np.uint8)
    lib.ldb_varint_decode(
        _np_ptr(buf, ctypes.c_uint8), len(data), count, _np_ptr(out, ctypes.c_int64)
    )
    return out[:count]


def bm25_and_topk_native(
    postings_docs: np.ndarray,
    postings_tf: np.ndarray,
    postings_offsets: np.ndarray,
    qterms: np.ndarray,
    qidf: np.ndarray,
    doc_norm: np.ndarray,
    k: int,
    k1: float,
    dead: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Exact conjunctive (AND) BM25 top-k via DAAT galloping
    intersection (native ldb_bm25_and_topk). qterms has one entry per
    query token (duplicates allowed). Returns (doc_idx, scores) sorted
    descending, or None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None or len(qterms) == 0:
        return None
    postings_docs = np.ascontiguousarray(postings_docs, dtype=np.int64)
    postings_tf = np.ascontiguousarray(postings_tf, dtype=np.int64)
    postings_offsets = np.ascontiguousarray(postings_offsets, dtype=np.int64)
    qterms = np.ascontiguousarray(qterms, dtype=np.int32)
    qidf = np.ascontiguousarray(qidf, dtype=np.float32)
    doc_norm = np.ascontiguousarray(doc_norm, dtype=np.float32)
    dead_ptr = None
    if dead is not None:
        dead = np.ascontiguousarray(dead, dtype=np.uint8)
        dead_ptr = _np_ptr(dead, ctypes.c_uint8)
    out_docs = np.zeros(max(1, k), dtype=np.int64)
    out_scores = np.zeros(max(1, k), dtype=np.float32)
    n = lib.ldb_bm25_and_topk(
        _np_ptr(postings_docs, ctypes.c_int64),
        _np_ptr(postings_tf, ctypes.c_int64),
        _np_ptr(postings_offsets, ctypes.c_int64),
        _np_ptr(qterms, ctypes.c_int32),
        _np_ptr(qidf, ctypes.c_float),
        len(qterms),
        _np_ptr(doc_norm, ctypes.c_float),
        dead_ptr,
        int(k),
        float(k1),
        _np_ptr(out_docs, ctypes.c_int64),
        _np_ptr(out_scores, ctypes.c_float),
    )
    return out_docs[:n], out_scores[:n]


def phrase_topk_native(
    postings_docs: np.ndarray,
    postings_tf: np.ndarray,
    postings_offsets: np.ndarray,
    pos_offsets: np.ndarray,
    positions: np.ndarray,
    qterms: np.ndarray,
    qidf: np.ndarray,
    doc_norm: np.ndarray,
    slop: int,
    k: int,
    k1: float,
    dead: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Exact phrase-match BM25 top-k: DAAT intersection + positional
    window verification in C++ (native ldb_phrase_topk). qterms has one
    entry per phrase token, in phrase order. Returns (doc_idx, scores)
    sorted descending, or None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None or len(qterms) == 0:
        return None
    postings_docs = np.ascontiguousarray(postings_docs, dtype=np.int64)
    postings_tf = np.ascontiguousarray(postings_tf, dtype=np.int64)
    postings_offsets = np.ascontiguousarray(postings_offsets, dtype=np.int64)
    pos_offsets = np.ascontiguousarray(pos_offsets, dtype=np.int64)
    positions = np.ascontiguousarray(positions, dtype=np.int64)
    qterms = np.ascontiguousarray(qterms, dtype=np.int32)
    qidf = np.ascontiguousarray(qidf, dtype=np.float32)
    doc_norm = np.ascontiguousarray(doc_norm, dtype=np.float32)
    dead_ptr = None
    if dead is not None:
        dead = np.ascontiguousarray(dead, dtype=np.uint8)
        dead_ptr = _np_ptr(dead, ctypes.c_uint8)
    out_docs = np.zeros(max(1, k), dtype=np.int64)
    out_scores = np.zeros(max(1, k), dtype=np.float32)
    n = lib.ldb_phrase_topk(
        _np_ptr(postings_docs, ctypes.c_int64),
        _np_ptr(postings_tf, ctypes.c_int64),
        _np_ptr(postings_offsets, ctypes.c_int64),
        _np_ptr(pos_offsets, ctypes.c_int64),
        _np_ptr(positions, ctypes.c_int64),
        _np_ptr(qterms, ctypes.c_int32),
        _np_ptr(qidf, ctypes.c_float),
        len(qterms),
        _np_ptr(doc_norm, ctypes.c_float),
        dead_ptr,
        int(slop),
        int(k),
        float(k1),
        _np_ptr(out_docs, ctypes.c_int64),
        _np_ptr(out_scores, ctypes.c_float),
    )
    return out_docs[:n], out_scores[:n]


def bm25_maxscore_topk_native(
    postings_docs: np.ndarray,
    postings_tf: np.ndarray,
    postings_offsets: np.ndarray,
    qterms: np.ndarray,
    qidf: np.ndarray,
    doc_norm: np.ndarray,
    k: int,
    k1: float,
    dead: np.ndarray | None = None,
    qub: np.ndarray | None = None,
    block_max: np.ndarray | None = None,
    block_offsets: np.ndarray | None = None,
    theta_init: float = 0.0,
    seed_docs: np.ndarray | None = None,
    seed_scores: np.ndarray | None = None,
    n_threads: int = 1,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Exact BM25 top-k via DAAT MaxScore over the CSR postings
    (native ldb_bm25_maxscore_topk). Returns (doc_idx, scores) sorted
    by descending score, or None when the native lib is unavailable.

    qub: cached per-query-term upper bounds (idf folded) — skips the
    per-query full posting scan that dominates on common terms.
    block_max/block_offsets: per-term 128-posting block maxima (raw
    contribution, no idf) enabling block-max skipping.
    theta_init + seed_docs/seed_scores: exact threshold pre-seeding
    from cached top-impact postings (block skipping engages from doc 0;
    seeds backfill ties pruned at exactly theta_init).
    n_threads: doc-range sharding across threads with a shared atomic
    threshold (scales on multicore serving hosts)."""
    lib = get_lib()
    if lib is None or len(qterms) == 0:
        return None
    postings_docs = np.ascontiguousarray(postings_docs, dtype=np.int64)
    postings_tf = np.ascontiguousarray(postings_tf, dtype=np.int64)
    postings_offsets = np.ascontiguousarray(postings_offsets, dtype=np.int64)
    qterms = np.ascontiguousarray(qterms, dtype=np.int32)
    qidf = np.ascontiguousarray(qidf, dtype=np.float32)
    doc_norm = np.ascontiguousarray(doc_norm, dtype=np.float32)
    dead_ptr = None
    if dead is not None:
        dead = np.ascontiguousarray(dead, dtype=np.uint8)
        dead_ptr = _np_ptr(dead, ctypes.c_uint8)
    qub_ptr = None
    if qub is not None:
        qub = np.ascontiguousarray(qub, dtype=np.float32)
        qub_ptr = _np_ptr(qub, ctypes.c_float)
    bmax_ptr = boff_ptr = None
    if block_max is not None and block_offsets is not None:
        block_max = np.ascontiguousarray(block_max, dtype=np.float32)
        block_offsets = np.ascontiguousarray(block_offsets, dtype=np.int64)
        bmax_ptr = _np_ptr(block_max, ctypes.c_float)
        boff_ptr = _np_ptr(block_offsets, ctypes.c_int64)
    seed_docs_ptr = seed_scores_ptr = None
    n_seed = 0
    if seed_docs is not None and seed_scores is not None and len(seed_docs):
        seed_docs = np.ascontiguousarray(seed_docs, dtype=np.int64)
        seed_scores = np.ascontiguousarray(seed_scores, dtype=np.float32)
        seed_docs_ptr = _np_ptr(seed_docs, ctypes.c_int64)
        seed_scores_ptr = _np_ptr(seed_scores, ctypes.c_float)
        n_seed = len(seed_docs)
    out_docs = np.zeros(max(1, k), dtype=np.int64)
    out_scores = np.zeros(max(1, k), dtype=np.float32)
    n = lib.ldb_bm25_maxscore_topk(
        _np_ptr(postings_docs, ctypes.c_int64),
        _np_ptr(postings_tf, ctypes.c_int64),
        _np_ptr(postings_offsets, ctypes.c_int64),
        _np_ptr(qterms, ctypes.c_int32),
        _np_ptr(qidf, ctypes.c_float),
        qub_ptr,
        bmax_ptr,
        boff_ptr,
        len(qterms),
        _np_ptr(doc_norm, ctypes.c_float),
        dead_ptr,
        len(doc_norm),
        int(k),
        float(k1),
        float(theta_init),
        seed_docs_ptr,
        seed_scores_ptr,
        n_seed,
        int(n_threads),
        _np_ptr(out_docs, ctypes.c_int64),
        _np_ptr(out_scores, ctypes.c_float),
    )
    return out_docs[:n], out_scores[:n]


def bm25_impact_topk_native(
    postings_docs: np.ndarray,
    postings_tf: np.ndarray,
    postings_offsets: np.ndarray,
    imp_pos: np.ndarray,
    qterms: np.ndarray,
    qidf: np.ndarray,
    doc_norm: np.ndarray,
    k: int,
    k1: float,
    dead: np.ndarray | None = None,
    max_pops: int = 0,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Exact BM25 top-k via the impact-ordered Threshold Algorithm
    (ldb_bm25_impact_topk) — the common-term fast path: sorted access
    by descending per-term contribution with an upper-bound stop, so
    tied/quantized score distributions terminate after a few hundred
    pops instead of a full million-posting DAAT merge. ``max_pops > 0``
    bounds sorted access; returns None when the stop never fires within
    the budget (caller falls back to the DAAT scorer — 3+ common terms
    decay the summed upper bound too slowly for TA to win)."""
    lib = get_lib()
    if lib is None or len(qterms) == 0:
        return None
    postings_docs = np.ascontiguousarray(postings_docs, dtype=np.int64)
    postings_tf = np.ascontiguousarray(postings_tf, dtype=np.int64)
    postings_offsets = np.ascontiguousarray(postings_offsets, dtype=np.int64)
    imp_pos = np.ascontiguousarray(imp_pos, dtype=np.int32)
    qterms = np.ascontiguousarray(qterms, dtype=np.int32)
    qidf = np.ascontiguousarray(qidf, dtype=np.float32)
    doc_norm = np.ascontiguousarray(doc_norm, dtype=np.float32)
    dead_ptr = None
    if dead is not None:
        dead = np.ascontiguousarray(dead, dtype=np.uint8)
        dead_ptr = _np_ptr(dead, ctypes.c_uint8)
    out_docs = np.zeros(max(1, k), dtype=np.int64)
    out_scores = np.zeros(max(1, k), dtype=np.float32)
    n = lib.ldb_bm25_impact_topk(
        _np_ptr(postings_docs, ctypes.c_int64),
        _np_ptr(postings_tf, ctypes.c_int64),
        _np_ptr(postings_offsets, ctypes.c_int64),
        _np_ptr(imp_pos, ctypes.c_int32),
        _np_ptr(qterms, ctypes.c_int32),
        _np_ptr(qidf, ctypes.c_float),
        len(qterms),
        _np_ptr(doc_norm, ctypes.c_float),
        dead_ptr,
        int(k),
        float(k1),
        int(max_pops),
        _np_ptr(out_docs, ctypes.c_int64),
        _np_ptr(out_scores, ctypes.c_float),
    )
    if n < 0:  # pop budget exhausted before the upper-bound stop fired
        return None
    return out_docs[:n], out_scores[:n]


def bm25_impact2_topk_native(
    postings_docs: np.ndarray,
    postings_tf: np.ndarray,
    postings_offsets: np.ndarray,
    strat_docs: np.ndarray,
    strat_contrib: np.ndarray,
    strat_starts: np.ndarray,
    strat_term_off: np.ndarray,
    strat_ub: np.ndarray,
    qterms: np.ndarray,
    qidf: np.ndarray,
    doc_norm: np.ndarray,
    k: int,
    k1: float,
    dead: np.ndarray | None = None,
    max_work: int = 1 << 21,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Exact 2-term BM25 top-k via stratified pair enumeration
    (ldb_bm25_impact2_topk): per-term contribution strata intersect by
    galloping merge in descending joint-upper-bound order — the common-
    term worst case converges after touching only the thin high strata
    instead of the full posting mass. Returns None when the native lib
    is absent, the terms don't route (an empty term), or the work
    budget trips first (rarely co-occurring terms — the caller falls
    back to the DAAT scorer)."""
    lib = get_lib()
    if lib is None or len(qterms) != 2:
        return None
    postings_docs = np.ascontiguousarray(postings_docs, dtype=np.int64)
    postings_tf = np.ascontiguousarray(postings_tf, dtype=np.int64)
    postings_offsets = np.ascontiguousarray(postings_offsets, dtype=np.int64)
    strat_docs = np.ascontiguousarray(strat_docs, dtype=np.int32)
    strat_contrib = np.ascontiguousarray(strat_contrib, dtype=np.float32)
    strat_starts = np.ascontiguousarray(strat_starts, dtype=np.int64)
    strat_term_off = np.ascontiguousarray(strat_term_off, dtype=np.int64)
    strat_ub = np.ascontiguousarray(strat_ub, dtype=np.float32)
    qterms = np.ascontiguousarray(qterms, dtype=np.int32)
    qidf = np.ascontiguousarray(qidf, dtype=np.float32)
    doc_norm = np.ascontiguousarray(doc_norm, dtype=np.float32)
    dead_ptr = None
    if dead is not None:
        dead = np.ascontiguousarray(dead, dtype=np.uint8)
        dead_ptr = _np_ptr(dead, ctypes.c_uint8)
    out_docs = np.zeros(max(1, k), dtype=np.int64)
    out_scores = np.zeros(max(1, k), dtype=np.float32)
    n = lib.ldb_bm25_impact2_topk(
        _np_ptr(postings_docs, ctypes.c_int64),
        _np_ptr(postings_tf, ctypes.c_int64),
        _np_ptr(postings_offsets, ctypes.c_int64),
        _np_ptr(strat_docs, ctypes.c_int32),
        _np_ptr(strat_contrib, ctypes.c_float),
        _np_ptr(strat_starts, ctypes.c_int64),
        _np_ptr(strat_term_off, ctypes.c_int64),
        _np_ptr(strat_ub, ctypes.c_float),
        _np_ptr(qterms, ctypes.c_int32),
        _np_ptr(qidf, ctypes.c_float),
        _np_ptr(doc_norm, ctypes.c_float),
        dead_ptr,
        int(k),
        float(k1),
        int(max_work),
        _np_ptr(out_docs, ctypes.c_int64),
        _np_ptr(out_scores, ctypes.c_float),
    )
    if n < 0:  # work budget exhausted (or unroutable): DAAT fallback
        return None
    return out_docs[:n], out_scores[:n]
