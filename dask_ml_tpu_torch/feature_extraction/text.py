"""Text feature extraction: HashingVectorizer, FeatureHasher,
CountVectorizer.

Counterpart of ``dask_ml_tpu/feature_extraction/text.py``, which wraps
scikit-learn's vectorizers; the port writes its own, since the card's
machine has no scikit-learn, and gives the same CSR matrices (indices,
values, shape) on the same documents. Tokenizing is Python ``re`` as in
scikit-learn: lowercasing, ``strip_accents`` ("ascii", "unicode" or a
callable), the default ``token_pattern``, ``stop_words`` (None,
"english", the port's copy of scikit-learn's 318 ``ENGLISH_STOP_WORDS``,
or a collection) removed before ``ngram_range`` word n-grams, and
``analyzer`` "word", "char", "char_wb" or a callable. Hashing is the
host library ``csrc/text_hash.cpp`` (built like the block reader,
``ops/_build.py``): signed MurmurHash3 x86_32 with seed 0, the column
``abs(h) % n_features``, the sign of h when ``alternate_sign``,
duplicates summed (``sum_duplicates``); then ``binary`` and ``norm``
(l1, l2, as scikit-learn's in-place row normalization, in the same
library), in ``dtype``.

The vectorizers' output streams: a CSR corpus, or the ``SparseBlocks``
of ``transform_sparse``, goes straight to any streamed fit, which moves
its nonzeros to the card block by block (``parallel/streaming.py``).
``to_sharded_dense`` is the small-corpus shortcut, refused with the
typed ``DenseBudgetExceeded`` past ``config.to_dense_byte_budget``.
"""

from __future__ import annotations

import ctypes
import os
import re
import threading
import unicodedata
from collections import Counter
from functools import partial

import numpy as np
import scipy.sparse as sp

from ..base import BaseEstimator, TransformerMixin
from ..parallel.sharded import ShardedArray, as_sharded

__all__ = ["HashingVectorizer", "FeatureHasher", "CountVectorizer",
           "to_sharded_dense", "DenseBudgetExceeded", "ENGLISH_STOP_WORDS",
           "murmurhash3_32"]

# scikit-learn's English stop list (sklearn/feature_extraction/
# _stop_words.py), copied
ENGLISH_STOP_WORDS = frozenset((
    'a', 'about', 'above', 'across', 'after', 'afterwards', 'again',
    'against', 'all', 'almost', 'alone', 'along', 'already', 'also',
    'although', 'always', 'am', 'among', 'amongst', 'amoungst', 'amount',
    'an', 'and', 'another', 'any', 'anyhow', 'anyone', 'anything', 'anyway',
    'anywhere', 'are', 'around', 'as', 'at', 'back', 'be', 'became',
    'because', 'become', 'becomes', 'becoming', 'been', 'before',
    'beforehand', 'behind', 'being', 'below', 'beside', 'besides', 'between',
    'beyond', 'bill', 'both', 'bottom', 'but', 'by', 'call', 'can', 'cannot',
    'cant', 'co', 'con', 'could', 'couldnt', 'cry', 'de', 'describe',
    'detail', 'do', 'done', 'down', 'due', 'during', 'each', 'eg', 'eight',
    'either', 'eleven', 'else', 'elsewhere', 'empty', 'enough', 'etc', 'even',
    'ever', 'every', 'everyone', 'everything', 'everywhere', 'except', 'few',
    'fifteen', 'fifty', 'fill', 'find', 'fire', 'first', 'five', 'for',
    'former', 'formerly', 'forty', 'found', 'four', 'from', 'front', 'full',
    'further', 'get', 'give', 'go', 'had', 'has', 'hasnt', 'have', 'he',
    'hence', 'her', 'here', 'hereafter', 'hereby', 'herein', 'hereupon',
    'hers', 'herself', 'him', 'himself', 'his', 'how', 'however', 'hundred',
    'i', 'ie', 'if', 'in', 'inc', 'indeed', 'interest', 'into', 'is', 'it',
    'its', 'itself', 'keep', 'last', 'latter', 'latterly', 'least', 'less',
    'ltd', 'made', 'many', 'may', 'me', 'meanwhile', 'might', 'mill', 'mine',
    'more', 'moreover', 'most', 'mostly', 'move', 'much', 'must', 'my',
    'myself', 'name', 'namely', 'neither', 'never', 'nevertheless', 'next',
    'nine', 'no', 'nobody', 'none', 'noone', 'nor', 'not', 'nothing', 'now',
    'nowhere', 'of', 'off', 'often', 'on', 'once', 'one', 'only', 'onto',
    'or', 'other', 'others', 'otherwise', 'our', 'ours', 'ourselves', 'out',
    'over', 'own', 'part', 'per', 'perhaps', 'please', 'put', 'rather', 're',
    'same', 'see', 'seem', 'seemed', 'seeming', 'seems', 'serious', 'several',
    'she', 'should', 'show', 'side', 'since', 'sincere', 'six', 'sixty', 'so',
    'some', 'somehow', 'someone', 'something', 'sometime', 'sometimes',
    'somewhere', 'still', 'such', 'system', 'take', 'ten', 'than', 'that',
    'the', 'their', 'them', 'themselves', 'then', 'thence', 'there',
    'thereafter', 'thereby', 'therefore', 'therein', 'thereupon', 'these',
    'they', 'thick', 'thin', 'third', 'this', 'those', 'though', 'three',
    'through', 'throughout', 'thru', 'thus', 'to', 'together', 'too', 'top',
    'toward', 'towards', 'twelve', 'twenty', 'two', 'un', 'under', 'until',
    'up', 'upon', 'us', 'very', 'via', 'was', 'we', 'well', 'were', 'what',
    'whatever', 'when', 'whence', 'whenever', 'where', 'whereafter',
    'whereas', 'whereby', 'wherein', 'whereupon', 'wherever', 'whether',
    'which', 'while', 'whither', 'who', 'whoever', 'whole', 'whom', 'whose',
    'why', 'will', 'with', 'within', 'without', 'would', 'yet', 'you', 'your',
    'yours', 'yourself', 'yourselves',
))


class DenseBudgetExceeded(ValueError):
    """A one-shot dense form of a sparse corpus would pass
    ``config.to_dense_byte_budget``: feed the sparse matrix (or
    ``transform_sparse``'s output) to a streamed fit instead."""


# -- the host library -------------------------------------------------------

_lock = threading.Lock()
_lib = None


def _library():
    global _lib
    with _lock:
        if _lib is None:
            from ..ops import _build

            lib = _build.load("text_hash")
            lib.th_murmur3_32.restype = ctypes.c_int32
            lib.th_murmur3_32.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                          ctypes.c_uint32]
            lib.th_hash_tokens.restype = ctypes.c_int64
            lib.th_hash_tokens.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int32]
            for name in ("th_normalize_f32", "th_normalize_f64"):
                fn = getattr(lib, name)
                fn.restype = None
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int64, ctypes.c_int32]
            _lib = lib
        return _lib


def murmurhash3_32(key, seed=0, positive=False):
    """MurmurHash3 x86_32 of a str (UTF-8) or bytes key, signed unless
    ``positive`` (scikit-learn's ``murmurhash3_32`` for one key)."""
    if isinstance(key, str):
        key = key.encode("utf-8")
    h = _library().th_murmur3_32(key, len(key), int(seed) & 0xFFFFFFFF)
    return h & 0xFFFFFFFF if positive else h


def _hash_tokens(tokens, n_features):
    """(cols int32, signs int8) of a list of str or bytes tokens, hashed
    in one call of the library. The tokens travel as one buffer with NUL
    separators; a token that holds a NUL takes the per-token encoding."""
    n = len(tokens)
    cols = np.empty(n, np.int32)
    signs = np.empty(n, np.int8)
    if not n:
        return cols, signs
    try:
        joined = "\x00".join(tokens)      # raises on a bytes token
    except TypeError:
        joined = None
    buf = joined.encode("utf-8") if joined is not None and \
        joined.count("\x00") == n - 1 else None
    if buf is None:
        parts = [t.encode("utf-8") if isinstance(t, str) else bytes(t)
                 for t in tokens]
        if any(b"\x00" in p for p in parts):
            for i, p in enumerate(parts):
                h = _library().th_murmur3_32(p, len(p), 0)
                cols[i] = ((2147483647 - (n_features - 1)) % n_features
                           if h == -2 ** 31 else abs(h) % n_features)
                signs[i] = 1 if h >= 0 else -1
            return cols, signs
        buf = b"\x00".join(parts)
    got = _library().th_hash_tokens(
        buf, len(buf), n, int(n_features), cols.ctypes.data,
        signs.ctypes.data, min(os.cpu_count() or 1, 8))
    if got != n:
        raise RuntimeError(f"text_hash found {got} tokens, not {n}")
    return cols, signs


def _normalize(X, norm):
    """scikit-learn's ``normalize(X, norm, copy=False)`` of a CSR matrix
    in place (l1, l2)."""
    if norm is None:
        return X
    if norm not in ("l1", "l2"):
        raise ValueError(f"'{norm}' is not a supported norm")
    if X.dtype not in (np.float32, np.float64):
        X = X.astype(np.float64)
    indptr = np.ascontiguousarray(X.indptr, np.int64)
    fn = (_library().th_normalize_f32 if X.dtype == np.float32
          else _library().th_normalize_f64)
    fn(X.data.ctypes.data, indptr.ctypes.data, X.shape[0],
       1 if norm == "l1" else 2)
    return X


# -- analyzers (scikit-learn's _VectorizerMixin, in the same order) ---------

_WHITE_SPACES = re.compile(r"\s\s+")


def strip_accents_unicode(s):
    try:
        s.encode("ASCII", errors="strict")
        return s
    except UnicodeEncodeError:
        normalized = unicodedata.normalize("NFKD", s)
        return "".join(c for c in normalized if not unicodedata.combining(c))


def strip_accents_ascii(s):
    nkfd_form = unicodedata.normalize("NFKD", s)
    return nkfd_form.encode("ASCII", "ignore").decode("ASCII")


def _preprocess(doc, accent_function=None, lower=False):
    if lower:
        doc = doc.lower()
    if accent_function is not None:
        doc = accent_function(doc)
    return doc


def _check_stop_list(stop):
    if stop == "english":
        return ENGLISH_STOP_WORDS
    if isinstance(stop, str):
        raise ValueError(f"not a built-in stop list: {stop}")
    if stop is None:
        return None
    return frozenset(stop)


class _VectorizerMixin:
    """Preprocessing, tokenizing and n-grams: the steps and order of
    scikit-learn's ``_VectorizerMixin``."""

    def decode(self, doc):
        if self.input == "filename":
            with open(doc, "rb") as fh:
                doc = fh.read()
        elif self.input == "file":
            doc = doc.read()
        if isinstance(doc, bytes):
            doc = doc.decode(self.encoding, self.decode_error)
        if doc is np.nan:
            raise ValueError("np.nan is an invalid document, expected byte "
                             "or unicode string.")
        return doc

    def _word_ngrams(self, tokens, stop_words=None):
        if stop_words is not None:
            tokens = [w for w in tokens if w not in stop_words]
        min_n, max_n = self.ngram_range
        if max_n != 1:
            original = tokens
            if min_n == 1:
                tokens = list(original)
                min_n += 1
            else:
                tokens = []
            n_orig = len(original)
            for n in range(min_n, min(max_n + 1, n_orig + 1)):
                for i in range(n_orig - n + 1):
                    tokens.append(" ".join(original[i:i + n]))
        return tokens

    def _char_ngrams(self, text):
        text = _WHITE_SPACES.sub(" ", text)
        text_len = len(text)
        min_n, max_n = self.ngram_range
        if min_n == 1:
            ngrams = list(text)
            min_n += 1
        else:
            ngrams = []
        for n in range(min_n, min(max_n + 1, text_len + 1)):
            for i in range(text_len - n + 1):
                ngrams.append(text[i:i + n])
        return ngrams

    def _char_wb_ngrams(self, text):
        text = _WHITE_SPACES.sub(" ", text)
        min_n, max_n = self.ngram_range
        ngrams = []
        for w in text.split():
            w = " " + w + " "
            w_len = len(w)
            for n in range(min_n, max_n + 1):
                offset = 0
                ngrams.append(w[offset:offset + n])
                while offset + n < w_len:
                    offset += 1
                    ngrams.append(w[offset:offset + n])
                if offset == 0:  # a short word (w_len < n) only once
                    break
        return ngrams

    def build_preprocessor(self):
        if self.preprocessor is not None:
            return self.preprocessor
        if not self.strip_accents:
            strip = None
        elif callable(self.strip_accents):
            strip = self.strip_accents
        elif self.strip_accents == "ascii":
            strip = strip_accents_ascii
        elif self.strip_accents == "unicode":
            strip = strip_accents_unicode
        else:
            raise ValueError(
                f'Invalid value for "strip_accents": {self.strip_accents}')
        return partial(_preprocess, accent_function=strip,
                       lower=self.lowercase)

    def build_tokenizer(self):
        if self.tokenizer is not None:
            return self.tokenizer
        pattern = re.compile(self.token_pattern)
        if pattern.groups > 1:
            raise ValueError("More than 1 capturing group in token pattern. "
                             "Only a single group should be captured.")
        return pattern.findall

    def get_stop_words(self):
        return _check_stop_list(self.stop_words)

    def build_analyzer(self):
        """doc -> its list of features."""
        min_n, max_n = self.ngram_range
        if min_n > max_n:
            raise ValueError(
                f"Invalid value for ngram_range={self.ngram_range} lower "
                "boundary larger than the upper boundary.")
        decode = self.decode
        if callable(self.analyzer):
            analyzer = self.analyzer
            return lambda doc: analyzer(decode(doc))
        preprocess = self.build_preprocessor()
        if self.analyzer == "char":
            ngrams = self._char_ngrams
            return lambda doc: ngrams(preprocess(decode(doc)))
        if self.analyzer == "char_wb":
            ngrams = self._char_wb_ngrams
            return lambda doc: ngrams(preprocess(decode(doc)))
        if self.analyzer == "word":
            stop_words = self.get_stop_words()
            tokenize = self.build_tokenizer()
            if stop_words is None and self.ngram_range == (1, 1):
                return lambda doc: tokenize(preprocess(decode(doc)))
            ngrams = self._word_ngrams
            return lambda doc: ngrams(tokenize(preprocess(decode(doc))),
                                      stop_words)
        raise ValueError(
            f"{self.analyzer} is not a valid tokenization scheme/analyzer")


def _documents(raw_documents):
    if isinstance(raw_documents, str):
        raise ValueError("Iterable over raw text documents expected, string "
                         "object received.")
    return raw_documents if isinstance(raw_documents, (list, np.ndarray)) \
        else list(raw_documents)


def _blocks(docs, block_size=10_000):
    for i in range(0, len(docs), block_size):
        yield docs[i:i + block_size]


def _hashed_csr(features, counts, n_features, dtype, alternate_sign,
                values=None):
    """The CSR matrix of hashed features: ``features`` of every row in
    order, ``counts`` per row, each feature's value (1, or ``values``)
    times its sign when ``alternate_sign``; duplicates summed, indices
    sorted (scikit-learn's FeatureHasher.transform)."""
    cols, signs = _hash_tokens(features, n_features)
    vals = np.ones(len(cols)) if values is None else np.asarray(
        values, np.float64)
    if alternate_sign:
        vals = vals * signs
    indptr = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    if indptr[-1] <= np.iinfo(np.int32).max:
        indptr = indptr.astype(np.int32)
    X = sp.csr_matrix((vals.astype(dtype), cols, indptr),
                      shape=(len(counts), int(n_features)), dtype=dtype)
    X.sum_duplicates()
    return X


def to_sharded_dense(csr, device=None, dtype=np.float32) -> ShardedArray:
    """A small sparse corpus dense on the device; one past
    ``config.to_dense_byte_budget`` raises ``DenseBudgetExceeded`` (a
    streamed fit takes the sparse matrix a block at a time)."""
    from ..config import get_config

    n, d = int(csr.shape[0]), int(csr.shape[1])
    nbytes = n * d * np.dtype(dtype).itemsize
    budget = int(get_config().to_dense_byte_budget)
    if budget > 0 and nbytes > budget:
        raise DenseBudgetExceeded(
            f"densifying a {n} x {d} sparse corpus needs {nbytes >> 20} "
            f"MiB > config.to_dense_byte_budget ({budget >> 20} MiB); "
            "pass the sparse matrix straight to a streamed fit (it moves "
            "one block's nonzeros at a time), or raise the budget")
    from ..parallel.streaming import _slice_dense

    return as_sharded(_slice_dense(csr, 0, n, dtype), device=device)


class HashingVectorizer(_VectorizerMixin, TransformerMixin, BaseEstimator):
    """Ref: dask_ml/feature_extraction/text.py::HashingVectorizer."""

    def __init__(self, input="content", encoding="utf-8",
                 decode_error="strict", strip_accents=None, lowercase=True,
                 preprocessor=None, tokenizer=None, stop_words=None,
                 token_pattern=r"(?u)\b\w\w+\b", ngram_range=(1, 1),
                 analyzer="word", n_features=2 ** 20, binary=False,
                 norm="l2", alternate_sign=True, dtype=np.float64):
        self.input = input
        self.encoding = encoding
        self.decode_error = decode_error
        self.strip_accents = strip_accents
        self.lowercase = lowercase
        self.preprocessor = preprocessor
        self.tokenizer = tokenizer
        self.stop_words = stop_words
        self.token_pattern = token_pattern
        self.ngram_range = ngram_range
        self.analyzer = analyzer
        self.n_features = n_features
        self.binary = binary
        self.norm = norm
        self.alternate_sign = alternate_sign
        self.dtype = dtype

    def fit(self, raw_documents, y=None):
        return self  # stateless

    def _transform_block(self, docs, analyze):
        features, counts = [], []
        for doc in docs:
            toks = analyze(doc)
            counts.append(len(toks))
            features.extend(toks)
        X = _hashed_csr(features, counts, self.n_features, self.dtype,
                        self.alternate_sign)
        if self.binary:
            X.data.fill(1)
        return _normalize(X, self.norm)

    def transform(self, raw_documents):
        docs = _documents(raw_documents)
        return self._transform_block(docs, self.build_analyzer())

    def transform_blocks(self, raw_documents, block_size=10_000):
        """Per-block CSR matrices of ``block_size`` documents, never the
        whole corpus at once."""
        docs = _documents(raw_documents)
        analyze = self.build_analyzer()
        for b in _blocks(docs, block_size):
            yield self._transform_block(b, analyze)

    def transform_sparse(self, raw_documents, block_size=10_000):
        """The corpus as a ``SparseBlocks`` view over the per-block CSR
        matrices: a streamed fit takes it as it is, without the
        ``sp.vstack`` copy of ``transform``."""
        from ..parallel.streaming import SparseBlocks

        return SparseBlocks(
            list(self.transform_blocks(raw_documents, block_size)))

    def fit_transform(self, raw_documents, y=None):
        return self.transform(raw_documents)


class FeatureHasher(TransformerMixin, BaseEstimator):
    """Ref: dask_ml/feature_extraction/text.py::FeatureHasher.
    ``input_type`` "dict" (name -> value; a str value v hashes
    "name=v" with value 1), "pair" ((name, value) pairs) or "string"
    (names, value 1); zero values are skipped."""

    def __init__(self, n_features=2 ** 20, input_type="dict",
                 dtype=np.float64, alternate_sign=True):
        self.n_features = n_features
        self.input_type = input_type
        self.dtype = dtype
        self.alternate_sign = alternate_sign

    def fit(self, X=None, y=None):
        return self

    def transform(self, raw_X):
        if self.input_type not in ("dict", "pair", "string"):
            raise ValueError(
                f"input_type must be 'dict', 'pair' or 'string', got "
                f"{self.input_type!r}")
        features, values, counts = [], [], []
        for x in raw_X:
            if self.input_type == "dict":
                items = x.items()
            elif self.input_type == "string":
                if isinstance(x, str):
                    raise ValueError(
                        "Samples can not be a single string. The input must "
                        "be an iterable over iterables of strings.")
                items = ((f, 1) for f in x)
            else:
                items = x
            c = 0
            for f, v in items:
                if isinstance(v, str):
                    f = f"{f}={v}"
                    v = 1
                if v == 0:
                    continue
                if not isinstance(f, (str, bytes)):
                    raise TypeError("feature names must be strings")
                features.append(f)
                values.append(v)
                c += 1
            counts.append(c)
        if not counts:
            raise ValueError("Cannot vectorize empty sequence.")
        return _hashed_csr(features, counts, self.n_features, self.dtype,
                           self.alternate_sign, values)

    def fit_transform(self, raw_X, y=None):
        return self.transform(raw_X)


class CountVectorizer(_VectorizerMixin, TransformerMixin, BaseEstimator):
    """Ref: dask_ml/feature_extraction/text.py::CountVectorizer: with a
    given ``vocabulary`` the transform counts it; else the vocabulary is
    the corpus's terms with the corpus-wide document and term
    frequencies, pruned by scikit-learn's rules (min_df/max_df on
    document frequency, max_features by term frequency, ties
    alphabetical; the removed terms in ``stop_words_``), indices in
    sorted order."""

    def __init__(self, input="content", encoding="utf-8",
                 decode_error="strict", strip_accents=None, lowercase=True,
                 preprocessor=None, tokenizer=None, stop_words=None,
                 token_pattern=r"(?u)\b\w\w+\b", ngram_range=(1, 1),
                 analyzer="word", max_df=1.0, min_df=1, max_features=None,
                 vocabulary=None, binary=False, dtype=np.int64):
        self.input = input
        self.encoding = encoding
        self.decode_error = decode_error
        self.strip_accents = strip_accents
        self.lowercase = lowercase
        self.preprocessor = preprocessor
        self.tokenizer = tokenizer
        self.stop_words = stop_words
        self.token_pattern = token_pattern
        self.ngram_range = ngram_range
        self.analyzer = analyzer
        self.max_df = max_df
        self.min_df = min_df
        self.max_features = max_features
        self.vocabulary = vocabulary
        self.binary = binary
        self.dtype = dtype

    def fit(self, raw_documents, y=None):
        self.fit_transform(raw_documents)
        return self

    def _build_vocabulary(self, docs):
        analyze = self.build_analyzer()
        df, tf = Counter(), Counter()
        n_docs = 0
        for doc in docs:
            terms = Counter(analyze(doc))
            df.update(terms.keys())
            tf.update(terms)
            n_docs += 1
        if not df:
            raise ValueError("empty vocabulary; perhaps the documents only "
                             "contain stop words")
        min_c = (self.min_df if isinstance(self.min_df, (int, np.integer))
                 else self.min_df * n_docs)
        max_c = (self.max_df if isinstance(self.max_df, (int, np.integer))
                 else self.max_df * n_docs)
        if max_c < min_c:
            raise ValueError("max_df corresponds to < documents than min_df")
        kept = {t for t, c in df.items() if min_c <= c <= max_c}
        removed = set(df) - kept
        if self.max_features is not None and len(kept) > self.max_features:
            ranked = sorted(kept, key=lambda t: (-tf[t], t))
            cut = set(ranked[int(self.max_features):])
            removed |= cut
            kept -= cut
        if not kept:
            raise ValueError("After pruning, no terms remain. Try a lower "
                             "min_df or a higher max_df.")
        self.stop_words_ = removed
        return {t: i for i, t in enumerate(sorted(kept))}

    def fit_transform(self, raw_documents, y=None):
        docs = _documents(raw_documents)
        if self.vocabulary is not None:
            vocab = self.vocabulary
            if not isinstance(vocab, dict):
                vocab = {t: i for i, t in enumerate(vocab)}
        else:
            vocab = self._build_vocabulary(docs)
        self.vocabulary_ = vocab
        return self.transform(docs)

    def transform(self, raw_documents):
        if not hasattr(self, "vocabulary_"):
            if self.vocabulary is None:
                raise ValueError("CountVectorizer is not fitted")
            self.vocabulary_ = (
                self.vocabulary if isinstance(self.vocabulary, dict)
                else {t: i for i, t in enumerate(self.vocabulary)})
        vocab = self.vocabulary_
        analyze = self.build_analyzer()
        j_indices, values, indptr = [], [], [0]
        for doc in _documents(raw_documents):
            counter = {}
            for feature in analyze(doc):
                idx = vocab.get(feature)
                if idx is not None:
                    counter[idx] = counter.get(idx, 0) + 1
            j_indices.extend(counter.keys())
            values.extend(counter.values())
            indptr.append(len(j_indices))
        X = sp.csr_matrix(
            (np.asarray(values, np.intc), np.asarray(j_indices, np.int32),
             np.asarray(indptr, np.int32)),
            shape=(len(indptr) - 1, len(vocab)), dtype=self.dtype)
        X.sort_indices()
        if self.binary:
            X.data.fill(1)
        return X

    def get_feature_names_out(self, input_features=None):
        return np.asarray(sorted(self.vocabulary_, key=self.vocabulary_.get),
                          dtype=object)
