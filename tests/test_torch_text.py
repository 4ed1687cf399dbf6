"""The port's text vectorizers against dask_ml_tpu's (scikit-learn's
vectorizers inside) on a seeded corpus with unicode, accents, mixed case
and whitespace runs: the same CSR matrices, indices, values, dtype and
shape, bit for bit, across ``strip_accents``, ``ngram_range`` (1, 2),
English stop words, ``analyzer`` word/char/char_wb, every ``norm``,
``binary`` and both signs; CountVectorizer's vocabulary and pruned
terms. The hashing library's MurmurHash3 against
``sklearn.utils.murmurhash3_32`` on 10,000 strings. Only the tests import
scikit-learn."""

import numpy as np
import pytest
import scipy.sparse as sp

from dask_ml_tpu.feature_extraction import text as J
from dask_ml_tpu_torch import config, convert
from dask_ml_tpu_torch.feature_extraction import text as T
from dask_ml_tpu_torch.linear_model import SGDClassifier
from dask_ml_tpu_torch.parallel.streaming import SparseBlocks

_WORDS = ["Café", "naïve", "the", "and", "résumé", "Zürich", "über", "data",
          "TPU", "GPU", "a", "of", "straße", "ÉCOLE", "x1", "hello", "World",
          "is", "not", "über-cool", "ﬁne", "日本語", "テキスト", "don't", "U.S.A"]


def _docs(seed=0, n=300):
    rng = np.random.RandomState(seed)
    return [" ".join(rng.choice(_WORDS, rng.randint(0, 30)))
            + ("\n\t  tail" if i % 7 == 0 else "") for i in range(n)]


DOCS = _docs()


def _same(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


@pytest.mark.parametrize("kw", [
    {}, {"n_features": 2 ** 10}, {"strip_accents": "ascii"},
    {"strip_accents": "unicode", "lowercase": False},
    {"ngram_range": (1, 2), "stop_words": "english"},
    {"norm": "l1"}, {"norm": None, "binary": True},
    {"alternate_sign": False, "n_features": 64},
    {"analyzer": "char", "ngram_range": (2, 4), "n_features": 2 ** 12},
    {"analyzer": "char_wb", "ngram_range": (1, 3)},
    {"dtype": np.float32, "ngram_range": (2, 3)},
    {"dtype": np.float32, "norm": "l1", "stop_words": ["the", "of"]},
], ids=str)
def test_hashing_vectorizer_matches_jax(kw):
    _same(T.HashingVectorizer(**kw).transform(DOCS),
          J.HashingVectorizer(**kw).transform(DOCS))


@pytest.mark.parametrize("kw", [
    {}, {"ngram_range": (1, 2), "stop_words": "english",
         "strip_accents": "unicode"},
    {"min_df": 2, "max_df": 0.9, "max_features": 10},
    {"binary": True, "analyzer": "char_wb", "ngram_range": (2, 2)},
], ids=str)
def test_count_vectorizer_matches_jax(kw):
    j, t = J.CountVectorizer(**kw), T.CountVectorizer(**kw)
    _same(t.fit_transform(DOCS), j.fit_transform(DOCS))
    assert t.vocabulary_ == j.vocabulary_
    assert t.stop_words_ == j.stop_words_
    np.testing.assert_array_equal(t.get_feature_names_out(),
                                  j.get_feature_names_out())
    _same(t.transform(DOCS[:40]), j.transform(DOCS[:40]))


def test_feature_hasher_matches_jax():
    rng = np.random.RandomState(1)
    dicts = ([{"a": 1.5, "b": "x", "c": 0, "d": -2}] * 3
             + [{f"w{i}": float(i) for i in range(rng.randint(6))}
                for _ in range(20)])
    for kw in ({}, {"n_features": 16, "alternate_sign": False},
               {"dtype": np.float32}):
        _same(T.FeatureHasher(**kw).transform(dicts),
              J.FeatureHasher(**kw).transform(dicts))
    strings = [["a", "b", "a"], ["c"], [], ["über", "a"]]
    _same(T.FeatureHasher(input_type="string").transform(strings),
          J.FeatureHasher(input_type="string").transform(strings))
    pairs = [[("a", 2.0), ("b", 0.5)], [("a", -1.0)]]
    _same(T.FeatureHasher(input_type="pair").transform(pairs),
          J.FeatureHasher(input_type="pair").transform(pairs))


def test_murmurhash_matches_sklearn():
    from sklearn.utils import murmurhash3_32

    rng = np.random.RandomState(2)
    keys = ["".join(chr(c) for c in rng.randint(1, 0x3000,
                                                size=rng.randint(0, 24)))
            for _ in range(10_000)]
    assert [T.murmurhash3_32(k) for k in keys] == \
        [murmurhash3_32(k) for k in keys]
    assert [T.murmurhash3_32(k, positive=True) for k in keys[:50]] == \
        [murmurhash3_32(k, positive=True) for k in keys[:50]]
    # the batch path: tokens holding NUL take the per-token encoding
    toks = ["a\x00b", "abc", ""]
    cols, signs = T._hash_tokens(toks, 2 ** 20)
    ref = [murmurhash3_32(k) for k in toks]
    np.testing.assert_array_equal(cols, [abs(h) % 2 ** 20 for h in ref])
    np.testing.assert_array_equal(signs, [1 if h >= 0 else -1 for h in ref])


def test_english_stop_words_are_sklearns():
    from sklearn.feature_extraction.text import ENGLISH_STOP_WORDS

    assert T.ENGLISH_STOP_WORDS == ENGLISH_STOP_WORDS
    assert len(T.ENGLISH_STOP_WORDS) == 318


def test_blocks_budget_and_convert():
    hv = T.HashingVectorizer(n_features=2 ** 12)
    blocks = list(hv.transform_blocks(DOCS, block_size=64))
    assert len(blocks) == 5
    _same(sp.vstack(blocks), hv.transform(DOCS))
    view = hv.transform_sparse(DOCS, block_size=64)
    assert isinstance(view, SparseBlocks) and view.shape == (300, 2 ** 12)
    with config.set(to_dense_byte_budget=1000):
        with pytest.raises(T.DenseBudgetExceeded, match="streamed fit"):
            T.to_sharded_dense(view.tocsr())
    with config.set(device="cpu"):
        dense = T.to_sharded_dense(view.tocsr()[:10])
    np.testing.assert_allclose(dense.to_numpy(),
                               view.tocsr()[:10].toarray())
    j = J.CountVectorizer(stop_words="english", min_df=2).fit(DOCS)
    t = convert.convert(j)
    assert t.vocabulary_ == j.vocabulary_ and t.stop_words_ == j.stop_words_
    _same(t.transform(DOCS), j.transform(DOCS))
    h = convert.convert(J.HashingVectorizer(n_features=256, norm="l1"))
    _same(h.transform(DOCS), J.HashingVectorizer(
        n_features=256, norm="l1").transform(DOCS))


def test_hashed_corpus_streams_into_a_fit():
    """transform_sparse's view goes straight to a streamed fit on the nnz
    route, and fits as the CSR does."""
    hv = T.HashingVectorizer(n_features=2 ** 16)
    y = np.array(["über" in d for d in DOCS], np.float32)
    with config.set(device="cpu"):
        a = SGDClassifier(max_iter=2, random_state=0).fit(
            hv.transform_sparse(DOCS, block_size=50), y)
        b = SGDClassifier(max_iter=2, random_state=0).fit(
            hv.transform(DOCS), y)
    assert a.solver_info_["sparse_stream"]
    np.testing.assert_array_equal(a.coef_, b.coef_)
