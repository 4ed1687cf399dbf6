"""dask_ml_tpu_torch — the PyTorch/CUDA port of ``dask_ml_tpu``.

The same sklearn-contract estimators, with the same names, parameters
and fitted attributes, running on an NVIDIA H100 through kernels written
by hand for Hopper (``csrc/``, bound in ``ops/fused.py``). Entry points
place data on ``config.device``, which is ``"cuda"`` unless the caller
asks for the CPU (``with config.set(device="cpu"): ...``).

Layers, each the counterpart of the JAX package's module of that name:
- ``config``, ``base``, ``parallel/sharded.py``, ``utils/validation.py``
- ``parallel/streaming.py`` — host-to-device block streams of the
  out-of-core fits
- ``io/`` — the native block reader and CSV loader
  (``csrc/*.cpp``, built with the host compiler)
- ``ops/`` — masked reductions, pairwise distances, tall-skinny QR and
  randomized SVD (``linalg.py``), the fused kernels (``fused.py``) and
  their build (``_build.py``)
- ``models/`` — GLM solvers and estimators, KMeans, the SGD estimators,
  PCA, TruncatedSVD and IncrementalPCA (``pca.py``, ``streamed_svd.py``)
- ``models/spectral.py`` — SpectralClustering (Nyström embedding, then
  KMeans on it)
- ``linear_model``, ``cluster``, ``decomposition``, ``metrics`` —
  sklearn-parity namespaces (``metrics``: classification, regression and
  pairwise metrics and the scorers)
- ``preprocessing``, ``impute``, ``compose``, ``naive_bayes``,
  ``ensemble`` — scalers, encoders, SimpleImputer, ColumnTransformer,
  GaussianNB and the blockwise ensembles; ``datasets`` — the synthetic
  generators; ``xgboost`` — the gate that names the missing package
- ``model_selection`` — splits, GridSearchCV and RandomizedSearchCV
  (with the stacked C-grid fast path), and the adaptive searches
  (IncrementalSearchCV, InverseDecaySearchCV, SuccessiveHalvingSearchCV,
  HyperbandSearchCV) on the streamed cohort plane
- ``wrappers`` — ParallelPostFit and Incremental
- ``feature_extraction`` — HashingVectorizer, FeatureHasher and
  CountVectorizer (the hashing in ``csrc/text_hash.cpp``), whose CSR
  output the streamed fits take as it is
- ``parallel/sparse_stream.py``, ``ops/sparse_kernels.py`` — sparse
  sources: the staging plan and the nnz-cost products of a staged block
- ``convert`` — carry a fitted JAX estimator's parameters across
- ``plans``, ``serving`` — online inference: the shape ladders and the
  plan layer that captures a CUDA graph per bucket, ``compiled_batch_fn``
  (``wrappers``), ModelServer, ModelRegistry, FleetServer with its
  supervisor (``reliability``) and autoscaler, serve_while_training

Ported so far: LogisticRegression (binary and one-vs-rest),
LinearRegression and PoissonRegression with every solver, and KMeans,
each in memory and out of core (an ``np.memmap`` streams through the
card in blocks); SGDClassifier and SGDRegressor (fit, partial_fit and
the batched-trial step) on host, memmap and device data, and the
Incremental and ParallelPostFit wrappers; PCA, TruncatedSVD and
IncrementalPCA in memory and out of core; the metrics and scorers, and
grid, randomized and adaptive searches; the preprocessing estimators,
SimpleImputer, ColumnTransformer, GaussianNB, the blockwise ensembles,
SpectralClustering and the dataset generators; sparse sources (scipy
sparse, ``SparseBlocks``) in every streamed fit, the splits and searches,
and the text vectorizers; serving (every estimator with a compiled
entry point, f32, int8 and sparse flavours, single servers and fleets).
Sequential streamed
passes over an ``np.memmap`` read through the native block reader.
pandas is imported only where a pandas object arrives (the frame paths,
Categorizer, DummyEncoder, make_classification_df); every array path
runs without it.
ROADMAP.md lists what is still to port.
"""

__version__ = "0.1.0"

__all__ = ["cluster", "compose", "config", "convert", "datasets",
           "decomposition", "ensemble", "feature_extraction", "impute",
           "io", "linear_model",
           "metrics", "model_selection", "naive_bayes", "plans",
           "preprocessing", "serving", "wrappers", "xgboost",
           "__version__"]
