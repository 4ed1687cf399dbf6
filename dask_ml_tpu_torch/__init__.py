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
- ``linear_model``, ``cluster``, ``decomposition``, ``metrics`` —
  sklearn-parity namespaces
- ``wrappers`` — ParallelPostFit and Incremental
- ``convert`` — carry a fitted JAX estimator's parameters across

Ported so far: LogisticRegression (binary and one-vs-rest),
LinearRegression and PoissonRegression with every solver, and KMeans,
each in memory and out of core (an ``np.memmap`` streams through the
card in blocks); SGDClassifier and SGDRegressor (fit, partial_fit and
the batched-trial step) on host, memmap and device data, and the
Incremental and ParallelPostFit wrappers; PCA, TruncatedSVD and
IncrementalPCA in memory and out of core. Sequential streamed passes
over an ``np.memmap`` read through the native block reader.
ROADMAP.md lists what is still to port.
"""

__version__ = "0.1.0"

__all__ = ["cluster", "config", "convert", "decomposition", "io",
           "linear_model", "metrics", "wrappers", "__version__"]
