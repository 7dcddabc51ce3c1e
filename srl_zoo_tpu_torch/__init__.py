"""PyTorch + CUDA port of srl_zoo_tpu for NVIDIA Hopper GPUs.

The JAX package ``srl_zoo_tpu`` is the reference this package is held
against; nothing here imports it or JAX. Ported so far: config 1's
training (``python -m srl_zoo_tpu_torch.train``, ``training.learner``) and
its inference path: ``inference.StateEncoder``, the ``serve`` HTTP
endpoint, state export (``evaluation.predict_dataset``), KNN-MSE
(``evaluation.knn``) and GTC (``evaluation.gtc``), with hand-written CUDA
kernels under ``csrc/``.
"""
