"""PyTorch + CUDA port of srl_zoo_tpu for NVIDIA Hopper GPUs.

The JAX package ``srl_zoo_tpu`` is the reference this package is held
against; nothing here imports it or JAX. Ported so far: the training of
configs 1-4 (autoencoder, beta-VAE, robotic priors, SRL splits with the
forward / inverse / reward heads; ``python -m srl_zoo_tpu_torch.train``,
``training.learner``) and the inference path: ``inference.StateEncoder``,
the ``serve`` HTTP endpoint, state export (``evaluation.predict_dataset``),
KNN-MSE (``evaluation.knn``, with both neighbour routes of
``ops.knn_topk``) and GTC (``evaluation.gtc``), with hand-written CUDA
kernels under ``csrc/``.
"""
