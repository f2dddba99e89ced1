"""PyTorch/CUDA port of :mod:`redcliff_tpu` for NVIDIA Hopper (H100).

The package mirrors ``redcliff_tpu/``'s layout file for file, so
``redcliff_tpu_torch/serve/engine.py`` is the counterpart of
``redcliff_tpu/serve/engine.py``. It imports ``torch``, ``numpy`` and the
standard library only: never ``jax`` and never a module of ``redcliff_tpu``.
What it needs from the JAX package's backend-free modules it keeps as its
own copies (``serve/session.py``, ``runtime/admission.py``,
``runtime/checkpoint.py``, ``runtime/preempt.py``,
``parallel/{policy,compaction}.py``, ``utils/config.py``,
``data/shards.py``).

Four slices are ported: the serve path (load a fitted REDCLIFF-S artifact
and serve it to live streams), the per-point REDCLIFF-S fit
(``train/redcliff_trainer.py``, with the GISTA group-lasso prox), the
coefficient grid (``train/driver.py:run_coefficient_grid`` ->
``parallel/grid.py:RedcliffGridRunner``, G points as one batched program,
with checkpoint and resume, deadlines, the bucket ladder and compaction),
and the array-task driver (``train/driver.py:set_up_and_run_experiments``
-> ``train/orchestration.py``: one REDCLIFF-S experiment from cached-args
files to ``final_best_model.bin``).
The two TPU kernels on those paths are hand-written CUDA kernels, each with
a lane form for the grid: the factor mix (``ops/csrc/factor_mix.cu``) and
the GL prox (``ops/csrc/gl_prox.cu``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without CUDA and without an explicit device they raise
(:func:`redcliff_tpu_torch.utils.precision.resolve_device`).
"""
