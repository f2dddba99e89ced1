"""PyTorch/CUDA port of :mod:`redcliff_tpu` for NVIDIA Hopper (H100).

The package mirrors ``redcliff_tpu/``'s layout file for file, so
``redcliff_tpu_torch/serve/engine.py`` is the counterpart of
``redcliff_tpu/serve/engine.py``. It imports ``torch``, ``numpy``,
``scipy`` and the standard library only: never ``jax`` and never a module
of ``redcliff_tpu``. What it needs from the JAX package's backend-free
modules it keeps as its own copies: ``serve/{session,chaos}.py``,
``obs/slo.py``, ``runtime/{admission,checkpoint,preempt}.py``, ``utils/{metrics,misc}.py``,
``train/tracking.py``, ``parallel/{policy,compaction}.py``,
``utils/config.py``, ``data/shards.py`` (without ``ShardedBatchDataset``),
``eval/*``, ``utils/{directed_spectrum,time_series,plotting}.py``,
``models/{dynotears,pcmci}.py``, ``tidybench/*`` (with the C++ SELVAR
core, built with g++ into ``build/host_native/`` at first use), and
``data/{curation,dream4,lfp}.py`` with the host half of
``data/synthetic.py``, and the fleet's control plane: ``fleet/*`` but
``run_batch.py``, ``runtime/supervisor.py``, ``supervise.py`` and
``parallel/packing.py``.

Ported so far:

- serving: load a fitted REDCLIFF-S artifact and serve it to live streams
  (``serve/``) on an elastic slot table: the occupancy ladder, fused
  ticks, f32 or mixed precision (a bf16 form of the factor-mix kernel)
  with the poisoned-lane-storm demotion, the prefetching run loop;
- training: the per-point REDCLIFF-S fit (``train/redcliff_trainer.py``,
  with the GISTA group-lasso prox), the coefficient grid
  (``train/driver.py:run_coefficient_grid`` ->
  ``parallel/grid.py:RedcliffGridRunner``, G points as one batched
  program, durable, on the bucket ladder, its epochs replayed as CUDA
  graphs by ``parallel/epoch_engine.py``), the generic trainer
  (``train/trainer.py``) and every family of the paper's comparison as an
  array task (``train/driver.py:set_up_and_run_experiments`` ->
  ``train/orchestration.py``): REDCLIFF-S with cMLP or cLSTM factors,
  cMLP, cLSTM, NAVAR, NAVAR-LSTM, DGCNN, DCSFA-NMF and DYNOTEARS;
- evaluation: scoring, selection and the dynamic readouts (``eval/``),
  the paper's Table-2 discovery comparison (``tidybench/``, PCMCI and
  R-PCMCI in ``models/pcmci.py``, ``eval/supervised_discovery.py``) and
  the analysis layer that regenerates its summary tables
  (``eval/analysis.py``; figures through ``utils/plotting.py`` where
  matplotlib is installed);
- data: synthetic sVAR generation on the host and on the card, synSys and
  D4IC curation, DREAM4 and LFP preprocessing (``data/``);
- the paper's synSys and D4IC accuracy studies as twins of the JAX
  package's scripts (``experiments/``);
- the time-series transformer (``models/ts_transformer.py``, plain
  PyTorch on the card);
- the fleet sweep service (``fleet/``): a durable multi-tenant queue, the
  admission planner, a worker that runs each merged batch under the
  crash-loop supervisor as a ``fleet.run_batch`` child fitting one grid on
  the card, containment, autoscaling and the CLI
  (``python -m redcliff_tpu_torch.fleet``).

The two TPU kernels on those paths are hand-written CUDA kernels, each with
a lane form for the grid: the factor mix (``ops/csrc/factor_mix.cu``) and
the GL prox (``ops/csrc/gl_prox.cu``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without CUDA and without an explicit device they raise
(:func:`redcliff_tpu_torch.utils.precision.resolve_device`).
"""
