"""Model artifacts (the ``save_model`` / ``load_model`` half of
``train/trainer.py``). The REDCLIFF-S trainer is
``train/redcliff_trainer.py``; the generic trainer of the baseline model
families is not ported yet (ROADMAP queue 1).

An artifact is ``final_best_model.bin`` in the durable checkpoint format,
holding ``{"model_class", "config", "params"}`` with params as the JAX
package's numpy tree, so artifacts move between the two packages.
"""
from __future__ import annotations

import os

from redcliff_tpu_torch.interop import params_to_jax
from redcliff_tpu_torch.runtime import checkpoint as durable_ckpt

__all__ = ["save_model", "load_model", "ARTIFACT_NAME"]

ARTIFACT_NAME = "final_best_model.bin"


def save_model(save_dir, model, params, extra=None):
    """Persist {config, params} under the reference's artifact name."""
    os.makedirs(save_dir, exist_ok=True)
    payload = {
        "model_class": type(model).__name__,
        "config": model.config,
        "params": params_to_jax(params),
    }
    if extra:
        payload.update(extra)
    durable_ckpt.write_checkpoint(os.path.join(save_dir, ARTIFACT_NAME),
                                  payload)


def load_model(save_dir_or_file):
    """Read a model artifact payload (durable format or legacy pickle)."""
    path = save_dir_or_file
    if os.path.isdir(path):
        path = os.path.join(path, ARTIFACT_NAME)
    return durable_ckpt.read_checkpoint(path)
