"""Model loading (port of ``eval/model_io.py``).

Artifacts are ``{model_class, config, params}`` payloads in the durable
checkpoint format, written by either package's ``save_model``, or legacy
headerless pickles of the same payload (what
``experiments/d4ic_grid_search.py`` writes per grid point). A JAX-written
artifact loads without JAX: the restricted unpickler maps the JAX config
class to the port's (runtime/checkpoint.py) and the params are numpy.

:func:`to_params_device` moves host inputs (numpy windows) to the device
the loaded params live on, as one float32 tensor: the evaluation layer's
one host-to-device copy per call.

The registry holds the classes the port has: REDCLIFF-S (both factor
types), cMLP-FM, cLSTM-FM, NAVAR, NAVAR-LSTM and DGCNN. A DCSFA-NMF or
DYNOTEARS artifact raises: its config class does not unpickle here, and
its class name is refused (ROADMAP queue 1, item 13).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from redcliff_tpu_torch.interop import params_from_jax, tree_leaves
from redcliff_tpu_torch.runtime.checkpoint import read_checkpoint
from redcliff_tpu_torch.train.orchestration import (UNPORTED_MODEL_CLASSES,
                                                    refuse_unported)
from redcliff_tpu_torch.utils.precision import resolve_device

__all__ = ["MODEL_REGISTRY", "load_artifact", "load_model_for_eval",
           "to_params_device"]

def MODEL_REGISTRY():
    """Artifact ``model_class`` name -> the port's model class."""
    from redcliff_tpu_torch.models.clstm_fm import CLSTMFM
    from redcliff_tpu_torch.models.cmlp_fm import CMLPFM
    from redcliff_tpu_torch.models.dgcnn import DGCNNModel
    from redcliff_tpu_torch.models.navar import NAVAR, NAVARLSTM
    from redcliff_tpu_torch.models.redcliff import RedcliffSCMLP

    return {"RedcliffSCMLP": RedcliffSCMLP, "CMLPFM": CMLPFM,
            "CLSTMFM": CLSTMFM, "DGCNNModel": DGCNNModel, "NAVAR": NAVAR,
            "NAVARLSTM": NAVARLSTM}


def load_artifact(path, best_model_name=None):
    """The raw payload of a run dir (``final_best_model.bin``, or
    ``best_model_name`` when given) or of an artifact file."""
    if os.path.isdir(path):
        name = best_model_name or "final_best_model.bin"
        path = os.path.join(path, name)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no model artifact {name!r} in "
                                    f"{os.path.dirname(path)!r}")
    return read_checkpoint(path)


def _migrate_config(config):
    """Fill config fields added after an artifact was pickled (unpickling
    restores ``__dict__`` directly, bypassing dataclass defaults)."""
    if dataclasses.is_dataclass(config):
        for f in dataclasses.fields(config):
            if not hasattr(config, f.name):
                if f.default is not dataclasses.MISSING:
                    default = f.default
                elif f.default_factory is not dataclasses.MISSING:
                    default = f.default_factory()
                else:
                    default = None
                object.__setattr__(config, f.name, default)
    return config


def load_model_for_eval(path, device=None, model_class=None,
                        best_model_name=None):
    """``(model, params)`` from a saved artifact, params on ``device``
    (default ``cuda``; raises without CUDA unless ``device`` is given).
    ``model_class`` overrides the class the payload records."""
    dev = resolve_device(device)
    payload = load_artifact(path, best_model_name=best_model_name)
    cls_name = model_class or payload.get("model_class")
    if cls_name is None and "config" in payload:
        cls_name = type(payload["config"]).__name__.replace("Config", "")
    if cls_name in UNPORTED_MODEL_CLASSES:
        refuse_unported(f"loading a {cls_name} artifact")
    registry = MODEL_REGISTRY()
    if cls_name not in registry:
        raise ValueError(f"unknown model class in artifact: {cls_name!r}")
    config = _migrate_config(payload["config"])
    if hasattr(config, "__post_init__"):
        config.__post_init__()  # unpickling skipped the validation
    model = registry[cls_name](config)
    return model, params_from_jax(payload["params"], dev)


def to_params_device(params, x):
    """``x`` (numpy or a tensor) as one contiguous float32 tensor on the
    device of the params tree ``params``."""
    dev = tree_leaves(params)[0].device
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)
