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

The registry holds every class of the JAX package's: REDCLIFF-S (both
factor types), cMLP-FM, cLSTM-FM, NAVAR, NAVAR-LSTM, DGCNN, DCSFA-NMF
(``DcsfaNmf`` / ``FullDCSFAModel``: its artifact gives ``(model, params,
state)``, the encoder's BatchNorm statistics being the state) and
DYNOTEARS (``DynotearsModel`` / ``DynotearsVanillaModel``: solver-state
artifacts on the host, ``(model, None)``). A DCSFA run keeps its model
under the cached-args' ``best_model_name`` (``dCSFA-NMF-best-model.*``),
which :func:`load_artifact` finds as the JAX package's does.
"""
from __future__ import annotations

import dataclasses
import os
import warnings

import numpy as np
import torch

from redcliff_tpu_torch.interop import params_from_jax, tree_leaves
from redcliff_tpu_torch.runtime.checkpoint import read_checkpoint
from redcliff_tpu_torch.utils.precision import resolve_device

__all__ = ["MODEL_REGISTRY", "load_artifact", "load_model_for_eval",
           "to_params_device"]

def MODEL_REGISTRY():
    """Artifact ``model_class`` name -> the port's model class."""
    from redcliff_tpu_torch.models.clstm_fm import CLSTMFM
    from redcliff_tpu_torch.models.cmlp_fm import CMLPFM
    from redcliff_tpu_torch.models.dcsfa_nmf import DcsfaNmf, FullDCSFAModel
    from redcliff_tpu_torch.models.dgcnn import DGCNNModel
    from redcliff_tpu_torch.models.dynotears import (DynotearsModel,
                                                     DynotearsVanillaModel)
    from redcliff_tpu_torch.models.navar import NAVAR, NAVARLSTM
    from redcliff_tpu_torch.models.redcliff import RedcliffSCMLP

    return {"RedcliffSCMLP": RedcliffSCMLP, "CMLPFM": CMLPFM,
            "CLSTMFM": CLSTMFM, "DGCNNModel": DGCNNModel, "NAVAR": NAVAR,
            "NAVARLSTM": NAVARLSTM, "DcsfaNmf": DcsfaNmf,
            "FullDCSFAModel": FullDCSFAModel,
            "DynotearsModel": DynotearsModel,
            "DynotearsVanillaModel": DynotearsVanillaModel}


def load_artifact(path, best_model_name=None):
    """The raw payload of a run dir or of an artifact file.

    In a run dir, ``best_model_name`` names the artifact outright (it must
    exist); otherwise ``final_best_model.bin`` is read, else a DCSFA
    ``dCSFA-NMF-best-model*`` file (``.pt`` before ``.bin`` before
    ``.pkl``, newest first among equals), else a lone ``.pt``/``.pkl``/
    ``.bin`` file that is neither the run's meta data nor its trainer
    checkpoint, as the JAX package does. One difference, on purpose: the
    durable writer's older generation (``.prev``) and quarantined copies
    (``.bad``) are never candidates, where the JAX package ranks them
    last."""
    if os.path.isdir(path):
        if best_model_name:
            named = os.path.join(path, best_model_name)
            if not os.path.isfile(named):
                raise FileNotFoundError(
                    f"best_model_name {best_model_name!r} not found in "
                    f"{path!r}")
            return read_checkpoint(named)
        # the durable writer's older generation (.prev) and quarantined
        # copies (.bad) are not candidates
        cands = [x for x in os.listdir(path)
                 if x.startswith("dCSFA-NMF-best-model")
                 and not x.endswith((".prev", ".bad"))]
        ext_rank = {".pt": 0, ".bin": 1, ".pkl": 2}
        cands.sort(key=lambda x: (
            ext_rank.get(os.path.splitext(x)[1], 3),
            -os.path.getmtime(os.path.join(path, x))))
        if not cands:
            # a run saved under another best_model_name: a LONE pickle-like
            # file that is not one of the known non-model artifacts
            non_model = {"training_meta_data_and_hyper_parameters.pkl",
                         "trainer_checkpoint.pkl"}
            loose = [x for x in os.listdir(path)
                     if x.endswith((".pt", ".pkl", ".bin"))
                     and x not in non_model]
            if len(loose) == 1:
                cands = loose
        for name in ["final_best_model.bin"] + cands:
            cand = os.path.join(path, name)
            if os.path.isfile(cand):
                if len(cands) > 1:
                    warnings.warn(
                        f"multiple dCSFA-NMF-best-model artifacts in "
                        f"{path!r}: {cands!r}; loading {name!r} (.pt "
                        f"preferred over .pkl, mtime tie-break)")
                path = cand
                break
        else:
            raise FileNotFoundError(
                f"no model artifact (final_best_model.bin / "
                f"dCSFA-NMF-best-model*) in {path!r}")
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
    (default ``cuda``; raises without CUDA unless ``device`` is given);
    ``(model, params, state)`` for a DCSFA-NMF artifact; ``(model, None)``
    for a DYNOTEARS one (host solver state, ``device`` unused).
    ``model_class`` overrides the class the payload records."""
    payload = load_artifact(path, best_model_name=best_model_name)
    cls_name = model_class or payload.get("model_class")
    if cls_name is None and "config" in payload:
        cls_name = type(payload["config"]).__name__.replace("Config", "")
    registry = MODEL_REGISTRY()
    if cls_name not in registry:
        raise ValueError(f"unknown model class in artifact: {cls_name!r}")
    cls = registry[cls_name]
    config = _migrate_config(payload["config"])
    if cls_name in ("DynotearsModel", "DynotearsVanillaModel"):
        # solver-state artifacts: gc() reads instance state, no params tree
        model = cls(config)
        for attr in ("state", "d_vars", "p_orders", "n", "a_est"):
            if attr in payload:
                setattr(model, attr, payload[attr])
        return model, None
    dev = resolve_device(device)
    if hasattr(config, "__post_init__"):
        config.__post_init__()  # unpickling skipped the validation
    if cls_name in ("DcsfaNmf", "FullDCSFAModel"):
        model = cls.__new__(cls)
        model.config = config
        if cls_name == "FullDCSFAModel":
            # graph-shape metadata written by _artifact_payload; the GC
            # readout is impossible without it
            missing = [a for a in ("num_nodes",
                                   "num_high_level_node_features")
                       if a not in payload]
            if missing:
                raise ValueError(
                    f"FullDCSFAModel artifact is missing {missing}; re-save "
                    "with DcsfaNmf._artifact_payload")
            model.gc_feature_layout = payload.get("gc_feature_layout",
                                                  "dirspec")
        for attr in ("num_nodes", "num_high_level_node_features",
                     "gc_feature_layout"):
            if attr in payload:
                setattr(model, attr, payload[attr])
        return (model, params_from_jax(payload["params"], dev),
                params_from_jax(payload.get("state", {}), dev))
    model = cls(config)
    return model, params_from_jax(payload["params"], dev)


def to_params_device(params, x):
    """``x`` (numpy or a tensor) as one contiguous float32 tensor on the
    device of the params tree ``params``."""
    dev = tree_leaves(params)[0].device
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)
