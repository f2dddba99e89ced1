"""Synthetic sVAR benchmark generator (port of
``redcliff_tpu/data/synthetic.py``).

A 2-lag sinusoid-driven (optionally nonlinear) VAR whose per-state
rollouts are superimposed with random linearly-interpolated activation
weights, plus the random lagged-DAG factory with orthogonality and
connected-component constraints (ref data_utils.py:47-240, 243-353).

Two implementations share one parameterization, as in the JAX package:

* the host half — ``rollout_np`` / ``generate_synthetic_data_np``,
  ``reference_curation_params`` and the graph factory
  ``generate_lagged_adjacency_graphs_for_factor_model`` — is numpy and
  Python ``random``, copied so that its outputs equal the JAX package's bit
  for bit from the same ``np.random.default_rng`` and seed. Curation
  (``data/curation.py``) runs on it.
* the device half — ``generate_synthetic_dataset`` — is the JAX package's
  ``lax.scan`` inside a ``fori_loop`` over states inside a ``vmap`` over
  samples (plain jnp there, no Pallas kernel), here as one batched PyTorch
  program over all N samples x S states with a Python loop over the
  ``burnin + T`` steps. Its randomness is split from its arithmetic:
  :func:`draw_synthetic_noise` draws every variate from a
  ``torch.Generator`` (``jax.random`` cannot be matched, so the port's
  data equals the JAX package's in distribution only), and
  :func:`synthetic_batch_body` computes from those draws exactly what the
  JAX ``generate_synthetic_batch`` computes from its own (``:120-133``,
  ``:172-199``), so it can be held to JAX on JAX's draws.

Per-edge nonlinearities are encoded as an integer code tensor
``act_codes`` of shape (D, D, L): 0 = identity, 1 = min(x, 0),
2 = max(x, 0) — the three activations the reference curation driver uses
(ref currate_...etNL.py:21,272).
"""
from __future__ import annotations

import random as _pyrandom

import numpy as np
import torch

from redcliff_tpu_torch.utils.metrics import get_number_of_connected_components
from redcliff_tpu_torch.utils.precision import resolve_device

__all__ = [
    "ACT_IDENTITY", "ACT_MIN0", "ACT_MAX0",
    "nvar_step_np", "rollout_np", "generate_synthetic_data_np",
    "reference_curation_params",
    "generate_lagged_adjacency_graphs_for_factor_model",
    "stack_systems", "draw_synthetic_noise", "synthetic_batch_body",
    "generate_synthetic_dataset",
]

ACT_IDENTITY, ACT_MIN0, ACT_MAX0 = 0, 1, 2


def _apply_act_np(x, codes):
    out = np.where(codes == ACT_MIN0, np.minimum(x, 0.0), x)
    out = np.where(codes == ACT_MAX0, np.maximum(x, 0.0), out)
    return out


def _apply_act(x, codes):
    out = torch.where(codes == ACT_MIN0, torch.clamp(x, max=0.0), x)
    return torch.where(codes == ACT_MAX0, torch.clamp(x, min=0.0), out)


def _ordered_sum(x):
    """Sum over the last axis, left to right, one elementwise add per
    entry: the same float32 result on every device (a reduction kernel's
    order differs between the card and the CPU, and the recurrence carries
    every rounding difference through its steps)."""
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def _ordered_mean(x):
    """``_ordered_sum`` over the count, divided as a tensor: the card
    divides by a Python scalar through its reciprocal, the CPU does not."""
    return _ordered_sum(x) / torch.tensor(float(x.shape[-1]),
                                          device=x.device)


def _step_matrices(A, base_freqs):
    """Fold the self-connection dynamics into per-lag dense matrices.

    The reference treats diagonal entries specially (ref data_utils.py:69-78):
    lag-1 self term is A[i,i,0] * 2cos(2*pi*f_i) * x_{t-1,i} and lag-2 self term is
    -A[i,i,1] * x_{t-2,i}. Scaling the diagonal ahead of time makes the whole step
    one elementwise-activated (D, D) product per lag.
    """
    A = np.asarray(A, dtype=np.float64)
    D = A.shape[0]
    f = np.asarray(base_freqs, dtype=np.float64).reshape(D)
    M1 = A[:, :, 0].copy()
    M1[np.arange(D), np.arange(D)] *= 2.0 * np.cos(2.0 * np.pi * f)
    M2 = A[:, :, 1].copy() if A.shape[2] > 1 else np.zeros((D, D))
    M2[np.arange(D), np.arange(D)] *= -1.0
    return M1, M2


def nvar_step_np(x_tm1, x_tm2, M1, M2, act_codes, innovation, num_lags=2):
    """One step of the nonlinear VAR given pre-folded matrices (host version)."""
    pre1 = M1 * x_tm1[None, :]
    contrib = _apply_act_np(pre1, act_codes[:, :, 0]).sum(axis=1)
    if num_lags > 1:
        pre2 = M2 * x_tm2[None, :]
        contrib = contrib + _apply_act_np(pre2, act_codes[:, :, 1]).sum(axis=1)
    return contrib + innovation


def rollout_np(A, act_codes, base_freqs, noise_mu, noise_var, innovation_amp,
               recording_length, burnin_period, rng):
    """Host rollout matching ref data_utils.py:88-125 step-for-step.

    Innovations only enter through the self-connection branch, i.e. once per node
    per step. Returns (D, recording_length).
    """
    A = np.asarray(A, dtype=np.float64)
    D = A.shape[0]
    M1, M2 = _step_matrices(A, base_freqs)
    amp = np.asarray(innovation_amp, dtype=np.float64).reshape(D)
    mu = np.asarray(noise_mu, dtype=np.float64).reshape(D)
    var = np.asarray(noise_var, dtype=np.float64).reshape(D)
    avg_amp = float(np.mean(amp))

    x0 = rng.uniform(-avg_amp, avg_amp, D)
    innov = amp * rng.normal(mu, var)
    x1 = nvar_step_np(x0, x0, M1, M2, act_codes, innov, num_lags=1)
    samp = [x0, x1]
    for _ in range(recording_length + burnin_period):
        innov = amp * rng.normal(mu, var)
        samp.append(nvar_step_np(samp[-1], samp[-2], M1, M2, act_codes, innov))
    return np.stack(samp[2 + burnin_period :], axis=1)


def generate_synthetic_data_np(rng, graphs, act_code_tensors, base_freqs, noise_mu,
                               noise_var, innovation_amp, num_samples,
                               recording_length, burnin_period,
                               num_labeled_sys_states, label_type="Oracle",
                               noise_type="white", noise_amp=0.1):
    """Host/numpy twin of generate_synthetic_dataset (golden-test oracle)."""
    S = len(graphs)
    D = graphs[0].shape[0]
    n_extra = S - num_labeled_sys_states
    num_labels = num_labeled_sys_states + (1 if n_extra > 0 else 0)
    amp = np.asarray(innovation_amp, dtype=np.float64).reshape(D)
    avg_amp = float(np.mean(amp))
    X = np.zeros((num_samples, recording_length, D), dtype=np.float32)
    Y = np.zeros((num_samples, num_labels, recording_length), dtype=np.float32)
    for s in range(num_samples):
        x = np.zeros((D, recording_length))
        y_true = np.zeros((num_labels, recording_length))
        for state in range(S):
            sig = rollout_np(graphs[state], act_code_tensors[state], base_freqs,
                             noise_mu, noise_var, innovation_amp, recording_length,
                             burnin_period, rng)
            w0, w1 = rng.uniform(), rng.uniform()
            ramp = np.linspace(w0, w1, recording_length)
            x += sig * ramp[None, :]
            row = state if state < num_labels - 1 else num_labels - 1
            y_true[row] += ramp
        if n_extra > 0:
            y_true[-1] /= S - (num_labels - 1)
        if label_type == "Oracle":
            y = y_true
        elif label_type == "OneHot":
            y = np.zeros_like(y_true)
            y[np.argmax(y_true, axis=0), np.arange(recording_length)] = 1.0
        else:
            raise ValueError(label_type)
        if noise_type == "white":
            eps = rng.uniform(-avg_amp, avg_amp, (D, recording_length))
        elif noise_type == "gaussian":
            eps = rng.normal(np.mean(noise_mu), np.mean(noise_var) * avg_amp,
                             (D, recording_length))
        else:
            raise ValueError(noise_type)
        X[s] = (x + noise_amp * eps).T
        Y[s] = y
    return X, Y


def reference_curation_params(num_nodes):
    """The sVAR coefficient recipe used by the reference curation driver
    (ref currate_...etNL.py:72-75,277-281): per-node base frequencies
    pi*(707*i + i%2)/120000, standard-normal innovations with unit amplitude,
    off-diagonal edge strengths 0.3 at both lags, receiving-node damping 0.6,
    sending-node damping 1.0."""
    return {
        "base_freqs": np.pi * np.array([i * 707 + i % 2 for i in range(num_nodes)]) / 120000.0,
        "noise_mu": np.zeros(num_nodes),
        "noise_var": np.ones(num_nodes),
        "innovation_amp": np.ones(num_nodes),
        "off_diag_edge_strengths": (0.3, 0.3),
        "diag_receiving_node_forgetting_coeffs": (0.6, 0.6),
        "diag_sending_node_forgetting_coeffs": (1.0, 1.0),
        "recording_length": 100,
        "burnin_period": 10,
    }


# ---------------------------------------------------------------------------
# Device rollout: draws, then a deterministic body
# ---------------------------------------------------------------------------

def stack_systems(graphs, act_code_tensors, base_freqs, noise_mu, noise_var,
                  innovation_amp, device=None):
    """The per-state systems as the body takes them, on ``device``:
    ``M1``, ``M2`` (S, D, D) float32 (``_step_matrices`` folded in float64,
    then cast, as ``jnp.asarray`` does), ``act_codes`` (S, D, D, L) int32
    and ``base`` {noise_mu, noise_var, innovation_amp}, each (D,) float32
    (``:214-223``)."""
    dev = torch.device("cpu" if device is None else device)
    M1s, M2s = zip(*[_step_matrices(g, base_freqs) for g in graphs])

    def f32(a):
        return torch.from_numpy(
            np.asarray(a, dtype=np.float32).reshape(-1)).to(dev)

    return (torch.from_numpy(np.stack(M1s).astype(np.float32)).to(dev),
            torch.from_numpy(np.stack(M2s).astype(np.float32)).to(dev),
            torch.from_numpy(np.stack(act_code_tensors).astype(np.int32)).to(dev),
            {"noise_mu": f32(noise_mu), "noise_var": f32(noise_var),
             "innovation_amp": f32(innovation_amp)})


def draw_synthetic_noise(generator, num_samples, num_states, recording_length,
                         burnin_period, num_nodes, noise_type="white",
                         device=None):
    """Every variate one dataset draw needs, as unit draws from
    ``generator`` (on the generator's device, then moved to ``device``):

    * ``x0`` (N, S, D): uniform [0, 1), the initial state before scaling
      to [-avg_amp, avg_amp) (JAX ``:120``);
    * ``innov1`` (N, S, D): standard normals of the first innovation
      (``:121``);
    * ``steps`` (burnin + T, N, S, D): standard normals of the step
      innovations, step-major (``:126``);
    * ``ramps`` (N, S, 2): uniform [0, 1) endpoints of each state's
      activation ramp (``:170-171``);
    * ``meas`` (N, T, D): the measurement noise's unit draw, uniform
      [0, 1) for ``white`` and standard normal for ``gaussian``
      (``:191-197``).
    """
    if noise_type not in ("white", "gaussian"):
        raise ValueError(f"Unrecognized noise_type={noise_type}")
    N, S, D, T = num_samples, num_states, num_nodes, recording_length
    gdev = generator.device

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=gdev)

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=gdev)

    draws = {"x0": rand(N, S, D), "innov1": randn(N, S, D),
             "steps": randn(T + burnin_period, N, S, D),
             "ramps": rand(N, S, 2),
             "meas": rand(N, T, D) if noise_type == "white" else randn(N, T, D)}
    dev = gdev if device is None else torch.device(device)
    return {k: v.to(dev) for k, v in draws.items()}


def _uniform_scale(u, lo, hi):
    """``jax.random.uniform``'s map of a unit draw onto [lo, hi)."""
    return torch.maximum(lo, u * (hi - lo) + lo)


def _ramps(w0, w1, T):
    """``jnp.linspace(w0, w1, T)`` batched over the leading axes of the
    endpoints, with its float32 formula: start*(1 - f) + stop*f on
    f = iota/(T-1) (divided on the host, the same on every device), the
    endpoint appended."""
    f = torch.from_numpy(np.arange(T - 1, dtype=np.float32)
                         / np.float32(T - 1)).to(w0.device)
    out = w0[..., None] * (1 - f) + w1[..., None] * f
    return torch.cat([out, w1[..., None]], dim=-1)


def synthetic_batch_body(M1, M2, act_codes, base, draws, recording_length,
                         burnin_period, num_labeled_sys_states,
                         label_type="Oracle", noise_type="white",
                         noise_amp=0.1):
    """What the JAX ``generate_synthetic_batch`` computes for every sample
    at once, from the unit draws of :func:`draw_synthetic_noise`.

    ``M1``, ``M2``, ``act_codes``, ``base`` as :func:`stack_systems` gives
    them, on the draws' device. Each state's rollout (``rollout_scan``,
    ``:113-136``) runs for all samples together, one Python step per time
    step; states are superimposed under their ramps in state order, labels
    pooled and one-hot as in ``:172-188``, measurement noise added as in
    ``:190-200``. Returns (X (N, T, D), Y (N, num_labels, T)) float32
    tensors on the draws' device.
    """
    S, D = M1.shape[0], M1.shape[1]
    T = recording_length
    N = draws["x0"].shape[0]
    n_extra = S - num_labeled_sys_states
    num_labels = num_labeled_sys_states + (1 if n_extra > 0 else 0)
    amp, mu, var = (base["innovation_amp"].reshape(D),
                    base["noise_mu"].reshape(D), base["noise_var"].reshape(D))
    avg_amp = _ordered_mean(amp)
    codes1, codes2 = act_codes[..., 0], act_codes[..., 1]

    x0 = _uniform_scale(draws["x0"], -avg_amp, avg_amp)          # (N, S, D)
    innov1 = amp * (mu + var * draws["innov1"])
    x_tm2 = x0
    x_tm1 = _ordered_sum(_apply_act(M1 * x0[..., None, :], codes1)) + innov1
    xs = []
    for t in range(T + burnin_period):
        eps = mu + var * draws["steps"][t]
        c1 = _ordered_sum(_apply_act(M1 * x_tm1[..., None, :], codes1))
        c2 = _ordered_sum(_apply_act(M2 * x_tm2[..., None, :], codes2))
        x_t = c1 + c2 + amp * eps
        x_tm1, x_tm2 = x_t, x_tm1
        if t >= burnin_period:
            xs.append(x_t)
    sig = torch.stack(xs, dim=1)                                   # (N, T, S, D)

    ramps = _ramps(draws["ramps"][..., 0], draws["ramps"][..., 1], T)  # (N, S, T)
    x = torch.zeros((N, T, D), dtype=torch.float32, device=sig.device)
    y = torch.zeros((N, num_labels, T), dtype=torch.float32, device=sig.device)
    for i in range(S):
        x = x + sig[:, :, i] * ramps[:, i, :, None]
        row = i if i < num_labels - 1 else num_labels - 1
        y[:, row] = y[:, row] + ramps[:, i]
    if n_extra > 0:
        y[:, num_labels - 1] = y[:, num_labels - 1] * (
            1.0 / (S - (num_labels - 1)))

    if label_type == "OneHot":
        hot = torch.argmax(y, dim=1)                                   # (N, T)
        y = torch.nn.functional.one_hot(hot, num_labels).permute(
            0, 2, 1).to(torch.float32)
    elif label_type != "Oracle":
        raise ValueError(f"Unrecognized label_type={label_type}")

    if noise_type == "white":
        eps = _uniform_scale(draws["meas"], -avg_amp, avg_amp)
    elif noise_type == "gaussian":
        mu_c, var_c = _ordered_mean(mu), _ordered_mean(var)
        eps = mu_c + var_c * avg_amp * draws["meas"]
    else:
        raise ValueError(f"Unrecognized noise_type={noise_type}")
    x = x + noise_amp * eps
    return x.to(torch.float32), y.to(torch.float32)


def generate_synthetic_dataset(generator, graphs, act_code_tensors, base_freqs,
                               noise_mu, noise_var, innovation_amp, num_samples,
                               recording_length, burnin_period,
                               num_labeled_sys_states, label_type="Oracle",
                               noise_type="white", noise_amp=0.1, device=None):
    """Batched dataset curation on ``device`` (``cuda`` unless given): the
    JAX ``generate_synthetic_dataset`` with a ``torch.Generator`` in place
    of its ``key``. Draws come from ``generator`` (on its own device), the
    body runs on ``device``.

    Returns (X, Y) numpy arrays with X: (N, T, D) float32, Y:
    (N, num_labels, T) float32 — the (batch, time, channel) / label
    contract every model consumes.
    """
    dev = resolve_device(device)
    M1, M2, acts, base = stack_systems(graphs, act_code_tensors, base_freqs,
                                       noise_mu, noise_var, innovation_amp,
                                       device=dev)
    draws = draw_synthetic_noise(generator, num_samples, len(graphs),
                                 recording_length, burnin_period, M1.shape[1],
                                 noise_type=noise_type, device=dev)
    with torch.no_grad():
        X, Y = synthetic_batch_body(M1, M2, acts, base, draws,
                                    recording_length, burnin_period,
                                    num_labeled_sys_states,
                                    label_type=label_type,
                                    noise_type=noise_type, noise_amp=noise_amp)
    return X.cpu().numpy(), Y.cpu().numpy()


# ---------------------------------------------------------------------------
# Random lagged-DAG factory (host; curation-time only)
# ---------------------------------------------------------------------------

def generate_lagged_adjacency_graphs_for_factor_model(
    num_nodes,
    num_lags,
    num_factors,
    make_factors_orthogonal,
    make_factors_singular_components,
    rand_seed=0,
    off_diag_edge_strengths=(0.1, 1.0),
    diag_receiving_node_forgetting_coeffs=(0.1, 1.0),
    diag_sending_node_forgetting_coeffs=(0.9, 1.0),
    num_edges_per_graph=None,
    max_formulation_attempts=100,
    nonlinear_act_codes_per_factor=None,
):
    """Random per-factor lagged adjacency tensors (ref data_utils.py:243-353).

    Each graph starts as lag-wise identity; off-diagonal edges (i, j, l) are drawn
    without replacement, with the involved nodes' self-connections damped by the
    forgetting coefficients. Graphs are re-drawn until the lag-summed graph has at
    most the allowed number of connected components; orthogonal factors remove the
    chosen (i, j) pairs (all lags) from the shared edge pool. Factor order is
    shuffled before returning.

    Seeds Python ``random`` and ``np.random`` process-wide, as the reference
    and the JAX package do.

    Returns (graphs, act_code_tensors, shuffled_factor_inds) where each graph is
    (num_nodes, num_nodes, num_lags) and each act-code tensor is an int array of the
    same shape (0 identity / 1 min0 / 2 max0).
    """
    _pyrandom.seed(rand_seed)
    np.random.seed(rand_seed)

    while True:  # restart_curration loop
        graphs = [None] * num_factors
        acts = [None] * num_factors
        max_comps = 1 if make_factors_singular_components else num_nodes
        n_edges = num_edges_per_graph or (num_nodes**2) // num_factors
        if make_factors_singular_components:
            assert n_edges >= num_nodes - 1

        available = [
            (i, j, k)
            for i in range(num_nodes)
            for j in range(num_nodes)
            for k in range(num_lags)
            if i != j
        ]
        available_ids = list(range(len(available)))
        restart = False

        for f_ind in range(num_factors):
            attempts = 0
            while True:
                A = np.zeros((num_nodes, num_nodes, num_lags))
                for l in range(num_lags):
                    A[:, :, l] += np.eye(num_nodes)
                A_codes = np.zeros((num_nodes, num_nodes, num_lags), dtype=np.int32)

                _pyrandom.shuffle(available_ids)
                chosen_ids = available_ids[:n_edges]
                chosen = [available[i] for i in chosen_ids]
                for x, y, z in chosen:
                    A[x, y, z] = off_diag_edge_strengths[z]
                    A[x, x, 0] *= diag_receiving_node_forgetting_coeffs[0]
                    A[x, x, 1] *= diag_receiving_node_forgetting_coeffs[1]
                    A[y, y, 0] *= diag_sending_node_forgetting_coeffs[0]
                    A[y, y, 1] *= diag_sending_node_forgetting_coeffs[1]
                    if (
                        nonlinear_act_codes_per_factor is not None
                        and nonlinear_act_codes_per_factor[f_ind] is not None
                    ):
                        A_codes[x, y, z] = nonlinear_act_codes_per_factor[f_ind][z]

                n_comps = get_number_of_connected_components(
                    A.sum(axis=2), add_self_connections=False
                )
                attempts += 1
                if n_comps <= max_comps:
                    break
                if attempts == max_formulation_attempts:
                    restart = True
                    break
            if restart:
                break

            graphs[f_ind] = A
            acts[f_ind] = A_codes
            if make_factors_orthogonal:
                exclude = set(chosen_ids)
                chosen_pairs = {(x, y) for (x, y, _) in chosen}
                for eid in available_ids[n_edges:]:
                    if (available[eid][0], available[eid][1]) in chosen_pairs:
                        exclude.add(eid)
                available_ids = [i for i in available_ids if i not in exclude]

        if not restart:
            break

    inds = list(range(num_factors))
    order = list(zip(graphs, acts, inds))
    _pyrandom.shuffle(order)
    graphs, acts, inds = map(list, zip(*order))
    return graphs, acts, inds
