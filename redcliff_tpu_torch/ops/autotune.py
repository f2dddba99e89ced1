"""Kernel launch-plan autotuner with a persistent store (port of
``redcliff_tpu/ops/autotune.py``).

Each hand-written kernel takes one plan knob this tuner searches: **threads
per block**. It does not map onto the TPU kernels' ``block_b`` /
``block_rows`` tiles; on this card the two kernels' thread counts already
travel to the launch as runtime fields (``MixArgs.threads``,
``ProxArgs.threads``), so no kernel changes with the plan.

* **The store half** is the JAX module's, bit for bit (below, from
  ``STORE_VERSION`` to :func:`tune`): winners persist as
  ``autotune_v<VERSION>.json`` under ``REDCLIFF_AUTOTUNE_DIR``, else the
  ``REDCLIFF_COMPILE_CACHE`` base directory, keyed ``(platform, kernel,
  shape, pow2 bucket)`` with platform ``"cuda"``; read-modify-write under a
  best-effort ``flock`` with an atomic replace; corrupt stores read as "no
  winner". :func:`tune` measures a fixed-order ladder and keeps the first
  minimum, or reuses a stored winner with zero search steps;
  ``REDCLIFF_AUTOTUNE=0`` disables searching. Every search or reuse is a
  record the trainers and the grid drain into ``autotune`` events.
* **The measuring half** is written for the card:
  :func:`measure_factor_mix` / :func:`measure_gl_prox` time the real
  wrappers (``ops/factor_mix.py``, ``ops/pallas_prox.py``) under each
  candidate plan (:func:`trial`) with CUDA events — one warm-up launch, a
  ``torch.cuda.synchronize()``, then the median of ``reps`` launches each
  timed by its own event pair, queued behind a spin of the stream so that
  they run back to back and a pair brackets device work, not the host's
  launch. Ladders: the factor mix
  :data:`FACTOR_MIX_THREADS` = (64, 128, 256), capped by the kernel's
  ``__launch_bounds__(256)``; the GL prox :data:`GL_PROX_THREADS` = (128,
  256, 512), multiples of 32 up to its ``kMaxThreads`` of 512 (a block
  with fewer warps than groups walks them in turn, one warp per group, so
  every point of the ladder is a plan the kernel takes).
* **The plans** (``mix_plan``, ``prox_plan``) take the tuned thread count
  through :func:`tuned_tile` when their per-shape plan cache is filled,
  never per launch; with no winner they keep today's rule, so without a
  store every plan is the one the kernels always launched with. The
  single forms are keyed by the pow2 bucket of the batch (factor mix) or
  of the slab count (GL prox), the lane forms by the pow2 bucket of the
  lanes, as JAX keys ``g_bucket``. A tuned plan the kernel refuses raises
  at launch.

:func:`tune_for_model` runs in the trainers' and the grid's constructors,
before any CUDA-graph capture bakes a plan in, when the fit's device is a
card, searching is enabled and a store resolves; elsewhere it is a no-op,
as JAX's is off the TPU. Once a search has started on the card, an error
propagates: nothing falls back to a default plan quietly.

stdlib at import; torch and the kernel modules only inside the measuring
functions.
"""
from __future__ import annotations
import json
import os
import threading
import time

__all__ = ["STORE_VERSION", "STORE_NAME", "ENV_STORE_DIR", "ENV_ENABLE",
           "MAX_WINNERS", "winner_key", "store_path", "search_enabled",
           "load_store", "winner", "tuned_tile", "record_winner", "tune",
           "drain_records", "clear_memo", "gl_prox_ladder",
           "measure_gl_prox", "tune_gl_prox", "factor_mix_ladder",
           "measure_factor_mix", "tune_factor_mix", "tune_for_model",
           "trial", "mix_key", "prox_key", "FACTOR_MIX_THREADS",
           "GL_PROX_THREADS"]

STORE_VERSION = 1
STORE_NAME = f"autotune_v{STORE_VERSION}.json"
ENV_STORE_DIR = "REDCLIFF_AUTOTUNE_DIR"
ENV_CACHE_DIR = "REDCLIFF_COMPILE_CACHE"  # literal on purpose: no runtime
#                                           import from this stdlib half
ENV_ENABLE = "REDCLIFF_AUTOTUNE"
MAX_WINNERS = 512

_lock = threading.Lock()
# in-process caches: key -> winner record (hot-path lookups must not re-read
# JSON per traced kernel call), plus the drained-event ring
_memo: dict = {}
_records: list = []


def winner_key(platform, kernel, shape_key, g_bucket):
    """The store's winner id: ``<platform>|<kernel>|<shape>|g<bucket>``."""
    return f"{platform}|{kernel}|{shape_key}|g{int(g_bucket)}"


def store_path(base_dir=None):
    """Resolve the store file path (``REDCLIFF_AUTOTUNE_DIR`` override, else
    the compile-cache base dir), or None when no base dir is known."""
    base = (base_dir or os.environ.get(ENV_STORE_DIR)
            or os.environ.get(ENV_CACHE_DIR) or None)
    if not base:
        return None
    if str(base).endswith(".json"):
        return str(base)
    return os.path.join(base, STORE_NAME)


def search_enabled():
    """True unless ``REDCLIFF_AUTOTUNE`` explicitly disables searching."""
    return os.environ.get(ENV_ENABLE, "1") not in ("0", "off", "false")


def _empty_store():
    return {"version": STORE_VERSION, "updated_at": None, "runs": 0,
            "winners": {}}


def _read_store(path):
    """Parse a store file; None on missing/corrupt/wrong-version — the
    corrupt-store->defaults discipline shared with the cost model."""
    try:
        with open(path) as f:
            store = json.load(f)
    except (OSError, ValueError):
        return None
    if not (isinstance(store, dict)
            and store.get("version") == STORE_VERSION
            and isinstance(store.get("winners"), dict)):
        return None
    return store


def load_store(base_dir=None):
    """The persisted store dict (or an empty one), plus its path."""
    path = store_path(base_dir)
    if path is None or not os.path.exists(path):
        return _empty_store(), path
    return _read_store(path) or _empty_store(), path


def clear_memo():
    """Drop the in-process winner memo (tests; store-dir changes)."""
    with _lock:
        _memo.clear()


def drain_records():
    """Pop every pending search/lookup record (engines log these as
    schema-registered ``autotune`` events)."""
    with _lock:
        out = list(_records)
        _records.clear()
    return out


def _note(record):
    with _lock:
        _records.append(record)
        del _records[:-64]  # bounded ring


def winner(kernel, shape_key, g_bucket, platform=None, base_dir=None):
    """The persisted winner record for a bucket (memo -> store), or None.
    Misses are memoized too — a traced kernel call must never re-read JSON
    per trace (record_winner refreshes the memo after a search). The memo
    is keyed by the RESOLVED store path as well: a lookup against one
    store can never replay a winner (or a miss) cached from another."""
    platform = platform or _platform()
    key = winner_key(platform, kernel, shape_key, g_bucket)
    path = store_path(base_dir)
    with _lock:
        if (path, key) in _memo:
            return _memo[(path, key)]
    store, _path = load_store(base_dir)
    rec = store["winners"].get(key)
    with _lock:
        _memo[(path, key)] = rec
    return rec


def tuned_tile(kernel, shape_key, size, field, default):
    """The one winner-unpack helper every kernel's hot-path lookup shares:
    the persisted winner's ``tile[field]`` for (kernel, shape, pow2 bucket
    of ``size``), else ``default``. Lookup only — searches run from the
    engines/bench via the tune_* entry points, never inside a traced
    kernel call."""
    rec = winner(kernel, shape_key, _pow2_bucket(size))
    if rec is not None:
        try:
            return int(rec["tile"][field])
        except (KeyError, TypeError, ValueError):
            pass
    return default


def record_winner(kernel, shape_key, g_bucket, tile, platform=None,
                  base_dir=None, search_ms=None, candidates=None,
                  speedup_vs_default=None, now=None):
    """Persist a winner — read-modify-write under a best-effort flock with
    an atomic replace (concurrent fits merge instead of clobbering).
    Returns the winner record (memoized even when no store dir resolves,
    so the current process still reuses it)."""
    platform = platform or _platform()
    now = time.time() if now is None else now
    key = winner_key(platform, kernel, shape_key, g_bucket)
    rec = {"kernel": kernel, "platform": platform, "shape": shape_key,
           "g_bucket": int(g_bucket), "tile": dict(tile),
           "search_ms": (round(float(search_ms), 3)
                         if search_ms is not None else None),
           "candidates": candidates,
           "speedup_vs_default": (round(float(speedup_vs_default), 3)
                                  if speedup_vs_default is not None
                                  else None),
           "runs": 1, "updated_at": now}
    path = store_path(base_dir)
    with _lock:
        _memo[(path, key)] = rec
    if path is None:
        return rec
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with _lock:
        lock_fd = None
        try:
            try:
                import fcntl
            except ImportError:
                fcntl = None
            if fcntl is not None:
                try:
                    lock_fd = os.open(path + ".lock",
                                      os.O_CREAT | os.O_WRONLY)
                except OSError:
                    lock_fd = None
                if lock_fd is not None:
                    try:
                        fcntl.flock(lock_fd, fcntl.LOCK_EX)
                    except OSError:
                        os.close(lock_fd)
                        lock_fd = None
            store = _read_store(path) or _empty_store()
            prior = store["winners"].get(key)
            if prior is not None:
                rec = dict(rec, runs=int(prior.get("runs") or 0) + 1)
            store["winners"][key] = rec
            # bound the store: evict the longest-unobserved winners
            winners = store["winners"]
            if len(winners) > MAX_WINNERS:
                by_age = sorted(winners, key=lambda k:
                                winners[k].get("updated_at") or 0.0)
                for k in by_age[: len(winners) - MAX_WINNERS]:
                    del winners[k]
            store["updated_at"] = now
            store["runs"] = int(store.get("runs") or 0) + 1
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(store, f, indent=1, allow_nan=False)
                f.write("\n")
            os.replace(tmp, path)
            _memo[(path, key)] = rec
        finally:
            if lock_fd is not None:
                os.close(lock_fd)  # closing drops the flock
    return rec


def _platform():
    """The winners' platform label for this process: ``"cuda"`` when a
    card is visible, else ``"torch_cpu"`` (never one of the JAX package's
    backend names, so neither package reads the other's winners as its
    own). Kernel plans are made for CUDA launches only."""
    import torch

    return "cuda" if torch.cuda.is_available() else "torch_cpu"


def tune(kernel, shape_key, g_bucket, candidates, measure, default=None,
         platform=None, base_dir=None, reps=3, force=False):
    """Resolve the tile for a kernel bucket: persisted winner when one
    exists (zero search steps), else an iterative measured search over the
    candidate ladder.

    ``candidates`` is the FIXED-ORDER ladder of tile dicts;
    ``measure(tile)`` returns seconds for one kernel invocation at that
    tile (the caller owns data synthesis and the timing's sync);
    ``default`` marks the no-autotune tile so the winner's
    ``speedup_vs_default`` can be reported. Ties break deterministically
    to the earliest candidate. Returns ``(tile, record)`` where record
    carries ``searched``/``search_ms``/``search_steps``."""
    platform = platform or _platform()
    rec = winner(kernel, shape_key, g_bucket, platform=platform,
                 base_dir=base_dir)
    if rec is not None and not force:
        out = dict(rec, searched=False, search_steps=0)
        _note({"kernel": kernel, "kind": "reuse", "platform": platform,
               "shape": shape_key, "g_bucket": int(g_bucket),
               "tile": rec["tile"], "search_steps": 0})
        return dict(rec["tile"]), out
    if not force and not (search_enabled()
                          and (base_dir or store_path() is not None)):
        # searching disabled (or no store to persist into): default tile
        tile = dict(default or candidates[0])
        return tile, {"tile": tile, "searched": False, "search_steps": 0,
                      "search_ms": None, "reason": "search_disabled"}
    t0 = time.perf_counter()
    timed = []
    default_s = None
    for tile in candidates:
        samples = sorted(measure(dict(tile)) for _ in range(max(reps, 1)))
        med = samples[len(samples) // 2]
        timed.append((med, tile))
        if default is not None and dict(tile) == dict(default):
            default_s = med
    if default is not None and default_s is None:
        # default tile off the ladder (clipped by the shape): time it too so
        # the winner's speedup-vs-default is always reportable
        samples = sorted(measure(dict(default)) for _ in range(max(reps, 1)))
        default_s = samples[len(samples) // 2]
    best_s, best_tile = min(timed, key=lambda t: t[0])  # stable: first wins
    search_ms = (time.perf_counter() - t0) * 1e3
    speedup = (default_s / best_s if default_s and best_s else None)
    rec = record_winner(kernel, shape_key, g_bucket, best_tile,
                        platform=platform, base_dir=base_dir,
                        search_ms=search_ms, candidates=len(candidates),
                        speedup_vs_default=speedup)
    out = dict(rec, searched=True, search_steps=len(timed))
    _note({"kernel": kernel, "kind": "search", "platform": platform,
           "shape": shape_key, "g_bucket": int(g_bucket),
           "tile": rec["tile"], "candidates": len(candidates),
           "search_ms": rec["search_ms"],
           "speedup_vs_default": rec["speedup_vs_default"],
           "search_steps": len(timed)})
    return dict(best_tile), out



# ---------------------------------------------------------------------------
# the measuring half: ladders, trial plans and CUDA-event closures
# ---------------------------------------------------------------------------
# threads per block, fixed-order ladders
FACTOR_MIX_THREADS = (64, 128, 256)   # __launch_bounds__(256)
GL_PROX_THREADS = (128, 256, 512)     # multiples of 32, kMaxThreads 512

# the plan a launch takes while a candidate is measured: kernel -> tile
_trials: dict = {}


def mix_key(B, K, M, G=1):
    """``(kernel, shape_key, size)`` of a factor-mix launch: the single
    form by the batch's bucket, the lane form by the lanes' (its shape key
    carries the batch's bucket)."""
    if G == 1:
        return "factor_mix", f"k{int(K)}m{int(M)}", int(B)
    return ("factor_mix_lanes",
            f"k{int(K)}m{int(M)}b{_pow2_bucket(B)}", int(G))


def prox_key(lead, H, C, L, slabs_per_lane=0):
    """``(kernel, shape_key, size)`` of a GL-prox launch over ``lead``
    slabs of ``(H, C_in, L)``: the single form by the slab count's bucket,
    the lane form (``slabs_per_lane`` > 0) by the lanes'."""
    shape = f"h{int(H)}c{int(C)}l{int(L)}"
    if not slabs_per_lane:
        return "gl_prox", shape, int(lead)
    return ("gl_prox_lanes", f"{shape}s{int(slabs_per_lane)}",
            int(lead) // int(slabs_per_lane))


def plan_threads(kernel, shape_key, size):
    """The thread count a launch plan takes: the candidate under
    :func:`trial`, else the stored winner, else None (today's rule)."""
    tile = _trials.get(kernel)
    if tile is not None:
        return int(tile["threads"])
    return tuned_tile(kernel, shape_key, size, "threads", None)


def _clear_plans(kernel):
    if kernel.startswith("factor_mix"):
        from redcliff_tpu_torch.ops import factor_mix as fm

        fm._mix_args.cache_clear()
    else:
        from redcliff_tpu_torch.ops import pallas_prox as px

        px._prox_args.cache_clear()


class trial:
    """``with trial(kernel, {"threads": t}):`` every launch of ``kernel``
    (``"factor_mix"``, ``"factor_mix_lanes"``, ``"gl_prox"``,
    ``"gl_prox_lanes"``) takes ``t`` threads per block. The kernel's plan
    cache is emptied on entry and on exit, so the plans of the launches
    before and after are the stored ones."""

    def __init__(self, kernel, tile):
        self.kernel, self.tile = kernel, dict(tile)

    def __enter__(self):
        _trials[self.kernel] = self.tile
        _clear_plans(self.kernel)
        return self

    def __exit__(self, *exc):
        _trials.pop(self.kernel, None)
        _clear_plans(self.kernel)
        return False


# a spin of the stream before the timed launches, long enough (at most
# 2 GHz) to outlast their enqueue, so each event pair brackets the kernel's
# device time and not the host's launch of it
_QUEUE_SPIN_CYCLES = 10 ** 8


def _event_median_us(torch, fn, reps):
    """One warm-up call of ``fn``, a ``torch.cuda.synchronize()``, then the
    median of ``reps`` calls each timed by a CUDA event pair (us). The
    calls queue behind a spin of the stream, so they run back to back on
    the device: a pair times the launch's device work."""
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(_QUEUE_SPIN_CYCLES)
    for start, stop in pairs:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    times = sorted(start.elapsed_time(stop) * 1e3 for start, stop in pairs)
    return times[len(times) // 2]


def factor_mix_ladder(batch=None):
    """The factor mix's threads-per-block candidates."""
    return [{"threads": t} for t in FACTOR_MIX_THREADS]


def gl_prox_ladder(rows=None):
    """The GL prox's threads-per-block candidates."""
    return [{"threads": t} for t in GL_PROX_THREADS]


def measure_factor_mix(batch, k, m, lanes=1, device="cuda", reps=200):
    """A ``measure(tile)`` closure timing one launch of the factor-mix
    wrapper at ``w (B, K)``, ``p (K, B, 1, M)`` (``lanes`` > 1: the lane
    form, ``w (G, B, K)``, ``p (G, K, B, 1, M)``), in seconds. Each call's
    median in us lands in ``measure.samples[threads]``."""
    import numpy as np
    import torch

    from redcliff_tpu_torch.ops import factor_mix as fm

    rng = np.random.default_rng(0)
    lead = () if lanes == 1 else (int(lanes),)
    w = torch.from_numpy(rng.random(lead + (batch, k)).astype(
        np.float32)).to(device)
    p = torch.from_numpy(rng.normal(size=lead + (k, batch, 1, m)).astype(
        np.float32)).to(device)
    kernel = mix_key(batch, k, m, lanes)[0]
    run = ((lambda: fm.factor_mix(w, p)) if lanes == 1
           else (lambda: fm.factor_mix_lanes(w, p)))

    def measure(tile):
        with trial(kernel, tile):
            us = _event_median_us(torch, run, reps)
        measure.samples[int(tile["threads"])] = us
        return us / 1e6

    measure.samples = {}
    return measure


def measure_gl_prox(shape, lanes=1, device="cuda", reps=200, lam=0.01,
                    lr=0.002):
    """A ``measure(tile)`` closure timing one in-place launch of the GL-prox
    wrapper on a block of ``shape`` = ``(lead..., H, C_in, L)`` (``lanes``
    > 1: the lane form over ``(G,) + shape`` with every lane gated on), in
    seconds. Each call's median in us lands in ``measure.samples``."""
    import numpy as np
    import torch

    from redcliff_tpu_torch.ops import pallas_prox as px

    rng = np.random.default_rng(0)
    lead = () if lanes == 1 else (int(lanes),)
    W = torch.from_numpy(rng.normal(size=lead + tuple(shape)).astype(
        np.float32)).to(device)
    *_, H, C, L = shape
    slabs = int(np.prod(shape[:-3], dtype=np.int64))
    if lanes == 1:
        kernel = prox_key(slabs, H, C, L)[0]

        def run():
            px.gl_prox_(W, lam, lr)
    else:
        kernel = prox_key(slabs * lanes, H, C, L, slabs)[0]
        t = px.lane_thresholds(torch.full((lanes,), lr, device=device), lam)
        gate = torch.ones((lanes,), dtype=torch.bool, device=device)

        def run():
            px.gl_prox_lanes_(W, t, gate)

    def measure(tile):
        with trial(kernel, tile):
            us = _event_median_us(torch, run, reps)
        measure.samples[int(tile["threads"])] = us
        return us / 1e6

    measure.samples = {}
    return measure


def _default_threads(kernel, B=None, K=None, M=None, G=1, H=None, C=None,
                     L=None):
    """Today's plan's threads at a measured shape (contiguous, aligned
    operands): the tile no store changes."""
    if kernel.startswith("factor_mix"):
        from redcliff_tpu_torch.ops import factor_mix as fm

        return fm.mix_plan(B, M, B * M, M, 0,
                           K * B * M if G > 1 else 0)[1]
    from redcliff_tpu_torch.ops import pallas_prox as px

    return px.prox_plan(H, C, L, 0)[2]


def tune_factor_mix(batch, k, m, lanes=1, platform=None, base_dir=None,
                    device="cuda", reps=200, force=False):
    """Tune (or reuse) the factor mix's threads per block at ``(B, K, M)``
    (``lanes`` > 1: the lane form); returns ``(threads, record)``. A
    search's record carries each candidate's median us
    (``candidate_us``) beside the persisted winner."""
    kernel, shape_key, size = mix_key(batch, k, m, lanes)
    measure = measure_factor_mix(batch, k, m, lanes=lanes, device=device,
                                 reps=reps)
    default = {"threads": _default_threads(kernel, B=batch, K=k, M=m,
                                           G=lanes)}
    tile, rec = tune(kernel, shape_key, _pow2_bucket(size),
                     factor_mix_ladder(batch), measure, default=default,
                     platform=platform, base_dir=base_dir, reps=1,
                     force=force)
    _clear_plans(kernel)
    return int(tile["threads"]), dict(rec, candidate_us=dict(
        measure.samples), default_threads=default["threads"])


def tune_gl_prox(shape, lanes=1, platform=None, base_dir=None,
                 device="cuda", reps=200, force=False):
    """Tune (or reuse) the GL prox's threads per block on a block of
    ``shape`` = ``(lead..., H, C_in, L)`` (``lanes`` > 1: the lane form);
    returns ``(threads, record)`` as :func:`tune_factor_mix`."""
    import numpy as np

    *_, H, C, L = shape
    slabs = int(np.prod(shape[:-3], dtype=np.int64))
    kernel, shape_key, size = (prox_key(slabs, H, C, L) if lanes == 1 else
                               prox_key(slabs * lanes, H, C, L, slabs))
    measure = measure_gl_prox(shape, lanes=lanes, device=device, reps=reps)
    default = {"threads": _default_threads(kernel, H=H, C=C, L=L)}
    tile, rec = tune(kernel, shape_key, _pow2_bucket(size),
                     gl_prox_ladder(), measure, default=default,
                     platform=platform, base_dir=base_dir, reps=1,
                     force=force)
    _clear_plans(kernel)
    return int(tile["threads"]), dict(rec, candidate_us=dict(
        measure.samples), default_threads=default["threads"])


def _pow2_bucket(n):
    """Bucket a size onto the power-of-two ladder (the same discipline as
    the grid's G-bucket), so near-identical shapes share one winner."""
    n = max(int(n), 1)
    b = 1
    while b < n:
        b <<= 1
    return b


def tune_for_model(model_config, batch_size, prox_penalty=None,
                   base_dir=None, device=None, lanes=1):
    """Tune (or reuse) both kernels' plans at the shapes a REDCLIFF-S fit
    of this config launches: the factor mix at ``(batch_size, K, M)`` and,
    with the GL prox on cMLP factors, the prox on the first-layer block
    ``(K, C_out, H, C_in, L)``; ``lanes`` > 1 (the grid's execution width)
    tunes the lane forms. A no-op unless ``device`` is a card, searching is
    enabled and a store resolves."""
    import torch

    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda" or not search_enabled() \
            or store_path(base_dir) is None:
        return
    cfg = model_config
    if (prox_penalty == "GL"
            and getattr(cfg, "factor_network_type", None) == "cMLP"):
        tune_gl_prox((cfg.num_factors, cfg.num_series, cfg.gen_hidden[0],
                      cfg.num_series, cfg.gen_lag), lanes=lanes,
                     base_dir=base_dir, device=dev)
    sims = (cfg.num_sims if cfg.forward_pass_mode
            == "apply_factor_weights_after_sim_completion" else 1)
    tune_factor_mix(int(batch_size), cfg.num_factors, sims * cfg.num_series,
                    lanes=lanes, base_dir=base_dir, device=dev)
