"""Learned per-(shape, G-bucket) step/compile cost model (the port's copy of
``redcliff_tpu/obs/costmodel.py``).

The grid records what each program family costs (observed epoch time per
execution width; the one-time cost of its CUDA-graph captures); this module
folds those observations into a persistent, versioned store and answers the
questions scheduling asks — "what will one epoch of this shape at this
width cost?", "what does a cold capture of its programs cost?", "when will
this fit finish?".

**Store** (``cost_model_v<VERSION>.json``), the JAX file format unchanged:
under ``REDCLIFF_COST_MODEL_DIR``, else the compile-cache base directory
(``compile_cache_dir`` / ``REDCLIFF_COMPILE_CACHE``), so it accumulates
across runs. Buckets are keyed ``<platform>|<shape_key>|g<width>|
<precision>``. The port's platform label is ``"cuda"`` on the card and
``"torch_<type>"`` elsewhere (:func:`platform_label`; ``"torch_cpu"`` on the
CPU), never one of JAX's backend names (``"cpu"``, ``"gpu"``, ``"tpu"``), so
the two packages can share a store file and never read each other's rows as
their own. Updates are read-modify-write under a best-effort ``flock`` with
an atomic replace; the store is bounded (:data:`MAX_BUCKETS`) and advisory
— a corrupt or missing file means "no prediction", never an error on a
training path.

**Predictions** (:class:`CostModel`): the exact bucket's mean, else the
nearest-width bucket of the same (platform, shape, precision) scaled by the
width ratio, clamped to the adjacent rung (ratio <= 2), else ``None``.
``predict_compile_ms`` prices the first capture of a width's programs;
``compile_warm`` says whether the store has seen it.

The grid scores the store's prediction against each check window's epoch
(``cost_model`` events, ``dispatch_stats["eta"]``) and folds its per-width
epoch times and captures into the store at the fit's end; the predictive
scheduling policy (``parallel/policy.py``) steers widths and compactions by
it. The report-fed entry points, :func:`fit_from_report` and
:func:`update_store_from_report`, train it from an obs report's cost table
(``obs/report.py``), whose rows a mixed grid labels by precision era.

The code is the JAX module's, bit for bit, but for :func:`platform_label`
(the port's labels, ``cuda`` and ``torch_<type>``). stdlib only.
"""
from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["STORE_VERSION", "STORE_NAME", "ENV_STORE_DIR", "MAX_BUCKETS",
           "CostModel", "store_path", "load", "update_store",
           "update_store_from_report", "fit_from_report", "bucket_key",
           "rows_from_dispatch_stats", "platform_label"]

STORE_VERSION = 1
STORE_NAME = f"cost_model_v{STORE_VERSION}.json"
# store dir override; default rides the compile-cache base dir so the model
# accumulates exactly where the compiled programs it prices live
ENV_STORE_DIR = "REDCLIFF_COST_MODEL_DIR"
ENV_CACHE_DIR = "REDCLIFF_COMPILE_CACHE"  # literal: this module stays
#                                           stdlib-only
MAX_BUCKETS = 512

_lock = threading.Lock()


def bucket_key(platform, shape_key, g_bucket, precision="f32"):
    """The store's bucket id:
    ``<platform>|<shape_key>|g<width>|<precision>``.

    ``precision`` is the matmul-precision label of the epochs being priced
    (utils/precision.py ``precision_label``: "f32" | "mixed" | raw string).
    Without it, bf16 and f32 epoch costs of the same program family merged
    into one bucket and poisoned every ETA and planner ordering; legacy
    3-segment keys are backfilled to "f32" on read —
    every pre-precision fit trained at the backend default."""
    return f"{platform}|{shape_key}|g{int(g_bucket)}|{precision or 'f32'}"


def store_path(base_dir=None):
    """Resolve the store file path, or None when no base directory is
    known (no compile cache configured anywhere)."""
    base = (base_dir or os.environ.get(ENV_STORE_DIR)
            or os.environ.get(ENV_CACHE_DIR) or None)
    if not base:
        return None
    if str(base).endswith(".json"):
        return str(base)
    return os.path.join(base, STORE_NAME)


def _empty_store():
    return {"version": STORE_VERSION, "updated_at": None, "runs": 0,
            "buckets": {}}


def _backfill_precision(store):
    """Normalize pre-precision buckets in place: a 3-segment legacy key
    (``platform|shape|gN``) becomes ``platform|shape|gN|f32`` and the
    bucket gains ``precision: "f32"`` — every fit recorded before the
    precision axis existed trained at the backend default."""
    buckets = store["buckets"]
    for key in list(buckets):
        b = buckets[key]
        if not isinstance(b, dict):
            continue
        if "precision" not in b:
            b["precision"] = "f32"
        want = bucket_key(b.get("platform"), b.get("shape"),
                          b.get("g_bucket") or 0, b["precision"])
        if key != want and want not in buckets:
            buckets[want] = buckets.pop(key)
    return store


def _read_store(path):
    """Parse a store file; None on missing/corrupt/wrong-version (the store
    is advisory — a bad file means 'no model', never an exception).
    Legacy precision-less buckets are backfilled to "f32" on read."""
    try:
        with open(path) as f:
            store = json.load(f)
    except (OSError, ValueError):
        return None
    if not (isinstance(store, dict)
            and store.get("version") == STORE_VERSION
            and isinstance(store.get("buckets"), dict)):
        return None
    return _backfill_precision(store)


class CostModel:
    """Read-side view over a store dict (or an in-memory equivalent)."""

    def __init__(self, store, path=None):
        self._store = store or _empty_store()
        self.path = path

    @property
    def buckets(self):
        return self._store["buckets"]

    @property
    def runs(self):
        return int(self._store.get("runs") or 0)

    @property
    def updated_at(self):
        return self._store.get("updated_at")

    def staleness_s(self, now=None):
        """Seconds since the store last absorbed an observation (None for
        a never-updated store)."""
        if self.updated_at is None:
            return None
        return max((now if now is not None else time.time())
                   - float(self.updated_at), 0.0)

    # ------------------------------------------------------------------
    def _candidates(self, shape_key, platform, precision="f32"):
        """Buckets matching (platform?, shape, precision), best-sampled
        first. Precision is part of the cost identity: a bf16 epoch and an
        f32 epoch of the same program family must never predict each
        other."""
        out = []
        for b in self.buckets.values():
            if b.get("shape") != shape_key:
                continue
            if platform is not None and b.get("platform") != platform:
                continue
            if precision is not None \
                    and (b.get("precision") or "f32") != precision:
                continue
            out.append(b)
        # best-sampled first; platform name breaks ties deterministically
        out.sort(key=lambda b: (-int(b.get("epochs") or 0),
                                str(b.get("platform"))))
        return out

    def epoch_ms_mean(self, shape_key, g_bucket, platform=None,
                      precision="f32"):
        """Mean observed epoch time for the EXACT bucket, or None."""
        for b in self._candidates(shape_key, platform, precision):
            if int(b.get("g_bucket") or 0) == int(g_bucket) \
                    and (b.get("epochs") or 0) > 0:
                return float(b["epoch_ms_total"]) / int(b["epochs"])
        return None

    # how far from an observed rung the linear width-scaling fallback may
    # reach: the ladder is log-spaced (powers of two, mesh-adjusted), so one
    # rung away is a 2x width ratio — the largest step where "per-lane cost
    # is ~flat" is still evidence rather than extrapolation. Scaling bucket
    # 4's mean out to 256 (a 64x ratio) answered confidently-wrong ETAs at
    # the ladder extremes; past the clamp the answer is None — no
    # evidence, never a wild guess.
    ADJACENT_RUNG_RATIO = 2.0

    def predict_epoch_ms(self, shape_key, g_bucket, platform=None,
                         precision="f32"):
        """Predicted wall ms for one epoch of ``shape_key`` at execution
        width ``g_bucket``: exact bucket mean, else the nearest-width
        bucket of the same (shape, precision) scaled linearly by the width
        ratio — CLAMPED to adjacent-rung scaling
        (:data:`ADJACENT_RUNG_RATIO`) — else None (no evidence)."""
        exact = self.epoch_ms_mean(shape_key, g_bucket, platform=platform,
                                   precision=precision)
        if exact is not None:
            return exact
        want = int(g_bucket)
        best = None
        for b in self._candidates(shape_key, platform, precision):
            w = int(b.get("g_bucket") or 0)
            n = int(b.get("epochs") or 0)
            if w <= 0 or n <= 0:
                continue
            if max(w, want) / min(w, want) > self.ADJACENT_RUNG_RATIO:
                continue  # beyond the adjacent rung: extrapolation, not
                #           evidence (None beats a 64x-scaled guess)
            # nearest width on the (log-spaced) bucket ladder
            d = abs(w - want) / max(w, want)
            if best is None or d < best[0]:
                best = (d, w, float(b["epoch_ms_total"]) / n)
        if best is None:
            return None
        _, w, mean_ms = best
        return mean_ms * (want / w)

    def compile_warm(self, shape_key, g_bucket, platform=None,
                     precision="f32"):
        """Whether the EXACT (platform?, shape, width, precision) bucket has
        compile evidence: the program family was compiled (captured) before
        in this store's lifetime. The JAX package's persistent XLA cache
        makes such a first touch a warm retrieval; the port keeps no
        captured graph across processes, so its grid tells the predictive
        scheduling policy (parallel/policy.py) which widths its epoch
        engine holds instead, and this answer serves callers that bring
        no engine."""
        for b in self._candidates(shape_key, platform, precision):
            if int(b.get("g_bucket") or 0) == int(g_bucket) \
                    and int(b.get("compiles") or 0) > 0:
                return True
        return False

    def predict_compile_ms(self, shape_key, g_bucket, platform=None,
                           precision="f32"):
        """Predicted wall ms of ONE cold compile of the bucket's program
        family (exact bucket, else nearest-width same-shape unscaled —
        compile cost is dominated by the program, not the lane count), or
        None."""
        want = int(g_bucket)
        best = None
        for b in self._candidates(shape_key, platform, precision):
            n = int(b.get("compiles") or 0)
            if n <= 0:
                continue
            w = int(b.get("g_bucket") or 0)
            d = 0.0 if w == want else abs(w - want) / max(w, want, 1)
            mean = float(b.get("compile_ms_total") or 0.0) / n
            if best is None or d < best[0]:
                best = (d, mean)
        return best[1] if best is not None else None

    def predict_fit_eta(self, shape_key, g_bucket, epochs, platform=None,
                        cold_programs=0, precision="f32"):
        """Predicted wall SECONDS for ``epochs`` epochs of ``shape_key`` at
        width ``g_bucket`` plus ``cold_programs`` cold compiles; None when
        the model has no step-cost evidence for the shape."""
        em = self.predict_epoch_ms(shape_key, g_bucket, platform=platform,
                                   precision=precision)
        if em is None:
            return None
        eta_ms = em * max(int(epochs), 0)
        if cold_programs:
            cm = self.predict_compile_ms(shape_key, g_bucket,
                                         platform=platform,
                                         precision=precision)
            if cm is not None:
                eta_ms += cm * int(cold_programs)
        return eta_ms / 1e3

    def accuracy_rows(self):
        """Store-side accuracy context per bucket (sample counts + means;
        residual MAPE lives in the run's ``cost_model`` events, which obs
        report joins with these rows)."""
        rows = []
        for key in sorted(self.buckets):
            b = self.buckets[key]
            n = int(b.get("epochs") or 0)
            rows.append({
                "bucket": key, "platform": b.get("platform"),
                "shape": b.get("shape"), "g_bucket": b.get("g_bucket"),
                "precision": b.get("precision") or "f32",
                "epochs": n,
                "mean_epoch_ms": (round(b["epoch_ms_total"] / n, 3)
                                  if n else None),
                "compiles": int(b.get("compiles") or 0),
                "mean_compile_ms": (
                    round(b["compile_ms_total"] / b["compiles"], 3)
                    if b.get("compiles") else None),
                "cache_hits": int(b.get("cache_hits") or 0),
                "cache_misses": int(b.get("cache_misses") or 0),
                "runs": int(b.get("runs") or 0),
                "updated_at": b.get("updated_at"),
            })
        return rows


def load(base_dir=None):
    """Load the persistent store as a :class:`CostModel`, or None when no
    store directory is configured / no usable store file exists yet."""
    path = store_path(base_dir)
    if path is None or not os.path.exists(path):
        return None
    store = _read_store(path)
    if store is None:
        return None
    return CostModel(store, path=path)


def platform_label(device):
    """The store's platform label for a fit on ``device`` (a
    ``torch.device`` or a string): ``"cuda"`` on a card, else
    ``"torch_<type>"``. Never one of the JAX package's backend names, so
    neither package reads the other's rows as its own."""
    kind = getattr(device, "type", None) or str(device).split(":")[0]
    return "cuda" if kind == "cuda" else f"torch_{kind}"


def fit_from_report(report, platform="any", precision="f32"):
    """In-memory model fit from one obs-report dict's ``cost_table`` (no
    persistence) — offline training / tests. ``precision`` labels the
    report's epochs (a row's own ``precision`` wins: a mixed grid's report
    labels its eras). ``platform`` is one of the port's labels
    (:func:`platform_label`)."""
    model = CostModel(_empty_store())
    _merge_rows(model._store,
                _rows_from_cost_table(report, precision=precision),
                platform, now=time.time())
    return model


# ---------------------------------------------------------------------------
# write side
# ---------------------------------------------------------------------------
def _rows_from_cost_table(report, precision="f32"):
    rows = []
    for r in (report or {}).get("cost_table") or []:
        rows.append({
            "shape": r.get("shape"), "g_bucket": r.get("g_bucket"),
            # per-row label when the report carries one (future reports),
            # else the caller's fit-level label
            "precision": r.get("precision") or precision,
            "epochs": r.get("epochs") or 0,
            "epoch_ms": r.get("total_epoch_ms") or 0.0,
            "compiles": r.get("compiles") or 0,
            "compile_ms": r.get("compile_ms") or 0.0,
            "cache_hits": r.get("cache_hits") or 0,
            "cache_misses": r.get("cache_misses") or 0,
        })
    return rows


def rows_from_dispatch_stats(shape_key, stats, precision="f32"):
    """Store-update rows from one fit's ``dispatch_stats``: one row per
    execution width from the exact per-width accumulators; the fit-level
    compile/cache totals attach to the WIDEST row (cold compiles happen at
    the fit's starting bucket, before compaction shrinks it).
    ``precision`` stamps the rows' matmul-precision label so mixed and f32
    epochs land in distinct buckets.

    Each width's FIRST epoch is excluded when more epochs exist: it
    carries the compile / cache-priming skew (measured 20x the steady
    state on short fits), and a store that averages it in systematically
    overpredicts — compile cost is learned separately from the compile
    accumulators."""
    by_n = stats.get("epochs_by_width") or {}
    by_ms = stats.get("epoch_ms_by_width") or {}
    by_first = stats.get("first_epoch_ms_by_width") or {}
    widths = sorted((int(w) for w in by_n), reverse=True)
    rows = []
    for i, w in enumerate(widths):
        n = int(by_n.get(str(w), 0))
        if n <= 0:
            continue
        total = float(by_ms.get(str(w), 0.0))
        first = by_first.get(str(w))
        if n > 1 and isinstance(first, (int, float)) \
                and total - first > 0:
            n -= 1
            total -= float(first)
        rows.append({
            "shape": shape_key, "g_bucket": w, "precision": precision,
            "epochs": n,
            "epoch_ms": total,
            "compiles": int(stats.get("compiles") or 0) if i == 0 else 0,
            "compile_ms": float(stats.get("compile_ms") or 0.0)
            if i == 0 else 0.0,
            "cache_hits": int(stats.get("cache_hits") or 0) if i == 0 else 0,
            "cache_misses": int(stats.get("cache_misses") or 0)
            if i == 0 else 0,
        })
    return rows


def _merge_rows(store, rows, platform, now):
    changed = False
    for r in rows:
        shape, width = r.get("shape"), r.get("g_bucket")
        if not shape or not width or not (r.get("epochs")
                                          or r.get("compiles")):
            continue
        precision = r.get("precision") or "f32"
        key = bucket_key(platform, shape, width, precision)
        b = store["buckets"].get(key)
        if b is None:
            b = store["buckets"][key] = {
                "platform": platform, "shape": shape,
                "g_bucket": int(width), "precision": precision,
                "epochs": 0, "epoch_ms_total": 0.0,
                "compiles": 0, "compile_ms_total": 0.0, "cache_hits": 0,
                "cache_misses": 0, "runs": 0}
        b["epochs"] += int(r.get("epochs") or 0)
        b["epoch_ms_total"] = round(
            b["epoch_ms_total"] + float(r.get("epoch_ms") or 0.0), 3)
        b["compiles"] += int(r.get("compiles") or 0)
        b["compile_ms_total"] = round(
            b["compile_ms_total"] + float(r.get("compile_ms") or 0.0), 3)
        b["cache_hits"] += int(r.get("cache_hits") or 0)
        b["cache_misses"] += int(r.get("cache_misses") or 0)
        b["runs"] += 1
        b["updated_at"] = now
        changed = True
    if not changed:
        return False
    # bound the store: evict the longest-unobserved buckets past the cap
    buckets = store["buckets"]
    if len(buckets) > MAX_BUCKETS:
        by_age = sorted(buckets, key=lambda k: buckets[k].get("updated_at")
                        or 0.0)
        for k in by_age[: len(buckets) - MAX_BUCKETS]:
            del buckets[k]
    store["updated_at"] = now
    store["runs"] += 1
    return True


def update_store(base_dir, rows, platform, now=None):
    """Fold observation ``rows`` (see :func:`rows_from_dispatch_stats`) into
    the persistent store under ``base_dir`` — read-modify-write under a
    best-effort flock, atomic replace, corrupt stores restarted fresh.
    Returns the store path, or None when no base dir resolves."""
    path = store_path(base_dir)
    if path is None:
        return None
    now = time.time() if now is None else now
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
                    lock_fd = None  # lockless fallback (RO dir): atomic
                    #                 replace still prevents torn files
                if lock_fd is not None:
                    try:
                        fcntl.flock(lock_fd, fcntl.LOCK_EX)
                    except OSError:
                        # flock unsupported (some network mounts): release
                        # the fd NOW — the finally below only sees lock_fd
                        os.close(lock_fd)
                        lock_fd = None
            store = _read_store(path) or _empty_store()
            if not _merge_rows(store, rows, platform, now):
                return path
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(store, f, indent=1, allow_nan=False)
                f.write("\n")
            os.replace(tmp, path)
            return path
        finally:
            if lock_fd is not None:
                os.close(lock_fd)  # closing drops the flock


def update_store_from_report(base_dir, report, platform, now=None,
                             precision="f32"):
    """Fold one obs-report's cost table into the persistent store — the
    offline "train the model from a finished run's telemetry" path.
    ``precision`` labels the report's unlabelled rows (read it off the
    run's ``fit_start.precision_mode``); ``platform`` is one of the port's
    labels (:func:`platform_label`)."""
    return update_store(base_dir,
                        _rows_from_cost_table(report, precision=precision),
                        platform, now=now)
