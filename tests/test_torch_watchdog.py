"""The port's liveness watchdog and retry policy (redcliff_tpu_torch/runtime/
{watchdog,retry}.py) against the JAX package's (redcliff_tpu/runtime/
{watchdog,retry}.py), on the same operations.

The registry runs on a fake clock; the escalation ladder runs both
packages' watchdogs on one fake clock with a 10 ms poll, the test moving
the clock (no test waits on a real budget of seconds). The armed child fit
(``python -m redcliff_tpu_torch.runtime.faultinject --sharded``) wedges its
prefetcher with ``hang_in:prefetch`` and must exit with the taxonomy's
hang code, leaving a ``hang`` event and a flight record, inside its own
60 s limit (about 7 s here).
"""
import importlib
import os
import subprocess
import sys
import time

import pytest

pytest.importorskip("torch")

from redcliff_tpu.runtime import watchdog as jwd  # noqa: E402
from redcliff_tpu_torch.obs import flight  # noqa: E402
from redcliff_tpu_torch.obs.logging import read_jsonl  # noqa: E402
from redcliff_tpu_torch.runtime import watchdog as twd  # noqa: E402

# the modules, not the ``retry`` functions both packages export under the
# same name
jretry = importlib.import_module("redcliff_tpu.runtime.retry")
tretry = importlib.import_module("redcliff_tpu_torch.runtime.retry")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _registry_story(mod):
    """The JAX registry tests' operations, with every observation."""
    clock = _Clock()
    reg = mod.HeartbeatRegistry(clock=clock, default_budget_s=5.0)
    seen = []
    reg.stamp("a")
    reg.register("b", budget_s=1.0)
    clock.t = 2.0
    seen.append(reg.overdue())
    reg.stamp("b")
    seen.append(reg.overdue())
    clock.t = 20.0
    seen.append(sorted(reg.overdue()))
    reg.retire("a")
    seen.append(reg.overdue())
    reg.refresh()
    seen.append(reg.overdue())
    seen.append(reg.counts())
    # overrides: per component, and a host-scoped beat falls back to its
    # base component's budget
    reg.budgets.update({"fast": 2.0, "shard_loader": 3.0})
    reg.stamp("fast")
    reg.stamp(mod.host_component(2, "shard_loader"))
    reg.stamp("slow")
    clock.t = 24.0
    seen.append(sorted(reg.overdue()))
    seen.append(sorted(reg.ages().items()))
    seen.append([mod.host_of(n) for n in ("host2:shard_loader", "hostx:a",
                                          "prefetch", "host:b")])
    reg.clear()
    seen.append((reg.counts(), reg.ages()))
    return seen


def test_registry_overdue_retire_refresh_and_budgets_match_jax():
    assert _registry_story(twd) == _registry_story(jwd)


def test_exit_taxonomy_and_constants_match_jax():
    codes = [0, 1, 17, 18, 19, 20, 21, 77, -9, -15, -2, -64, None]
    assert [twd.classify_exit(c) for c in codes] == \
        [jwd.classify_exit(c) for c in codes]
    for name in ("EXIT_CLEAN", "EXIT_PREEMPTED", "EXIT_NUMERICS_ABORT",
                 "EXIT_HANG", "EXIT_DEADLINE", "EXIT_HOST_LOST",
                 "CORE_COMPONENTS", "COMPILE_COMPONENT", "COMPILE_BUDGET_S",
                 "DEFAULT_BUDGET_S", "ENV_WATCHDOG"):
        assert getattr(twd, name) == getattr(jwd, name), name
    assert twd.REGISTRY.budgets.get("compile") == twd.COMPILE_BUDGET_S


@pytest.mark.parametrize("spec", [
    None, "", "0", "1", "poll_s=0.5,grace_s=2,budget.prefetch=3",
    "poll_s=0.5,grace_s=2,budget_s=9,budget.prefetch=3,host_loss=0",
    "budget.shard_loader=7, grace_s=4 ,junk,host_loss=off"])
def test_policy_from_env_matches_jax(monkeypatch, spec):
    if spec is None:
        monkeypatch.delenv("REDCLIFF_WATCHDOG", raising=False)
    else:
        monkeypatch.setenv("REDCLIFF_WATCHDOG", spec)
    got = twd.WatchdogPolicy.from_env()
    want = jwd.WatchdogPolicy.from_env()
    assert (got is None) == (want is None)
    if want is not None:
        assert vars(got) == vars(want)
    with twd.maybe_start() as live:
        assert (live is None) == (want is None)


class _Guard:
    preempted = False
    signum = "unset"


class _Log:
    active = True

    def __init__(self):
        self.events = []

    def log(self, event, **kw):
        self.events.append((event, sorted(kw["components"])
                            if "components" in kw else None))

    def close(self):
        pass


def _wait(cond, limit=10.0):
    deadline = time.monotonic() + limit
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.005)
    return cond()


def _ladder(mod, compile_live=False):
    """One wedged component on a fake clock: the incident and the preempt
    latch at the first poll past its budget, the hard exit after the grace;
    with a live compile scope, nothing until the compile retires."""
    clock = _Clock()
    reg = mod.HeartbeatRegistry(clock=clock, default_budget_s=5.0)
    reg.budgets["compile"] = 100.0
    reg.stamp("wedged")
    reg.stamp("alive")
    if compile_live:
        reg.stamp("compile")
    guard, log, exits = _Guard(), _Log(), []
    wd = mod.Watchdog(policy=mod.WatchdogPolicy(poll_s=0.01, grace_s=2.0),
                      registry=reg, guard=guard, logger=log,
                      exit_fn=exits.append, clock=clock)
    story = []
    with wd:
        clock.t = 4.0          # within budget: nothing
        time.sleep(0.05)
        story.append((wd.incidents, guard.preempted, list(exits)))
        reg.stamp("alive")
        clock.t = 6.0          # "wedged" past its 5 s budget
        if compile_live:
            time.sleep(0.05)   # excused while the compile is live
            story.append((wd.incidents, guard.preempted, list(exits)))
            reg.retire("compile")
        # the incident is logged, then the guard latched
        assert _wait(lambda: wd.incidents == 1 and guard.preempted)
        story.append((wd.incidents, guard.preempted, guard.signum,
                      list(exits)))
        reg.stamp("alive")
        clock.t = 7.0          # inside the grace: no exit yet
        time.sleep(0.05)
        story.append((wd.incidents, list(exits)))
        reg.stamp("alive")
        clock.t = 8.5          # the grace is spent: hard exit
        assert _wait(lambda: bool(exits))
    # after the exit the ladder rearms (exit_fn returned): only the first
    # cycle is compared
    story.append((exits[:1], [e for e, _ in log.events][:2],
                  [c for _, c in log.events][:2]))
    return story


@pytest.mark.parametrize("compile_live", [False, True])
def test_escalation_latch_then_exit_matches_jax(compile_live):
    got = _ladder(twd, compile_live)
    assert got == _ladder(jwd, compile_live)
    assert got[-1][0] == [twd.EXIT_HANG]
    assert got[-1][1] == ["hang", "hang_exit"]


def test_op_scope_stamps_retires_and_refreshes():
    reg = twd.REGISTRY
    before = reg.counts().get("compile", 0)
    reg.stamp("stale_sibling")
    with reg._lock:
        reg._beats["stale_sibling"][0] -= 1000.0
    try:
        with twd.op_scope(twd.COMPILE_COMPONENT):
            assert "compile" in reg.ages()
        assert "compile" not in reg.ages()
        assert reg.counts()["compile"] == before + 1
        assert reg.ages()["stale_sibling"] < 100.0
    finally:
        reg.retire("stale_sibling")
    assert "MainThread" in twd.dump_stacks()


@pytest.mark.parametrize("case", ["success", "retryable", "give_up",
                                  "deadline", "falsy"])
def test_retry_outcomes_match_jax(case):
    """The copied retry loop: the same attempts, backoffs, outcome log and
    raise on a fake clock and sleep, for every exit of the loop."""
    def run(mod):
        clock = _Clock()
        slept = []

        def sleep(s):
            slept.append(s)
            clock.t += s

        policy = mod.RetryPolicy(max_attempts=4, base_delay_s=1.0,
                                 deadline_s=2.5 if case == "deadline"
                                 else None)

        def fn(k):
            clock.t += 0.25
            if case == "give_up" and k == 1:
                raise mod.GiveUp("terminal")
            if case in ("retryable", "deadline") and k < 3:
                raise OSError(f"transient {k}")
            return ("ok", k) if case != "falsy" else None

        try:
            out = mod.retry(fn, policy, sleep=sleep, monotonic=clock,
                            retryable=lambda e: isinstance(e, OSError),
                            is_success=(None if case != "falsy"
                                        else bool),
                            info_of=repr)
        except OSError as e:
            return ("raised", str(e), slept)
        return (out.log(), out.value, slept, out.policy)

    assert run(tretry) == run(jretry)
    assert tretry.PROBE_RETRY_POLICY.as_dict() == \
        jretry.PROBE_RETRY_POLICY.as_dict()
    assert tretry.PROBE_RETRY_POLICY.schedule() == \
        jretry.PROBE_RETRY_POLICY.schedule()


def test_armed_hang_child_exits_with_the_hang_code(tmp_path):
    """``hang_in:prefetch`` wedges the sharded child's prefetcher: the
    watchdog logs a ``hang`` event, dumps the flight record next to the
    fit's metrics and hard-exits 19 after its grace."""
    env = dict(os.environ, REDCLIFF_FAULT_INJECT="hang_in:prefetch:60",
               REDCLIFF_WATCHDOG="poll_s=0.2,grace_s=1,budget.prefetch=1",
               REDCLIFF_QUALITY="0", PYTHONPATH=REPO)
    for k in ("REDCLIFF_FAULT_MARKER", "REDCLIFF_AUTOTUNE_DIR",
              "REDCLIFF_COST_MODEL_DIR"):
        env.pop(k, None)
    proc = subprocess.run(
        [sys.executable, "-m", "redcliff_tpu_torch.runtime.faultinject",
         "--checkpoint-dir", str(tmp_path), "--sharded", "--device", "cpu",
         "--max-iter", "1"],
        env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode == twd.EXIT_HANG, proc.stderr[-2000:]
    assert twd.classify_exit(proc.returncode) == "hang"
    events = [r["event"] for r in read_jsonl(str(tmp_path))]
    assert events[-2:] == ["hang", "hang_exit"], events
    hang = next(r for r in read_jsonl(str(tmp_path))
                if r["event"] == "hang")
    assert "prefetch" in hang["components"] and "prefetch" in hang["stacks"]
    assert os.path.exists(tmp_path / flight.FLIGHT_RECORD_NAME)
