"""The banded condenser in the port: the twin
``redcliff_tpu_torch/experiments/banded_condense.py`` of the JAX
package's ``experiments/banded_condense.py``, and the sweep script
``redcliff_tpu_torch/experiments/run_banded_sweep.sh`` beside it.

On one crafted ``evals/`` tree (a ``full_comparrisson_summary.pkl`` per
system across the three complexity bands; dynamic-readout summaries with
their ``_conventions`` and scalar fields on some systems) both condensers
write the same JSON, byte for byte. The JAX condenser runs as its own
process, as its users run it; the port's runs with jax and matplotlib
blocked.
"""
import ast
import json
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest

from redcliff_tpu_torch.experiments import banded_condense as BC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(REPO, "experiments", "banded_condense.py")
JAX_SWEEP = os.path.join(REPO, "experiments", "run_banded_sweep.sh")
PORT_SWEEP = os.path.join(REPO, "redcliff_tpu_torch", "experiments",
                          "run_banded_sweep.sh")
OFFDIAG = "key_stats_estGC_normOffDiag_vs_trueGC_normOffDiag"

# per system, each algorithm's per-factor optimal F1s: every band, an
# algorithm missing on one system, a non-finite F1 (its improvement is
# dropped from the band table) and a shorter list than the baseline's
SYSTEMS = {
    "numF2_numSF2_numN6_numE2_synSys6_2_2": {
        "REDCLIFF_S_CMLP": [0.5, 0.625], "CMLP": [0.25, 0.5],
        "CLSTM": [0.375, 0.25], "DGCNN": [0.5, 0.75]},
    "numF2_numSF2_numN12_numE11_synSys12_11_2": {
        "REDCLIFF_S_CMLP": [0.4, 0.3], "CMLP": [0.35, 0.45],
        "CLSTM": [0.2, 0.1], "DCSFA": [0.3, 0.3]},
    "numF2_numSF2_numN3_numE1_synSys3_1_2": {
        "REDCLIFF_S_CMLP": [0.46, 0.5], "CMLP": [0.7, 0.72],
        "CLSTM": [float("nan"), 0.4], "DGCNN": [0.722]},
    "numF3_numSF3_numN6_numE2_synSys6_2_3": {
        "REDCLIFF_S_CMLP": [0.3, 0.2, 0.1], "CMLP": [0.1, 0.2, 0.3],
        "DGCNN": [0.25, 0.125, 0.5]},
    "numF2_numSF2_numN6_numE4_synSys6_4_2": {
        "REDCLIFF_S_CMLP": [0.397, 0.41], "CMLP": [0.408, 0.2],
        "CLSTM": [0.3, 0.35]},
    "numF2_numSF2_numN6_numE6_synSys6_6_2": {
        "REDCLIFF_S_CMLP": [0.6, 0.2], "DGCNN": [0.1, 0.9]},
}
# the dynamic-readout summaries, on three of the systems
DYNAMIC = {
    "numF2_numSF2_numN6_numE2_synSys6_2_2": {
        "_conventions": {"scoring_window": "post-lag"},
        "REDCLIFF_S_CMLP": {
            "state_score_pearson": {"mean": 0.5, "sem": 0.1, "n": 4},
            "edge_dynamics_spearman": {"mean": 0.25, "sem": 0.05, "n": 4},
            "scoring_window": 16},
        "CMLP": {"edge_dynamics_spearman": {"mean": 0.125, "sem": 0.0,
                                            "n": 4},
                 "state_score_pearson": {"mean": None, "sem": None,
                                         "n": 0}}},
    "numF2_numSF2_numN3_numE1_synSys3_1_2": {
        "_conventions": {"scoring_window": "post-lag"},
        "REDCLIFF_S_CMLP": {
            "state_score_pearson": {"mean": 0.75, "sem": 0.2, "n": 4},
            "edge_dynamics_spearman": {"mean": -0.1, "sem": 0.3, "n": 4},
            "scoring_window": 16},
        "DGCNN": {"state_score_pearson": {"mean": 0.3, "sem": 0.1, "n": 4}}},
    "numF2_numSF2_numN6_numE4_synSys6_4_2": {
        "REDCLIFF_S_CMLP": {
            "state_score_pearson": {"mean": 0.1, "sem": 0.02, "n": 4}},
        "note": "a scalar beside the algorithms"},
}


def _summary(alg_vals):
    """A full_comparrisson_summary dict in the cross_alg driver's layout."""
    by_alg = {}
    for alg, vals in alg_vals.items():
        vals = np.asarray(vals, dtype=np.float64)
        by_alg[alg] = {
            "f1_vals_across_factors": vals.tolist(),
            "f1_mean_across_factors": float(vals.mean()),
            "f1_mean_std_err_across_factors": float(
                vals.std() / np.sqrt(len(vals))),
        }
    return {"data": {OFFDIAG: by_alg}}


def _write_tree(workdir):
    evals = os.path.join(workdir, "evals")
    for sys_key, alg_vals in SYSTEMS.items():
        d = os.path.join(evals, sys_key)
        os.makedirs(d)
        with open(os.path.join(d, "full_comparrisson_summary.pkl"),
                  "wb") as f:
            pickle.dump(_summary(alg_vals), f)
        if sys_key in DYNAMIC:
            os.makedirs(os.path.join(d, "dynamic"))
            with open(os.path.join(d, "dynamic",
                                   "dynamic_readout_summary.json"),
                      "w") as f:
                json.dump(DYNAMIC[sys_key], f)
    # a directory without a summary is passed over
    os.makedirs(os.path.join(evals, "numF2_numSF2_numN6_numE3_partial"))


def _jax_main():
    """The JAX script's ``main``, its source exec'd without the lines that
    put the repo on ``sys.path``."""
    tree = ast.parse(open(JAX_SCRIPT).read())
    tree.body = [n for n in tree.body
                 if not (isinstance(n, ast.Expr)
                         and "sys.path" in ast.unparse(n))]
    ns = {"__name__": "jax_banded_condense", "__file__": JAX_SCRIPT}
    exec(compile(tree, JAX_SCRIPT, "exec"), ns)
    return ns["main"]


def _run_port(code, timeout=120):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=timeout,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_both_condensers_write_the_same_json(tmp_path, monkeypatch,
                                            capsys):
    """The JAX script's ``main`` and the port's (in a process with jax and
    matplotlib blocked, no ``--plot``) on one crafted tree: the same
    bytes and the same band lines; the port's default ``--out`` is
    ``<workdir>/BANDED_SYNSYS.json``; every band and the dynamic
    aggregates are filled."""
    wd = str(tmp_path / "banded")
    _write_tree(wd)
    jax_json = str(tmp_path / "jax.json")
    monkeypatch.setattr(sys, "argv", [JAX_SCRIPT, wd, "--out", jax_json])
    _jax_main()()
    jax_log = capsys.readouterr().out
    port_log = _run_port(f"""
import sys
sys.modules["jax"] = None
sys.modules["matplotlib"] = None
from redcliff_tpu_torch.experiments import banded_condense as BC
BC.main([{wd!r}])
leaked = sorted(m for m in sys.modules
                if (m == "jax" or m.startswith("jax.")) and sys.modules[m]
                or m == "redcliff_tpu" or m.startswith("redcliff_tpu."))
print("LEAKED", leaked)
""")
    assert "LEAKED []" in port_log
    port_json = os.path.join(wd, "BANDED_SYNSYS.json")
    with open(port_json, "rb") as f:
        got = f.read()
    with open(jax_json, "rb") as f:
        assert got == f.read()
    # the per-band lines print the same
    assert [ln for ln in port_log.splitlines() if ln.startswith("[band")] \
        == [ln for ln in jax_log.splitlines() if ln.startswith("[band")]
    out = json.loads(got)
    assert {b for b, keys in out["by_category"].items() if keys} == {
        "Low", "Moderate", "High"}
    assert set(out["dynamic_readouts_by_system"]) == set(DYNAMIC)
    agg = out["dynamic_readouts_aggregate"]["REDCLIFF_S_CMLP"]
    assert agg["state_score_pearson"]["n_systems"] == 3
    assert "scoring_window" not in agg
    assert "CMLP" not in out["dynamic_readouts_by_band"]["Moderate"]
    # 3-1-2's non-finite CLSTM improvement, Low's only one, leaves no row
    assert "CLSTM" not in out["banded_improvement"]["Low"]
    assert out["banded_improvement"]["Low"]["DGCNN"]["n_systems"] == 2
    assert os.path.isfile(os.path.join(wd, "banded_analysis",
                                       "system_details.pkl"))


def test_condense_matches_the_returned_json_in_process(tmp_path):
    """``main`` returns what it writes; ``--out`` names another file; no
    figure is drawn without ``--plot``."""
    wd = str(tmp_path / "banded")
    _write_tree(wd)
    dest = str(tmp_path / "elsewhere.json")
    out = BC.main([wd, "--out", dest])
    with open(dest) as f:
        assert json.load(f) == json.loads(json.dumps(out))
    assert not os.path.exists(os.path.join(wd, "BANDED_SYNSYS.json"))
    assert not [f for _, _, fs in os.walk(wd) for f in fs
                if f.endswith(".png")]
    bands = out["banded_improvement"]
    for band, keys in out["by_category"].items():
        for alg, row in bands[band].items():
            per = [v for v in row["per_system"].values() if np.isfinite(v)]
            assert row["n_systems"] == len(per)
            np.testing.assert_array_equal(row["mean_improvement"],
                                          np.mean(per))


def _systems(path):
    text = open(path).read()
    (line,) = re.findall(r"^for sys in ([^;]+); do$", text, re.M)
    return line.split()


def test_sweep_script_parses_and_runs_the_jax_systems():
    res = subprocess.run(["bash", "-n", PORT_SWEEP], capture_output=True,
                         text=True, timeout=30)
    assert res.returncode == 0, res.stderr
    assert _systems(PORT_SWEEP) == _systems(JAX_SWEEP) == [
        "6-2-2", "12-11-2", "3-1-2", "6-2-3", "6-4-2", "6-6-2"]
    text = open(PORT_SWEEP).read()
    assert "python -m redcliff_tpu_torch.experiments.accuracy_parity_synsys" \
        in text
    assert "--algs ref" in text and "--dynamic" in text
    assert "python -m redcliff_tpu_torch.experiments.banded_condense" in text
    assert "experiments/accuracy_parity_synsys.py" not in text
    assert os.access(PORT_SWEEP, os.X_OK)


@pytest.mark.parametrize("systems", [None, {
    "numF2_numSF2_numN6_numE2_synSys6_2_2",
    "numF2_numSF2_numN3_numE1_synSys3_1_2"}])
def test_aggregate_dynamic_skips_metadata_and_scalars(systems):
    out = BC.aggregate_dynamic(DYNAMIC, systems=systems)
    n = 3 if systems is None else 2
    assert out["REDCLIFF_S_CMLP"]["state_score_pearson"]["n_systems"] == n
    assert "_conventions" not in out and "note" not in out
    assert set(out["CMLP"]) == {"edge_dynamics_spearman"}
