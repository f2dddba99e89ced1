"""``tools/task_history.py`` on the card: a tiny High-band REDCLIFF-S task
run by the tool on the card against the same task run by it on the CPU,
from the same seeded init (drawn on a CPU generator, then placed). This
file imports no JAX, so it runs where the port runs.
"""
import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")

from redcliff_tpu_torch.experiments import highband_readout_sweep as HB  # noqa: E402,E501

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "task_history", os.path.join(REPO, "tools", "task_history.py"))
TH = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(TH)

# a tiny width and depth on a 6-node, one-edge, two-state system
# (tests/test_torch_highband_readout_sweep.py's)
TINY = dict(gen_hidden="[4]", batch_size="8", embed_num_hidden_nodes="8",
            embed_num_graph_conv_layers="1", max_iter="3",
            num_pretrain_epochs="1", num_acclimation_epochs="1",
            check_every="1")


@pytest.mark.gpu
def test_tool_card_run_matches_its_cpu_run(tmp_path, monkeypatch):
    """No parting at the trainer bars, the same best and stop epochs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the factor-mix kernel runs on it")
    import random

    import numpy as np

    monkeypatch.setenv("REDCLIFF_QUALITY", "0")
    monkeypatch.setattr(HB, "SAMPLES", {True: (16, 8), False: (16, 8)})
    py_state, np_state = random.getstate(), np.random.get_state()
    sets = [x for k, v in TINY.items() for x in ("--set", f"{k}={v}")]
    outs = []
    try:
        for device in ("cpu", "cuda"):
            out = str(tmp_path / f"{device}.json")
            TH.main(["run", "--study", "highband", "--system", "6-1-2",
                     "--alg", "REDCLIFF_S_CMLP", "--device", device,
                     "--out", out, "--workdir", str(tmp_path / device)]
                    + sets)
            outs.append(out)
    finally:
        random.setstate(py_state)
        np.random.set_state(np_state)
    line = TH.main(["compare", outs[1], outs[0]])
    assert line["a"]["device"].startswith("cuda")
    assert line["parting_epoch"] is None, line
    for k in ("best_it", "stop_epoch"):
        assert line["a"][k] == line["b"][k]
