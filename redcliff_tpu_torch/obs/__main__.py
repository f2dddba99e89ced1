"""``python -m redcliff_tpu_torch.obs {report,watch,trace,regress}`` — the
observability CLIs (the dispatcher is ``obs/report.py:main``)."""
import sys

from redcliff_tpu_torch.obs.report import main

if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
