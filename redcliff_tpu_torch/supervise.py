"""``python -m redcliff_tpu_torch.supervise -- <driver cmd ...>`` — the
crash-loop supervisor entry point (implementation:
:mod:`redcliff_tpu_torch.runtime.supervisor`; port of
``redcliff_tpu/supervise.py``).

Restarts the driver on preemption / watchdog-hang / crash with backoff, stops
on clean exit, numerics abort, or a spent deadline, and writes a
``run_ledger.jsonl`` audit trail of every attempt.
"""
from redcliff_tpu_torch.runtime.supervisor import main

if __name__ == "__main__":
    raise SystemExit(main())
