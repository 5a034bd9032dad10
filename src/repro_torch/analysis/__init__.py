"""Static analysis of the port (``repro_torch``), the counterpart of
``repro.analysis``. Three AST-based checker families:

  RA1xx  lock discipline (``analysis/locks.py``, a copy), metrics phase
         literals against the port's registry (RA105, ``analysis/phases.py``)
         and swallowed worker exceptions (RA106, ``analysis/robustness.py``)
  RT2xx  host syncs and per-step allocations on the decode step
         (``analysis/tracing.py``; functions marked ``# step:``)
  RT3xx  the CUDA launchers' ctypes signatures against their C
         declarations and calls (``analysis/launch_rules.py``)

plus runtime validators (``analysis/runtime_validator.py``): the lock-order
recorder, and a sentinel that counts new launch plans, library loads,
step-function signatures and, on the card, synchronizing calls.

Run ``python -m repro_torch.analysis --check src/repro_torch`` (the gate,
against ``analysis/baseline.json``) or see ``analysis/README.md``.
"""
from .core import (  # noqa: F401
    Finding,
    RULES,
    analyze_paths,
    default_baseline_path,
    diff_against_baseline,
    load_baseline,
    write_baseline,
)
from .runtime_validator import (  # noqa: F401
    LockOrderRecorder,
    RecompileSentinel,
)
