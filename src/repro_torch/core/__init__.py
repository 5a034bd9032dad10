# The paper's primary contribution — the MARLaaS system itself (port of
# ``repro.core``):
#   manager.py    multi-task manager M (versioned θ/φ store + FIFO Q_buffer)
#   admission.py  KV-cache-aware admission control (generalized to SSM state)
#   runtime.py    real threaded runtime (continuous multi-LoRA rollout
#                 thread + serialized trainer thread, Algorithm 1)
#   metrics.py    occupancy timeline -> util/idle/steps-per-hr/TTFS/TPTS
#   supervisor.py tenant circuit breaker, stage supervision, join_or_raise
#   chaos.py      deterministic fault-injection config and dice
from .admission import AdmissionConfig, AdmissionController
from .manager import MultiTaskManager, TaskSpec, TaskState
from .metrics import MetricsRecorder, summarize

__all__ = ["AdmissionConfig", "AdmissionController", "MultiTaskManager",
           "TaskSpec", "TaskState", "MetricsRecorder", "summarize"]
