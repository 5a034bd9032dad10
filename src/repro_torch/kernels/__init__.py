# Hand-written Hopper kernels for the serving path (port of repro.kernels):
#   sgmv        — multi-LoRA grouped matmul (rollout, paper §4.5)
#   gqa_decode  — flash-decode attention over contiguous KV caches
# Sources in csrc/ (CUDA C++ for sm_90a), built by _build.py at first launch
# and bound through ctypes. ref.py holds the plain PyTorch versions, which
# the wrappers run for tensors on the CPU. The TPU kernels paged_gqa_decode
# and token_logprob_flat are not ported yet (ROADMAP.md).
from . import ops, ref
