# Hand-written Hopper kernels (port of repro.kernels):
#   sgmv           — multi-LoRA grouped matmul (rollout, paper §4.5)
#   gqa_decode     — flash-decode attention over contiguous KV caches
#   paged_decode   — the same over the shared KV page pool, through block
#                    tables (the continuous engine's paged cache)
#   token_logprob  — fused logprob + entropy over the vocabulary, forward and
#                    backward (the GRPO trainer's per-token logprobs)
# Sources in csrc/ (CUDA C++ for sm_90a), built by _build.py at first launch
# and bound through ctypes. ref.py holds the plain PyTorch versions, which
# the wrappers run for tensors on the CPU. Every Pallas kernel of the JAX
# package now has a counterpart here.
from . import ops, ref


def launch_counts() -> dict:
    """Each kernel wrapper's launches so far (its ``LAUNCHES`` counters):
    what the entry points print on a line of their own."""
    from . import gqa_decode, paged_decode, sgmv, token_logprob
    return {"gqa_decode": gqa_decode.LAUNCHES.n,
            "paged_gqa_decode": paged_decode.LAUNCHES.n,
            "sgmv": sgmv.LAUNCHES.n,
            "token_logprob_fwd": token_logprob.FWD_LAUNCHES.n,
            "token_logprob_bwd": token_logprob.BWD_LAUNCHES.n}
