from .attention import AttnParams
from .common import LoraCtx, proj, rmsnorm, softcap, dtype_of
from .mlp import MLPParams
from .model import (decode_step, forward_prefill_chunk, forward_seq,
                    forward_train, init_cache, init_paged_cache, init_params,
                    lm_logits, tree_index, tree_leaves, tree_map,
                    tree_unflatten, vocab_matrix)

__all__ = ["AttnParams", "MLPParams", "LoraCtx", "proj", "rmsnorm",
           "softcap", "dtype_of", "decode_step", "forward_prefill_chunk",
           "forward_seq", "forward_train", "init_cache", "init_paged_cache",
           "init_params", "lm_logits", "tree_index", "tree_leaves",
           "tree_map", "tree_unflatten", "vocab_matrix"]
