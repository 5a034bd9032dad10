from .attention import AttnParams
from .common import LoraCtx, proj, rmsnorm, softcap, dtype_of
from .mlp import MLPParams
from .model import (decode_step, forward_seq, init_cache, init_params,
                    lm_logits, tree_index, tree_map)

__all__ = ["AttnParams", "MLPParams", "LoraCtx", "proj", "rmsnorm",
           "softcap", "dtype_of", "decode_step", "forward_seq", "init_cache",
           "init_params", "lm_logits", "tree_index", "tree_map"]
