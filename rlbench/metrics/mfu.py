"""The window's work as a share of the card's bf16 peak (989 TFLOP/s, H100
SXM data sheet): the analytic FLOPs of the decode forwards at their
context lengths, the prefill of the prompt tokens the prefix cache did not
serve, and the trainer's forward, its backward through the frozen base and
the adapters' gradients over the trained rows; nothing recomputed. In %."""
from rlbench.harness import measure as m
from rlbench.harness import yardstick as ys


def read(st):
    f = m.decode_flops(st) + m.prefill_flops(st) + m.train_flops(st)
    return 100.0 * f / (m.window_s(st) * ys.PEAK_FLOPS_BF16)
