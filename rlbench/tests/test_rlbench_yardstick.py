"""The frozen FLOP arithmetic and peaks equal the program's sources
(``repro_torch.launch.analytic`` and ``launch.roofline``) at the cells'
shapes today."""
import pytest

from rlbench.harness import cell as cells
from rlbench.harness import yardstick as ys


def _cells(root, bench):
    return [cells.load_cell(root, w["name"]) for w in bench["workloads"]]


@pytest.mark.parametrize("ctx", [0.0, 1.0, 383.5, 512.0, 3072.0])
def test_fwd_flops_equal_analytic(root, bench, ctx):
    from repro_torch.launch import analytic
    for c in _cells(root, bench):
        pcfg = c.builder.port_config(c.config)
        for seq in (True, False):
            assert ys.fwd_flops_per_token(c.shape, ctx) == \
                analytic.fwd_flops_per_token(pcfg, ctx, seq_mode=seq)
        assert ys.layer_matmul_params(c.shape) == \
            analytic._layer_matmul_params(pcfg, "dense")


def test_lora_flops_follow_the_ports_adapter_shapes(root, bench):
    from repro_torch.lora.adapters import lora_param_count, target_dims
    for c in _cells(root, bench):
        pcfg = c.builder.port_config(c.config)
        for t in c.shape.lora_targets:
            assert c.shape.target_dims(t) == target_dims(pcfg, t)
        assert ys.lora_flops_per_token(c.shape) == 2 * lora_param_count(pcfg)


def test_peaks_equal_the_ports_table():
    from repro_torch.launch import roofline
    assert ys.PEAK_FLOPS_BF16 == roofline.H100_SXM.flops["bfloat16"]
    assert ys.PEAK_HBM_BYTES == roofline.H100_SXM.hbm_bytes_per_s
