"""The frozen work counters against counts taken from a run at a tiny size,
and against ``chip_smoke.py``'s bytes of a flagship call."""
import torch
from torch.utils.flop_counter import FlopCounterMode

import harness
import inputs
import port
import tiny
from reference.unet import UNet
from work import counts


def test_fused_bytes_of_the_flagships():
    # chip_smoke.py's time_kernel: 2.076 GB a 22.05 kHz call, 3.710 GB a 44.1 kHz one (bf16, 1 row)
    cfg22 = harness.load_json("configs", "cqtdiff_plus_22k")
    cfg44 = harness.load_json("configs", "cqtdiff_plus_44k")
    assert counts.fused_bytes(cfg22, 1, 2) == 2076293632
    assert round(counts.fused_bytes(cfg44, 1, 2) / 1e9, 3) == 3.710
    assert len(counts.fused_launches(cfg22)) == 90
    assert len(counts.fused_launches(cfg44)) == 111


def test_fused_launch_shapes_match_the_program_at_a_tiny_size():
    """The (R, C) of every fused launch, read from the program's blocks'
    inputs as ``chip_smoke.launch_shapes`` reads them."""
    from aid_tpu_torch.models.unet_cqt import AdaLNResBlock
    cfg = tiny.config()
    args = port.compose(cfg, "serving")
    net = port.network(args, cfg, 1, torch.device("cpu"), trainable=False)
    seen = []

    def hook(m, a):
        x = a[0]
        seen.extend([(x.shape[1] * x.shape[2], m.H[0].weight.shape[0])] * m.num_dils)

    hs = [m.register_forward_pre_hook(hook) for m in net.modules() if isinstance(m, AdaLNResBlock)]
    with torch.no_grad():
        net(torch.randn(2, 2048), torch.zeros(2, 1))
    for h in hs:
        h.remove()
    assert sorted(seen) == sorted(counts.fused_launches(cfg))


def test_forward_flops_match_a_flop_counter_at_a_tiny_size(monkeypatch):
    """The reference's products counted by torch's FLOP counter, its banded
    resampling matrices replaced by their FIR taps (8 a down output, 4 an
    up output): the work the counters read from the shapes."""
    cfg = tiny.config()
    net, _ = port.reference_net(cfg, 1, torch.device("cpu"))
    dense = fir = 0
    resample = UNet._resample

    def counted(self, x, up):
        nonlocal dense, fir
        y = resample(self, x, up)
        B, F, T, C = x.shape
        dense += 2 * y.shape[2] * T * B * F * C
        fir += 2 * y.shape[2] * B * F * C * (4 if up else 8)
        return y

    monkeypatch.setattr(UNet, "_resample", counted)
    rows = 2
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        net(torch.from_numpy(inputs.music(2048, 22050, 3)).repeat(rows, 1), torch.zeros(rows, 1))
    assert fc.get_total_flops() - dense + fir == counts.forward_flops(cfg, rows)
    assert counts.score_flops(cfg, rows, True) == 2 * counts.forward_flops(cfg, rows)
    assert counts.step_flops(cfg, rows) == 3 * counts.forward_flops(cfg, rows)
