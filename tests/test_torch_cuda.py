"""Tests of the port that need an NVIDIA GPU (the Triton kernel has no CPU
mode). They carry the ``cuda`` marker and skip without a card. This file
imports no JAX, so it runs on the card:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider
"""
import pytest
import torch

from aid_tpu_torch.models import unet_cqt as tunet
from aid_tpu_torch.ops import fused_adaln as fa
from aid_tpu_torch.ops.cqt import get_cqt

EPS, G = 1e-7, 8
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Triton kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _data(gen, shape=(2, 8, 16, 16), dtype=torch.float32):
    C = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    gamma = torch.rand(C, generator=gen, device="cuda") + 0.5
    aff = torch.randn(shape[0], C, generator=gen, device="cuda") * 0.3
    return x, gamma, aff


def test_cuda_branch_raises_rather_than_falls_back(cuda):
    x, gamma, aff = _data(cuda)
    xt = x.transpose(1, 2)
    before = fa.launch_count()
    with pytest.raises(ValueError):
        fa.norm_adaln_gelu(xt, fa.group_std(xt, G), gamma, aff, EPS, G)
    assert fa.launch_count() == before


@pytest.mark.parametrize("gelu", fa.GELU_VARIANTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 16, 16), (1, 64, 32, 96), (3, 7, 5, 256)])
def test_kernel_matches_plain(cuda, gelu, dtype, shape):
    x, gamma, aff = _data(cuda, shape, dtype)
    before = fa.launch_count()
    with torch.no_grad():
        y = fa.norm_adaln_gelu(x, fa.group_std(x, G), gamma, aff, EPS, G, gelu=gelu)
        yp = fa.norm_adaln_gelu_plain(x, fa.group_std(x, G), gamma, aff, EPS, G, gelu=gelu)
    assert fa.launch_count() == before + 1
    assert y.dtype == dtype
    # f32: summation-free elementwise math, libdevice vs torch functions;
    # bf16: one rounding of the same f32 value, so at most one bf16 ulp
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert bool(((y.float() - yp.float()).abs() <= tol * yp.float().abs() + 1e-5).all())


def test_tiny_denoiser_launches_once_per_layer(cuda, monkeypatch):
    net = tunet.UnetCQT(get_cqt(3, 8, 4096.0, 2048), (8, 16, 16), (1, 2, 2),
                        (0, 1, 1, 1), dict(num_heads=2, use_rel_pos=True), emb_dim=32,
                        gelu="tanh").init_weights(0, gate_scale=tunet.MAIN_SCALE).cuda()
    audio = torch.randn(2, 2048, generator=cuda, device="cuda") * 0.1
    cn = torch.tensor([[-0.3], [0.4]], device="cuda")
    fa.reset_launch_count()
    with torch.no_grad():
        y = net(audio, cn)
        n = fa.launch_count()
        monkeypatch.setattr(fa, "norm_adaln_gelu", fa.norm_adaln_gelu_plain)
        yp = net(audio, cn)
    # 3 init + (1+2+2) encoder + 2 bottleneck + 1 out + 5 decoder + 3 out
    assert n == 3 + 5 + 2 + 1 + 5 + 3
    assert ((y - yp).abs().max() / yp.abs().max()).item() < 1e-5
