"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips without one.
This file imports no jax, and the tests' ``conftest.py`` does, so run it on
the card without that file:

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py

The shapes are small and ragged (not multiples of the kernels' tiles) so
that the edge handling is exercised; ``chip_smoke.py`` checks the serving
path's full shapes.
"""

import pytest
import torch

from neural_speech_decoder_tpu_torch.ops.kernels.frontend import (
    fused_frontend,
    fused_frontend_plain,
)
from neural_speech_decoder_tpu_torch.ops.kernels.gru_scan import (
    gru_sequence,
    gru_sequence_plain,
)

pytestmark = pytest.mark.cuda

# Same reasoning as chip_smoke.py's TOL: float32 differs by summation order
# only; in bfloat16 that can flip a stored value's rounding by one step.
F32_TOL = 1e-5
BF16_TOL = 1.6e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("b,t,c", [(3, 37, 130), (2, 70, 256)])
def test_frontend_kernel_matches_plain(cuda, dtype, tol, b, t, c):
    g = torch.Generator(device=cuda).manual_seed(0)
    n_days = 4
    x = torch.randn((b, t, c), generator=g, device=cuda).to(dtype)
    w = torch.eye(c, device=cuda) + 0.05 * torch.randn(
        (n_days, c, c), generator=g, device=cuda)
    bias = 0.1 * torch.randn((n_days, c), generator=g, device=cuda)
    day = torch.tensor([-1, 3, 9][:b], dtype=torch.int32, device=cuda)
    before = fused_frontend.launches
    out = fused_frontend(x, w, bias, day, kernel_size=20, sigma=2.0)
    ref = fused_frontend_plain(x, w, bias, day, kernel_size=20, sigma=2.0)
    torch.cuda.synchronize()
    assert fused_frontend.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [1, 2])
def test_gru_scan_kernel_matches_plain(cuda, dtype, tol, d):
    g = torch.Generator(device=cuda).manual_seed(0)
    length, b, h = 9, 37, 40
    xp = torch.randn((length, d, b, 3 * h), generator=g, device=cuda).to(dtype)
    w = 0.2 * torch.randn((d, h, 3 * h), generator=g, device=cuda)
    bias = 0.1 * torch.randn((d, 3 * h), generator=g, device=cuda)
    before = gru_sequence.launches
    out = gru_sequence(xp, w, bias)
    ref = gru_sequence_plain(xp, w, bias)
    torch.cuda.synchronize()
    assert gru_sequence.launches == before + 1
    assert out.dtype == dtype and out.shape == (length, d, b, h)
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_kernels_refuse_unsupported_dtype(cuda):
    x = torch.zeros((1, 8, 16), dtype=torch.float16, device=cuda)
    w = torch.zeros((1, 16, 16), device=cuda)
    with pytest.raises(TypeError):
        fused_frontend(x, w, w[:, 0], torch.zeros(1, dtype=torch.int32,
                       device=cuda), kernel_size=20, sigma=2.0)
    xp = torch.zeros((2, 1, 1, 12), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        gru_sequence(xp, torch.zeros((1, 4, 12), device=cuda),
                     torch.zeros((1, 12), device=cuda))
