"""Port kernels on the card against their plain PyTorch versions.

Card-only (marked `gpu`): each CUDA kernel at misaligned shapes, both
dtypes, against its plain version on the same inputs.  Imports no JAX, so
it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import tolerance
from repro_torch.kernels.flash_attention.ops import paged_decode
from repro_torch.kernels.flash_attention.ref import paged_decode_ref
from repro_torch.kernels.fused_mlp.ops import fused_mlp_hidden
from repro_torch.kernels.fused_mlp.ref import fused_mlp_hidden_ref
from repro_torch.kernels.matmul.ops import matmul
from repro_torch.kernels.matmul.ref import matmul_ref
from repro_torch.models import apply_lm, init_lm

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, dtype, device, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(
        device=device, dtype=dtype)


def _close(got, want, tol):
    """Each element within its own bound (kernels/tolerance.py)."""
    ok, err, ratio = tolerance.check(got, want, tol)
    assert ok, (err, ratio)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(64, 2048, 1024), (37, 70, 45), (1, 512, 200),
                                   (130, 4096, 96), (64, 64, 92544)])
def test_matmul(cuda, dtype, m, k, n):
    rng = np.random.default_rng(0)
    a = _rand(rng, (m, k), dtype, cuda)
    b = _rand(rng, (k, n), dtype, cuda, k ** -0.5)
    before = matmul.launches
    got = matmul(a, b)
    torch.cuda.synchronize()
    assert matmul.launches == before + 1
    want = matmul_ref(a, b)
    _close(got, want, tolerance.matmul_tol(a, b, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu", "relu2"])
@pytest.mark.parametrize("m,h,f", [(64, 256, 512), (19, 72, 200)])
def test_fused_mlp(cuda, dtype, mlp_type, m, h, f):
    rng = np.random.default_rng(1)
    x = _rand(rng, (m, h), dtype, cuda)
    wg = _rand(rng, (h, f), dtype, cuda, h ** -0.5)
    wu = _rand(rng, (h, f), dtype, cuda, h ** -0.5)
    got = fused_mlp_hidden(x, wg, wu, mlp_type=mlp_type)
    torch.cuda.synchronize()
    want = fused_mlp_hidden_ref(x, wg, wu, mlp_type)
    _close(got, want, tolerance.fused_mlp_hidden_tol(x, wg, wu, mlp_type, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_max,g,d", [(72, 2, 128), (200, 3, 64), (128, 1, 256)])
def test_paged_decode(cuda, dtype, s_max, g, d):
    rng = np.random.default_rng(2)
    slots, nkv, b = 9, 2, 6
    q = _rand(rng, (b, nkv * g, d), dtype, cuda)
    kp = _rand(rng, (slots, s_max, nkv, d), dtype, cuda)
    vp = _rand(rng, (slots, s_max, nkv, d), dtype, cuda)
    slot_idx = torch.tensor([4, 0, 8, 2, 7, 1], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([17, 0, s_max, 1, 65, s_max - 3], dtype=torch.int32, device=cuda)
    got = paged_decode(q, kp, vp, slot_idx, lengths)
    torch.cuda.synchronize()
    want = paged_decode_ref(q, kp, vp, slot_idx, lengths)
    assert torch.all(got[1] == 0)
    _close(got, want, tolerance.paged_decode_tol(q, kp, vp, slot_idx, lengths, want))


def test_tied_head_through_the_kernels(cuda):
    """A tied output head (embed^T, not contiguous) runs through the tile
    GEMM and agrees with the plain path in f32."""
    cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"), tie_embeddings=True,
                              dtype="float32", linear_impl="pallas")
    params = init_lm(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    assert "lm_head" not in params
    toks = torch.randint(0, cfg.vocab_size, (2, 13), device=cuda)
    before = matmul.launches
    got, _ = apply_lm(params, toks, cfg)
    assert matmul.launches > before
    want, _ = apply_lm(params, toks, dataclasses.replace(cfg, linear_impl="jnp"))
    # f32 sums in another order through the smoke model's layers (~1e-6
    # relative per GEMM), as the CPU parity tests allow 5e-5
    torch.testing.assert_close(got, want, atol=5e-5, rtol=5e-5)


def test_wrappers_raise_on_bad_operands(cuda):
    a = torch.zeros((8, 16), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        matmul(a, a.T.contiguous())
    with pytest.raises(ValueError):  # non-contiguous B
        matmul(torch.zeros((8, 16), device=cuda), torch.zeros((8, 16), device=cuda).T)
    with pytest.raises(ValueError):  # operands on two devices
        matmul(torch.zeros((8, 16), device=cuda), torch.zeros((16, 8)))
