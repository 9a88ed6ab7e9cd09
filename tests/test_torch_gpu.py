"""The port's hand-written kernels on a CUDA card against their plain
versions, at small shapes with modes that are not powers of two and row
counts that are not a multiple of any tile.

This file imports neither JAX nor the reference package, so it runs on a
card without them; ``tests/conftest.py`` imports JAX, hence::

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Without a card every test skips.
"""
import pytest
import torch

from repro_torch.core.packing import pack_core
from repro_torch.core.quant import quantize_core
from repro_torch.kernels import ref, tt_contract

pytestmark = pytest.mark.gpu

# (n1, n2, m1, m2, r1, B): n2 = 2·43 and m1 = 43 are not powers of two
CASES = [
    (2, 8, 4, 2, 3, 5),
    (2, 86, 43, 2, 4, 13),
    (8, 512, 1376, 8, 16, 37),
]
# max |kernel − plain| / max |plain|: fp32 differs only in summation order;
# a bf16 output is rounded to 8 significant bits on both sides
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dims, B, act, int8, device, seed=0):
    n1, n2, m1, m2, r1 = dims
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    G1 = torch.randn((1, n1, m1, r1), generator=gen, device=device) * 0.3
    G2 = torch.randn((r1, n2, m2, 1), generator=gen, device=device) * 0.3
    x = torch.randn((B, n1 * n2), generator=gen, device=device).to(act)
    if int8:
        (q1, s1), (q2, s2) = quantize_core(G1), quantize_core(G2)
        return x, pack_core(q2), pack_core(q1), torch.stack([s2, s1]).float()
    return x, pack_core(G2.to(act)), pack_core(G1.to(act)), None


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n1,n2,m1,m2,r1,B", CASES)
def test_fused2_kernel_matches_plain(cuda, n1, n2, m1, m2, r1, B, act,
                                     int8):
    dims = (n1, n2, m1, m2, r1)
    x, p2, p1, scales = _inputs(dims, B, act, int8, cuda)
    name = "tt_fused2_int8" if int8 else "tt_fused2"
    before = tt_contract.launch_counts().get(name, 0)
    if int8:
        y = tt_contract.tt_fused2_int8(x, p2, p1, scales, dims)
    else:
        y = tt_contract.tt_fused2(x, p2, p1, dims)
    want = ref.tt_fused2_ref(x, p2, p1, dims, scales)
    assert tt_contract.launch_counts()[name] == before + 1
    assert y.shape == want.shape and y.dtype == want.dtype == act
    assert bool(torch.isfinite(y).all())
    err = float((y.float() - want.float()).abs().max())
    assert err <= TOL[act] * float(want.float().abs().max())


def test_fused2_kernel_rejects_cores_on_another_device(cuda):
    x, p2, p1, _ = _inputs((2, 8, 4, 2, 3), 5, torch.float32, False, cuda)
    with pytest.raises(ValueError, match="is on"):
        tt_contract.tt_fused2(x, p2.cpu(), p1, (2, 8, 4, 2, 3))
