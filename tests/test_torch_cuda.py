"""The port's hand-written kernels against their plain versions, on a GPU.

Marked ``cuda``: they need a CUDA device, nvcc and Triton, and skip where
there is none (the check runs inside a fixture, never at import, so every
test worker collects the same tests).  On a GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: max-abs 2e-5 in fp32, the reference's parity tolerance
(tests/test_kernels_parity.py:23); rtol = atol = 2e-2 in bf16
(tests/test_kernels.py:13).
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import registry as kreg

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA and Triton kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", sorted(kreg.KERNELS))
@pytest.mark.parametrize("tier", ["tiny", "smoke", "full"])
def test_kernel_matches_plain_version_on_the_card(card, name, tier):
    kdef = kreg.get_kernel(name)
    shape = dict(getattr(kdef, f"{tier}_shape"))
    args = kdef.make_args(shape, "float32", 0, card)
    before = ops.launch_counts()[name]
    got = kdef.call(shape, args, kdef.defaults(shape))
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == before + 1
    assert kreg.max_abs_err(got, kdef.ref(shape, args)) <= 2e-5


@pytest.mark.parametrize("name", ["flash_attention", "moe_gmm"])
def test_bf16_kernel_matches_plain_version_on_the_card(card, name):
    kdef = kreg.get_kernel(name)
    shape = dict(kdef.smoke_shape)
    args = kdef.make_args(shape, "bfloat16", 1, card)
    got = kdef.call(shape, args, kdef.defaults(shape))
    want = kdef.ref(shape, args)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


# the head widths of llama3-8b (128) and recurrentgemma-2b (256): their own
# instances of the CUDA kernel, the 256 one with dynamic shared memory
_WIDE_HEADS = [
    {"B": 1, "H": 8, "KV": 2, "L": 256, "hd": 128, "causal": True, "window": None},
    {"B": 1, "H": 2, "KV": 2, "L": 192, "hd": 128, "causal": False, "window": None},
    {"B": 1, "H": 4, "KV": 1, "L": 256, "hd": 256, "causal": True, "window": 64},
    {"B": 1, "H": 2, "KV": 2, "L": 192, "hd": 256, "causal": False, "window": None},
]


@pytest.mark.parametrize("shape", _WIDE_HEADS, ids=lambda s: f"hd{s['hd']}_L{s['L']}_w{s['window']}")
def test_attention_wide_heads_match_plain_version_on_the_card(card, shape):
    kdef = kreg.get_kernel("flash_attention")
    config = {"block_q": 64, "block_k": 64}
    args = kdef.make_args(shape, "float32", 2, card)
    assert kreg.max_abs_err(kdef.call(shape, args, config), kdef.ref(shape, args)) <= 2e-5
    # bf16: kernel and plain version round the same fp32 value once, so
    # they stay within one bf16 step of each other element by element
    args = kdef.make_args(shape, "bfloat16", 2, card)
    got, want = kdef.call(shape, args, config).float(), kdef.ref(shape, args).float()
    assert bool(((got - want).abs() <= 1e-2 * want.abs() + 1e-3).all())
