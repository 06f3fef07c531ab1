"""The Hopper flash kernel against its plain version, on the card.

Marked ``cuda``: without a card every test here skips (the decision is
taken in the fixture, never at import).  On the card:
``python -m pytest tests/test_torch_cuda.py -q``.

Tolerances: float32 5e-5 (only the summation order differs); bf16
``1e-2 + 1e-2 * |plain|`` (both sides round a float32 result to bf16).
"""

import pytest
import torch

from docqa_tpu_torch.ops import _kernels
from docqa_tpu_torch.ops.attention import attention_reference, flash_attention

pytestmark = pytest.mark.cuda

# (b, sq, skv, hq, hkv, d, causal, window, lengths, q_offset)
CASES = [
    (2, 256, 256, 4, 2, 64, False, None, [256, 190], None),
    (2, 256, 256, 4, 2, 64, True, None, [256, 190], None),
    (2, 1, 256, 4, 4, 64, True, None, [100, 37], None),
    (1, 128, 128, 2, 2, 64, True, 32, [128], None),
    (3, 32, 32, 4, 4, 32, False, None, [32, 0, 7], None),
    (2, 1, 128, 4, 2, 128, True, None, [51, 90], [50, 89]),
    (2, 4, 128, 4, 2, 128, True, None, [54, 93], [50, 89]),
    (2, 37, 100, 4, 1, 64, True, 20, [100, 60], None),
    (1, 200, 700, 32, 8, 128, True, 64, [650], [450]),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dev, case, dtype):
    b, sq, skv, hq, hkv, d, causal, window, lengths, q_offset = case
    gen = torch.Generator(device=dev).manual_seed(sq * 1000 + skv)
    q, k, v = (
        torch.randn(shape, generator=gen, device=dev).to(dtype)
        for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))
    )
    kw = dict(
        causal=causal, sliding_window=window,
        lengths=torch.tensor(lengths, dtype=torch.int32, device=dev),
        q_offset=None if q_offset is None
        else torch.tensor(q_offset, dtype=torch.int32, device=dev),
    )
    return q, k, v, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain(dev, case, dtype):
    q, k, v, kw = _inputs(dev, case, dtype)
    before = _kernels.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["flash_attention"] == before + 1
    want = attention_reference(q, k, v, **kw)
    atol, rtol = (5e-5, 0.0) if dtype == torch.float32 else (1e-2, 1e-2)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_kernel_reads_strided_views(dev):
    """A non-contiguous k/v view (a cache slice) needs no copy."""
    q, k, v, kw = _inputs(dev, CASES[1], torch.float32)
    big_k = torch.zeros((2, 300, 2, 64), device=dev)
    big_v = torch.zeros_like(big_k)
    big_k[:, :256], big_v[:, :256] = k, v
    got = flash_attention(q, big_k[:, :256], big_v[:, :256], **kw)
    torch.testing.assert_close(got, attention_reference(q, k, v, **kw),
                               atol=5e-5, rtol=0)


@pytest.mark.parametrize(
    "shape,dtype",
    [((1, 4, 2, 48), torch.float32), ((1, 4, 2, 64), torch.float16)],
)
def test_wrapper_raises_on_unsupported(dev, shape, dtype):
    x = torch.zeros(shape, device=dev, dtype=dtype)
    with pytest.raises(ValueError):
        flash_attention(x, x, x)


def test_wrapper_raises_on_misaligned_rows(dev):
    """The kernel reads 16-byte vectors: a base pointer off by one element
    is refused, not read wrongly."""
    flat = torch.zeros(1 + 4 * 2 * 64, device=dev, dtype=torch.bfloat16)
    x = flat[1:].view(1, 4, 2, 64)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(x, x, x)
