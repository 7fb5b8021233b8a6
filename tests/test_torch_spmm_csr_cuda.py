"""The SpMM kernel on the card (``-m cuda``; skipped where there is no
card: the CUDA kernel has no CPU mode).  Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_spmm_csr_cuda.py

Widths 1 to 16 take the narrow kernel (a warp's lanes split into groups
of the power of two ≥ d, each group gathering its own nonzero), 17 and 41
the wide one, whose instructions are those it always had.  Each width is
held against the plain version (``spmm_csr_ref``, float64 sums): float32
sums in another order, within 1e-5·(1 + max|ref|); and a second launch
must equal the first bitwise (no atomics in the sums).  The rows mix
empty rows, rows of one or two nonzeros, and rows long enough to straddle
many 64-nonzero warp segments, with the stacked plans' padding past
``row_ptr[-1]``.  No JAX here: the card's tests compare with the plain
PyTorch version.
"""
import pytest
import torch

from repro_torch.core import agg as AGG
from repro_torch.gnn import layers as L
from repro_torch.graph import format as gf
from repro_torch.graph import synthetic as S
from repro_torch.kernels.spmm import spmm_csr, spmm_csr_ref

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _rows(dev, n_out=3000, n_in=2000, seed=0):
    """Compressed rows of mixed lengths, padded by 7 entries past nnz."""
    gen = torch.Generator().manual_seed(seed)
    deg = torch.randint(0, 4, (n_out,), generator=gen)
    deg[torch.randint(0, n_out, (40,), generator=gen)] = 0
    deg[::97] = torch.randint(60, 400, deg[::97].shape, generator=gen)
    deg[1234] = 5000
    row_ptr = torch.zeros(n_out + 1, dtype=torch.int32)
    row_ptr[1:] = torch.cumsum(deg, 0)
    cap = int(row_ptr[-1]) + 7
    col_idx = torch.randint(0, n_in, (cap,), generator=gen, dtype=torch.int32)
    vals = torch.randn(cap, generator=gen)
    return [t.to(dev) for t in (row_ptr, col_idx, vals)], n_in


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8, 11, 16, 17, 41])
def test_spmm_csr_matches_plain_and_repeats_bitwise(card, d):
    arrays, n_in = _rows(card, seed=d)
    h = torch.randn(n_in, d, generator=torch.Generator().manual_seed(d)) \
        .to(card)
    got = spmm_csr(*arrays, h)
    again = spmm_csr(*arrays, h)
    torch.cuda.synchronize()
    want = spmm_csr_ref(*(a.cpu() for a in arrays[:2]),
                        arrays[2].cpu().double(), h.cpu().double())
    tol = 1e-5 * (1 + float(want.abs().max()))
    torch.testing.assert_close(got.cpu().double(), want, rtol=0, atol=tol)
    assert torch.equal(got, again)


def test_csr_plan_on_the_card_equals_the_cpu_one(card):
    g = S.sbm_power_law(n=3000, num_classes=4, feat_dim=4, avg_degree=10,
                        seed=5).graph
    cg = gf.chunk_graph(g, 4)
    on_card = AGG.csr_plan(L.chunked_dev(cg, card))
    on_cpu = AGG.csr_plan(L.chunked_dev(cg, "cpu"))
    for f in ("row_ptr", "col_idx", "vals", "row_ptr_t", "col_idx_t",
              "vals_t"):
        assert torch.equal(getattr(on_card, f).cpu(), getattr(on_cpu, f)), f
