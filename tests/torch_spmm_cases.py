"""The port's SpMM (the plain versions on the dense tiles and on the
compressed form derived from them, and plan-based aggregation forward and
backward) against the JAX package's Pallas kernel run in interpret mode and
its custom VJP, at atol 1e-5 (fp32, sums in a different order); and the
derivation of the compressed form, which must give back the tiles
bitwise.

The tests are spread over ``tests/test_torch_spmm_*.py``
(``tests/torch_split.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import format as jformat
from repro.kernels import spmm as jspmm
from repro_torch.graph import format as tformat
from repro_torch.kernels import spmm as tspmm

ATOL = 1e-5


def rect_plan(fmt, n_rows, n_cols, e, bs, seed):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n_rows, e).astype(np.int32)
    src = rng.integers(0, n_cols, e).astype(np.int32)
    w = rng.random(e).astype(np.float32)
    return fmt.rect_block_sparse(dst, src, w, n_rows, n_cols, bs)


def skewed_plan(fmt, seed=5):
    """One destination row with 3 000 sources (it spans many kernel
    segments), a band of empty rows, and light random edges elsewhere.
    The hub's weights are GCN-sized (≈ 1/√3000), so its sum stays O(1)
    and atol 1e-5 measures order of summation, not magnitude."""
    rng = np.random.default_rng(seed)
    n_rows, n_cols = 200, 5000
    hub_src = rng.choice(n_cols, 3000, replace=False).astype(np.int32)
    dst = rng.integers(0, n_rows, 600).astype(np.int32)
    dst = dst[(dst < 100) | (dst >= 150)]
    src = rng.integers(0, n_cols, dst.size).astype(np.int32)
    dst = np.concatenate([np.full(3000, 7, np.int32), dst])
    src = np.concatenate([hub_src, src])
    w = rng.random(dst.size).astype(np.float32)
    w[:3000] *= 0.02
    return fmt.rect_block_sparse(dst, src, w, n_rows, n_cols, 64)


def plans(fmt):
    """(name, plan instance) cases: a rectangular plan, the padded
    instance of a stack (fewer tiles than the stack's max), a plan with no
    edge (all-zero tiles) and a skewed plan."""
    rect = rect_plan(fmt, 90, 200, 400, 32, seed=0)
    sparse = rect_plan(fmt, 100, 150, 30, 32, seed=1)
    dense = rect_plan(fmt, 100, 150, 3000, 32, seed=1)
    stacked = fmt.stack_plans([sparse, dense])
    empty = fmt.rect_block_sparse(np.zeros(0, np.int32),
                                  np.zeros(0, np.int32),
                                  np.zeros(0, np.float32), 70, 90, 32)
    return {"rect": (rect, None), "padded_stack": (stacked, 0),
            "empty": (empty, None), "skewed": (skewed_plan(fmt), None)}


def _instance(plan, c):
    if c is None:
        return plan
    return dataclasses.replace(plan, **{
        f: getattr(plan, f)[c] for f in
        ("block_rows", "block_cols", "row_first", "blocks", "block_rows_t",
         "block_cols_t", "row_first_t", "blocks_t")})


@pytest.fixture(scope="module")
def cases():
    jp, tp = plans(jformat), plans(tformat)
    return {k: (_instance(*jp[k]), _instance(*tp[k])) for k in jp}


@pytest.mark.parametrize("name", ["rect", "padded_stack", "skewed"])
@pytest.mark.parametrize("d", [8, 41])
def test_spmm_ref_matches_pallas_interpret(cases, name, d):
    jplan, tplan = cases[name]
    if name == "padded_stack":
        assert tplan.row_first[-1] == 0 and not tplan.blocks[-1].any()
    h = np.random.default_rng(d).normal(
        size=(tplan.cols_padded, d)).astype(np.float32)
    d_pad = -(-d // 8) * 8
    want = jspmm.spmm_block_sparse(
        jnp.asarray(jplan.blocks), jnp.asarray(jplan.block_rows),
        jnp.asarray(jplan.block_cols), jnp.asarray(jplan.row_first),
        jnp.pad(jnp.asarray(h), ((0, 0), (0, d_pad - d))), d_tile=d_pad,
        interpret=True, n_out=jplan.rows_padded)[:, :d]
    got = tspmm.spmm_ref(torch.from_numpy(tplan.blocks),
                         torch.from_numpy(tplan.block_rows),
                         torch.from_numpy(tplan.block_cols),
                         torch.from_numpy(h), n_out=tplan.rows_padded)
    assert got.shape == (tplan.rows_padded, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("name", ["rect", "padded_stack", "skewed"])
@pytest.mark.parametrize("d", [8, 41])
def test_aggregate_plan_forward_and_vjp(cases, name, d):
    jplan, tplan = cases[name]
    rng = np.random.default_rng(100 + d)
    n_in = tplan.n_cols                     # < cols_padded: rows padded inside
    h = rng.normal(size=(n_in, d)).astype(np.float32)
    cot = rng.normal(size=(tplan.rows_padded, d)).astype(np.float32)
    cot[tplan.n_rows:] = 0.0                # the caller slices real rows

    jdev = jspmm.block_sparse_plan_dev(jplan)
    want, vjp = jax.vjp(
        lambda hh: jspmm.aggregate_plan(jdev, hh, d_tile=128,
                                        interpret=True), jnp.asarray(h))
    (want_gh,) = vjp(jnp.asarray(cot))

    tdev = tspmm.block_sparse_plan_dev(tplan, device="cpu")
    th = torch.from_numpy(h).requires_grad_()
    got = tspmm.aggregate_plan(tdev, th)
    (got_gh,) = torch.autograd.grad(got, th, torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    np.testing.assert_allclose(got_gh.numpy(), np.asarray(want_gh), atol=ATOL)


def _dense(rows, cols, vals, shape):
    out = torch.zeros(shape, dtype=torch.float64)
    out.index_put_((rows.long(), cols.long()), vals.double(), accumulate=True)
    return out


def _tiles_dense(blocks, block_rows, block_cols, shape):
    """The tiles scattered into one dense matrix (tile entries of a pair
    that repeats, like stack padding, add up)."""
    k, i, j = torch.nonzero(torch.ones_like(blocks, dtype=torch.bool),
                            as_tuple=True)
    bs = blocks.shape[-1]
    return _dense(block_rows.long()[k] * bs + i,
                  block_cols.long()[k] * bs + j, blocks[k, i, j], shape)


@pytest.mark.parametrize("name", ["rect", "padded_stack", "empty", "skewed"])
@pytest.mark.parametrize("direction", ["forward", "transposed"])
def test_compressed_form_gives_back_the_tiles(cases, name, direction):
    """Scattered back, the derived (row_ptr, col_idx, vals) are the dense
    tiles bitwise: every nonzero entry once, in its place, nothing else;
    row_ptr is non-decreasing and each row's entries are its own."""
    _, tplan = cases[name]
    t = "_t" if direction == "transposed" else ""
    blocks = torch.from_numpy(getattr(tplan, "blocks" + t))
    rows = torch.from_numpy(getattr(tplan, "block_rows" + t))
    cols = torch.from_numpy(getattr(tplan, "block_cols" + t))
    n_out, n_src = ((tplan.cols_padded, tplan.rows_padded) if t
                    else (tplan.rows_padded, tplan.cols_padded))
    row_ptr, col_idx, vals = tspmm.compress_tiles(blocks, rows, cols, n_out)
    assert row_ptr.dtype == col_idx.dtype == torch.int32
    assert row_ptr.shape == (n_out + 1,) and int(row_ptr[0]) == 0
    assert (row_ptr.diff() >= 0).all() and int(row_ptr[-1]) == vals.numel()
    assert int((blocks != 0).sum()) == vals.numel() and (vals != 0).all()
    row_of = torch.repeat_interleave(torch.arange(n_out),
                                     row_ptr.diff().long())
    got = _dense(row_of, col_idx, vals, (n_out, n_src))
    want = _tiles_dense(blocks, rows, cols, (n_out, n_src))
    assert torch.equal(got, want)
    if name == "empty":
        assert vals.numel() == 0
    if name == "skewed" and not t:
        assert int(row_ptr[8] - row_ptr[7]) >= 3000
        assert not row_ptr[100:151].diff().any()


@pytest.mark.parametrize("name", ["rect", "padded_stack", "empty", "skewed"])
@pytest.mark.parametrize("d", [8, 41])
def test_spmm_csr_ref_matches_tiles_and_pallas(cases, name, d):
    """The plain version of the CUDA kernel's function, on the arrays
    ``block_sparse_plan_dev`` derives (a stacked plan's instance keeps its
    padding past row_ptr[-1]), against ``spmm_ref`` on the tiles and the
    Pallas kernel in interpret mode, forward and transposed."""
    jplan, tplan = cases[name]
    stacked = plans(tformat)[name][0]
    c = 0 if name == "padded_stack" else None
    dev = tspmm.block_sparse_plan_dev(stacked, device="cpu")
    dev = dev if c is None else dev.instance(c)
    rng = np.random.default_rng(7 + d)
    for t, n_in, n_out in (("", tplan.cols_padded, tplan.rows_padded),
                           ("_t", tplan.rows_padded, tplan.cols_padded)):
        h = rng.normal(size=(n_in, d)).astype(np.float32)
        got = tspmm.spmm_csr_ref(getattr(dev, "row_ptr" + t),
                                 getattr(dev, "col_idx" + t),
                                 getattr(dev, "vals" + t),
                                 torch.from_numpy(h))
        tiles = [torch.from_numpy(getattr(tplan, f + t))
                 for f in ("blocks", "block_rows", "block_cols")]
        want = tspmm.spmm_ref(*tiles, torch.from_numpy(h), n_out=n_out)
        assert got.shape == (n_out, d)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
        d_pad = -(-d // 8) * 8
        jwant = jspmm.spmm_block_sparse(
            *(jnp.asarray(getattr(jplan, f + t)) for f in
              ("blocks", "block_rows", "block_cols", "row_first")),
            jnp.pad(jnp.asarray(h), ((0, 0), (0, d_pad - d))), d_tile=d_pad,
            interpret=True, n_out=n_out)[:, :d]
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=ATOL)


def test_empty_plan_gives_zeros():
    blocks = torch.zeros(0, 32, 32)
    idx = torch.zeros(0, dtype=torch.int32)
    out = tspmm.spmm_ref(blocks, idx, idx, torch.ones(64, 5), n_out=96)
    assert out.shape == (96, 5) and not out.any()
    row_ptr = torch.zeros(97, dtype=torch.int32)
    out = tspmm.spmm_csr_ref(row_ptr, idx, torch.zeros(0), torch.ones(64, 5))
    assert out.shape == (96, 5) and not out.any()


def test_kernel_wrapper_refuses_cpu_tensors():
    """On the CPU the kernel is never asked for: the wrapper raises rather
    than fall back, and leaves its launch count alone."""
    z = torch.zeros(1, dtype=torch.int32)
    before = tspmm.spmm_csr.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tspmm.spmm_csr(torch.zeros(2, dtype=torch.int32), z, torch.ones(1),
                       torch.zeros(32, 4))
    assert tspmm.spmm_csr.launches == before


def test_plan_dev_rejects_out_of_range_tiles():
    plan = rect_plan(tformat, 40, 70, 50, 32, seed=4)
    bad = dataclasses.replace(plan, block_cols=plan.block_cols + 5)
    with pytest.raises(ValueError, match="cols must lie"):
        tspmm.block_sparse_plan_dev(bad, device="cpu")
