"""The port's block-sparse SpMM (plain version and plan-based aggregation,
forward and backward) against the JAX package's Pallas kernel run in
interpret mode and its custom VJP, at atol 1e-5 (fp32, sums in a
different order)."""
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


def plans(fmt):
    """(name, plan instance) cases: a rectangular plan, and the padded
    instance of a stack (fewer tiles than the stack's max)."""
    rect = rect_plan(fmt, 90, 200, 400, 32, seed=0)
    sparse = rect_plan(fmt, 100, 150, 30, 32, seed=1)
    dense = rect_plan(fmt, 100, 150, 3000, 32, seed=1)
    stacked = fmt.stack_plans([sparse, dense])
    return {"rect": (rect, None), "padded_stack": (stacked, 0)}


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


@pytest.mark.parametrize("name", ["rect", "padded_stack"])
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


@pytest.mark.parametrize("name", ["rect", "padded_stack"])
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


def test_empty_plan_gives_zeros():
    blocks = torch.zeros(0, 32, 32)
    idx = torch.zeros(0, dtype=torch.int32)
    out = tspmm.spmm_ref(blocks, idx, idx, torch.ones(64, 5), n_out=96)
    assert out.shape == (96, 5) and not out.any()


def test_kernel_wrapper_refuses_cpu_tensors():
    """On the CPU the kernel is never asked for: the wrapper raises rather
    than fall back, and leaves its launch count alone."""
    z = torch.zeros(1, dtype=torch.int32)
    before = tspmm.spmm_block_sparse.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tspmm.spmm_block_sparse(torch.zeros(1, 32, 32), z, z,
                                torch.zeros(32, 4))
    assert tspmm.spmm_block_sparse.launches == before


def test_plan_dev_rejects_out_of_range_tiles():
    plan = rect_plan(tformat, 40, 70, 50, 32, seed=4)
    bad = dataclasses.replace(plan, block_cols=plan.block_cols + 5)
    with pytest.raises(ValueError, match="cols must lie"):
        tspmm.block_sparse_plan_dev(bad, device="cpu")
