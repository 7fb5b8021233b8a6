"""The segment backend's static-weight route: the compressed rows
``core.agg.csr_plan`` derives from the chunked edge lists, and the SpMM
kernel's plain version through them (``kernels.spmm.ops._run`` takes
``spmm_csr_ref`` for CPU tensors, the kernel for CUDA ones), against the
per-edge route it replaced (``index_select`` · w → ``index_add_``).

Tolerances.  On the CPU both routes add each output row's products in
the same order (the forward rows keep each destination's edges in the
chunk's order, the transposed rows each source's), so a chunk's rows
agree to the last bit at γ = 1; they are compared with an fp32 tolerance
of 1e-6 of the largest value all the same, the margin of a float32 sum
taken in another order.  With γ ≠ 1 the new route multiplies γ once
after the sum, where the old one multiplied each edge's weight by γ: the
loss and gradients of a step then differ by float32 rounding, well
inside 1e-5 relative.
"""
import contextlib
import dataclasses
import datetime
import multiprocessing as mp

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import optim
from repro_torch.core import agg as AGG
from repro_torch.core import decouple as D
from repro_torch.gnn import layers as L
from repro_torch.gnn import models as M
from repro_torch.graph import format as gf
from repro_torch.graph import synthetic as S
from repro_torch.params import tree_leaves
from repro_torch.runtime import TPMesh
from repro_torch.runtime import telemetry as T

TIMEOUT = datetime.timedelta(seconds=60)
GRAPH = dict(n=150, num_classes=5, feat_dim=12, avg_degree=6, seed=3)
RTOL = 1e-5


def _graph(name: str):
    """(Graph, n_chunks) of each shape the derivation must handle."""
    rng = np.random.default_rng(7)
    if name == "sbm":          # self-loops, skewed degrees, n_chunks ∤ n
        return S.sbm_power_law(n=61, num_classes=3, feat_dim=4,
                               avg_degree=5, seed=1).graph, 4
    if name == "empty_tail":   # ceil-sized chunks leave the last one empty
        src, dst = rng.integers(0, 9, 30), rng.integers(0, 9, 30)
        return gf.build_graph(src, dst, 9), 4
    # vertices 0..9 have no in-edges, 30..39 no out-edges, 40.. none at all
    src, dst = rng.integers(0, 30, 200), rng.integers(10, 40, 200)
    return gf.build_graph(src, dst, 47, add_self_loops=False,
                          normalization="mean"), 5


def _dense(rows, cols, vals, shape):
    out = torch.zeros(shape, dtype=torch.float64)
    out.index_put_((rows.long(), cols.long()), vals.double(),
                   accumulate=True)
    return out


def _csr_dense(row_ptr, col_idx, vals, n_cols):
    nnz = int(row_ptr[-1])
    rows = torch.repeat_interleave(torch.arange(row_ptr.numel() - 1),
                                   row_ptr.diff().long())
    return _dense(rows, col_idx[:nnz], vals[:nnz],
                  (row_ptr.numel() - 1, n_cols))


@pytest.mark.parametrize("name", ["sbm", "empty_tail", "isolated"])
def test_csr_plan_rows_equal_the_chunked_edges(name):
    g, n_chunks = _graph(name)
    cg = L.chunked_dev(gf.chunk_graph(g, n_chunks), "cpu")
    plan = AGG.csr_plan(cg)
    cs, n = cg.chunk_size, cg.n
    assert plan.row_ptr.shape == (n_chunks, cs + 1)
    assert plan.row_ptr_t.shape == (n_chunks, n + 1)
    assert plan.row_ptr.dtype == plan.row_ptr_t.dtype == torch.int32
    # the forward rows are the chunk arrays themselves
    assert plan.col_idx is cg.src and plan.vals is cg.weight
    for c in range(n_chunks):
        real = cg.dst_local[c] < cs
        want = _dense(cg.dst_local[c][real], cg.src[c][real],
                      cg.weight[c][real], (cs, n))
        fwd = plan.instance(c)
        assert int(fwd.row_ptr[-1]) == int(real.sum())
        torch.testing.assert_close(
            _csr_dense(fwd.row_ptr, fwd.col_idx, fwd.vals, n), want,
            rtol=0, atol=0)
        torch.testing.assert_close(
            _csr_dense(fwd.row_ptr_t, fwd.col_idx_t, fwd.vals_t, cs),
            want.T, rtol=0, atol=0)
        # padding past the real entries is zero
        nnz = int(real.sum())
        assert not fwd.col_idx_t[nnz:].any() and not fwd.vals_t[nnz:].any()
    if name == "empty_tail":
        assert int(plan.row_ptr[-1, -1]) == 0
        assert not plan.row_ptr_t[-1].any()


def test_csr_plan_refuses_unsorted_edges():
    g, n_chunks = _graph("sbm")
    cg = L.chunked_dev(gf.chunk_graph(g, n_chunks), "cpu")
    flipped = cg.dst_local.flip(1).contiguous()
    with pytest.raises(ValueError, match="sorted by destination"):
        AGG.csr_plan(L.ChunkedDev(
            src=cg.src, dst_local=flipped, weight=cg.weight,
            edge_id=cg.edge_id, n=cg.n, chunk_size=cg.chunk_size))


@pytest.mark.parametrize("d", [1, 11, 41])
def test_chunk_agg_csr_route_matches_segment_route(d):
    g, n_chunks = _graph("sbm")
    cg = L.chunked_dev(gf.chunk_graph(g, n_chunks), "cpu")
    plan = AGG.csr_plan(cg)
    gen = torch.Generator().manual_seed(d)
    z = torch.randn(cg.n, d, generator=gen, requires_grad=True)
    for c in range(n_chunks):
        ct = torch.randn(cg.chunk_size, d, generator=gen)
        with T.collect_agg_routes() as routes:
            got = AGG.chunk_agg("segment", z, plan.instance(c),
                                cg.chunk_size, 0.7)
            want = AGG.chunk_agg(
                "segment", z, (cg.src[c], cg.dst_local[c], cg.weight[c]),
                cg.chunk_size, 0.7)
        assert dict(routes) == {"csr": 1, "segment": 1}
        scale = 1e-6 * float(want.detach().abs().max().clamp(min=1))
        torch.testing.assert_close(got, want, rtol=0, atol=scale)
        g_got, = torch.autograd.grad(got, z, ct)
        g_want, = torch.autograd.grad(want, z, ct)
        scale = 1e-6 * float(g_want.abs().max().clamp(min=1))
        torch.testing.assert_close(g_got, g_want, rtol=0, atol=scale)


@contextlib.contextmanager
def per_edge_route():
    """The engine as it aggregated before the compressed rows: every
    model's γ·w rechunked each step, the segment backend's per-edge sums,
    γ inside the weights."""
    saved = D._edge_weights_tp, D._effective_agg, AGG.with_csr

    def weights(params, cfg, graph, h_local, mesh):
        if cfg.model == "gat":
            return saved[0](params, cfg, graph, h_local, mesh)
        return L.rechunk_edge_values(graph.chunked,
                                     cfg.gamma * graph.edges.weight)

    def edge_arrays(graph):
        cg = graph.chunked
        return dataclasses.replace(graph, csr=[
            (cg.src[c], cg.dst_local[c], cg.weight[c])
            for c in range(cg.n_chunks)])

    D._edge_weights_tp = weights
    D._effective_agg = lambda cfg, agg: ("segment", 1.0)
    AGG.with_csr = edge_arrays
    try:
        yield
    finally:
        D._edge_weights_tp, D._effective_agg, AGG.with_csr = saved


def _loss_and_grads(cfg, bundle, mode, params):
    vg = D.make_tp_value_and_grad(cfg, bundle, TPMesh(), mode=mode)
    loss, grads = vg(params, bundle.train_mask)
    return loss, tree_leaves(grads)


def _assert_same(got, want, what):
    torch.testing.assert_close(got[0], want[0], rtol=RTOL, atol=0,
                               msg=f"{what}: loss")
    for i, (a, b) in enumerate(zip(got[1], want[1])):
        torch.testing.assert_close(
            a, b, rtol=0, atol=RTOL * float(b.abs().max().clamp(min=1e-30)),
            msg=f"{what}: gradient of leaf {i}")


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    init = tmp_path_factory.mktemp("pg") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                            world_size=1, timeout=TIMEOUT)
    data = S.sbm_power_law(**GRAPH)
    yield data, D.prepare_bundle(data, n_workers=1, n_chunks=4,
                                 device="cpu")
    dist.destroy_process_group()


def _fresh_bundle(data):
    return D.prepare_bundle(data, n_workers=1, n_chunks=4, device="cpu")


@pytest.mark.parametrize("mode", ["decoupled", "decoupled_pipelined",
                                  "naive"])
def test_one_rank_gcn_step_matches_per_edge_route(one_rank, mode):
    data, bundle = one_rank
    cfg = D.padded_gnn_config(data, bundle, hidden_dim=8, num_layers=2,
                              gamma=0.8 if mode != "naive" else 1.0)
    params = M.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    with T.collect_agg_routes() as routes:
        got = _loss_and_grads(cfg, bundle, mode, params)
    assert dict(routes) == {"csr": 8}     # 2 rounds × 4 chunks, forward
    with per_edge_route(), T.collect_agg_routes() as routes:
        want = _loss_and_grads(cfg, bundle, mode, params)
    assert dict(routes) == {"segment": 8}
    _assert_same(got, want, mode)


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_route_and_rows_follow_the_model(one_rank, model, monkeypatch):
    """GAT's α needs a gradient: its chunks keep ``index_select`` · w →
    ``index_add_``, and no compressed rows are derived for it; a GCN
    step derives them once, in the set-up, into its own copy of the
    graph: the bundle carries none either way."""
    data = one_rank[0]
    bundle = _fresh_bundle(data)
    cfg = D.padded_gnn_config(data, bundle, model=model, hidden_dim=8,
                              num_layers=2)
    params = M.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    derived = []
    plan = AGG.csr_plan
    monkeypatch.setattr(AGG, "csr_plan",
                        lambda cg: derived.append(cg) or plan(cg))
    opt = optim.adamw(1e-2)
    step, _ = D.make_tp_train_fns(cfg, bundle, TPMesh(), opt)
    in_setup = len(derived)
    with T.collect_agg_routes() as routes:
        _, _, loss = step(params, opt.init(params))
        _, _, loss = step(params, opt.init(params))
    assert torch.isfinite(loss)
    assert bundle.graph.csr is None
    assert len(derived) == in_setup
    if model == "gat":
        assert dict(routes) == {"segment": 16}
        assert in_setup == 0
    else:
        assert dict(routes) == {"csr": 16}
        assert in_setup == 1


def test_static_weights_need_the_rows(one_rank):
    """A graph without compressed rows refuses the static-weight segment
    route instead of taking another; ``with_csr`` gives it them."""
    bundle = one_rank[1]
    with pytest.raises(ValueError, match="with_csr"):
        AGG.chunk_xs(bundle.graph, "segment", None)
    xs = AGG.chunk_xs(AGG.with_csr(bundle.graph), "segment", None)
    assert [type(x) for x in xs] == [AGG.SP.BlockSparsePlanDev] * 4
    w = L.rechunk_edge_values(bundle.graph.chunked, bundle.graph.edges.weight)
    assert all(len(x) == 3 for x in AGG.chunk_xs(bundle.graph, "segment", w))


def _two_rank_worker(rank, world, init, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        data = S.sbm_power_law(**GRAPH)
        bundle = D.prepare_bundle(data, n_workers=world, n_chunks=3,
                                  device="cpu")
        cfg = D.padded_gnn_config(data, bundle, hidden_dim=8, num_layers=2,
                                  gamma=0.8)
        params = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
        out = {}
        for mode in ("decoupled", "decoupled_pipelined"):
            for route in ("csr", "per_edge"):
                ctx = per_edge_route() if route == "per_edge" \
                    else contextlib.nullcontext()
                with ctx:
                    loss, grads = _loss_and_grads(cfg, bundle, mode, params)
                out[f"{mode}-{route}-loss"] = loss.numpy()
                for i, g in enumerate(grads):
                    out[f"{mode}-{route}-g{i}"] = g.numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def test_two_ranks_gcn_step_matches_per_edge_route(tmp_path):
    world = 2
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_two_rank_worker,
                         args=(r, world, tmp_path / "rendezvous", tmp_path))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * world
    for r in range(world):
        got = dict(np.load(tmp_path / f"rank{r}.npz"))
        for mode in ("decoupled", "decoupled_pipelined"):
            def side(route):
                keys = sorted(k for k in got
                              if k.startswith(f"{mode}-{route}-g"))
                return (torch.from_numpy(got[f"{mode}-{route}-loss"]),
                        [torch.from_numpy(got[k]) for k in keys])
            _assert_same(side("csr"), side("per_edge"), f"rank {r} {mode}")
