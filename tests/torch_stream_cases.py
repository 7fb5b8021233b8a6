"""The port's out-of-core streaming against the JAX package's, on the CPU.

* Host stores: ``HostFeatureStore`` stripes and ``pad_features`` byte-equal
  to ``repro.graph``'s; the ``segment`` and ``dense`` chunk inputs byte-equal
  to ``repro.core.chunks``'; the ``blocksparse`` half plans bitwise the
  arrays ``block_sparse_plan_dev`` derives for each chunk and, scattered
  back, the reference's half-plan tiles.
* One rank (gloo, in-process): the streamed loss and grads within atol
  1e-5 of ``repro.core.stream.make_stream_value_and_grad`` and of the port's
  in-memory ``decoupled`` step, for every backend × both stream modes; one
  step's ``h2d`` entries equal ``expected_h2d_bytes`` (and the reference's
  for ``segment`` and ``dense``), its collective entries the in-memory
  step's.  SAGE and GIN streamed (``segment``) against the reference:
  GIN's ``eps`` gets zero gradients, as under JAX.
* The reference's primitive tests carried over: the scope gates,
  ``prefetched`` ordering and depth, ``stage`` recording its bytes; and the
  port's own: a CUDA-bound pageable source is refused, ``backward_scope``.
* Two spawned gloo ranks: the streamed step against the in-memory
  ``decoupled`` step at 2 ranks (loss, grads, collective ledger) and each
  rank's h2d bytes against the stated per-rank formula.

The tests are spread over ``tests/test_torch_stream_*.py``
(``tests/torch_split.py``).
"""
import datetime
import json
import multiprocessing as mp
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import chunks as jCH
from repro.core import stream as jST
from repro.gnn import models as jM
from repro.graph import format as jgf
from repro.graph import synthetic as jsynth
from repro.runtime import collect_comm as jcollect
from repro.runtime import streaming as jRS
from repro_torch import params as P
from repro_torch.core import chunks as tCH
from repro_torch.core import decouple as tD
from repro_torch.core import stream as tST
from repro_torch.core import tp as ttp
from repro_torch.graph import format as tgf
from repro_torch.graph import synthetic as tsynth
from repro_torch.kernels import spmm as tSP
from repro_torch.runtime import TPMesh
from repro_torch.runtime import streaming as tRS
from repro_torch.runtime import telemetry as tT

ATOL = 1e-5
GRAPH = dict(n=96, num_classes=3, feat_dim=12, avg_degree=6, seed=0)
CHUNKS, BS, HIDDEN, LAYERS, GAMMA = 3, 32, 16, 2, 0.7
BACKENDS = ("segment", "blocksparse", "dense")
TIMEOUT = datetime.timedelta(seconds=60)


def _bundles(agg, n_workers=1, n_stripes=None):
    """(reference, port) stream bundles of the same graph."""
    j = jST.prepare_stream_bundle(jsynth.sbm_power_law(**GRAPH),
                                  n_workers=n_workers, n_chunks=CHUNKS,
                                  n_stripes=n_stripes, agg=agg,
                                  agg_block_size=BS) if n_workers == 1 \
        else None
    t = tST.prepare_stream_bundle(tsynth.sbm_power_law(**GRAPH), n_workers,
                                  n_chunks=CHUNKS, n_stripes=n_stripes,
                                  agg=agg, agg_block_size=BS, device="cpu")
    return j, t


def _cfg(sb, data_mod, st_mod, model="gcn"):
    return st_mod.stream_gnn_config(data_mod.sbm_power_law(**GRAPH), sb,
                                    model=model, hidden_dim=HIDDEN,
                                    num_layers=LAYERS, gamma=GAMMA)


def _params(cfg_kw, seed=0):
    cfg = jM.GNNConfig(**cfg_kw)
    return jax.tree.map(np.asarray,
                        jM.init_params(jax.random.PRNGKey(seed), cfg))


def _as_np(tree) -> list:
    return [t.numpy() for t in tRS.tree_tensors(tree)]


def _leaves_np(tree) -> list:
    """numpy leaves of a reference host pytree."""
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


# ---------------------------------------------------------------------------
# Host stores against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_stripes", [1, 3, 4])
@pytest.mark.parametrize("n_workers", [1, 2, 4])
def test_host_feature_store_matches_reference(n_workers, n_stripes):
    x = np.random.default_rng(0).normal(size=(48, 5)).astype(np.float32)
    j = jgf.HostFeatureStore(x, n_workers, n_stripes)
    t = tgf.HostFeatureStore(torch.from_numpy(x), n_workers, n_stripes)
    assert (t.n_padded, t.d, t.stripe_rows, t.nbytes, t.stripe_nbytes) == \
        (j.n_padded, j.d, j.stripe_rows, j.nbytes, j.stripe_nbytes)
    rs = t.stripe_rows
    for s in range(n_stripes):
        want = j.stripe(s)
        got = t.stripe(s).numpy()
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        for rank in range(n_workers):
            block = t.rank_block(s, rank)
            assert block.is_contiguous()
            assert block.numpy().tobytes() == \
                want[rank * rs:(rank + 1) * rs].tobytes()
            assert block.numel() * 4 == t.rank_block_nbytes
    with pytest.raises(IndexError):
        t.stripe(n_stripes)
    with pytest.raises(IndexError):
        t.rank_block(0, n_workers)
    bad = np.zeros((50, 5), np.float32)
    with pytest.raises(ValueError) as jerr:
        jgf.HostFeatureStore(bad, 4, 3)
    with pytest.raises(ValueError) as terr:
        tgf.HostFeatureStore(torch.from_numpy(bad), 4, 3)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("shape, n_padded", [((5, 3), 8), ((7,), 9),
                                             ((4, 2), 4)])
def test_pad_features_matches_reference(shape, n_padded):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape) + 1
    want, got = jgf.pad_features(x, n_padded), tgf.pad_features(x, n_padded)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("agg", ["segment", "dense"])
def test_host_chunk_inputs_match_reference(agg, transposed):
    j, t = _bundles(agg)
    jb = jCH.host_chunk_inputs_t if transposed else jCH.host_chunk_inputs
    tb = tCH.host_chunk_inputs_t if transposed else tCH.host_chunk_inputs
    for c in range(CHUNKS):
        want = _leaves_np(jb(agg, c, chunked=j.chunked, plan=j.bsp,
                             dense_rows=j.dense_rows, gamma=GAMMA))
        got = _as_np(tb(agg, c, chunked=t.chunked, plans=t.half_plans,
                        dense_rows=t.dense_rows, gamma=GAMMA))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def _dense_of_rows(hp: tSP.HalfPlan, n_cols: int) -> np.ndarray:
    n_out = hp.row_ptr.shape[0] - 1
    out = np.zeros((n_out, n_cols), np.float32)
    rows = np.repeat(np.arange(n_out), np.diff(hp.row_ptr.numpy()))
    out[rows, hp.col_idx.numpy()] = hp.vals.numpy()
    return out


def _dense_of_tiles(blocks, rows, cols, n_out, n_cols, bs) -> np.ndarray:
    out = np.zeros((n_out, n_cols), np.float32)
    for b, r, c in zip(np.asarray(blocks), np.asarray(rows),
                       np.asarray(cols)):
        out[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs] += b
    return out


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32 if t.dtype == torch.float32
                          else np.int32)


def test_blocksparse_half_plans_are_the_derived_arrays():
    j, t = _bundles("blocksparse")
    gp = tD._pad_graph(tsynth.sbm_power_law(**GRAPH).graph, t.n_padded)
    derived = tSP.block_sparse_plan_dev(
        tgf.chunk_block_sparse(gp, CHUNKS, BS), "cpu")
    for c in range(CHUNKS):
        inst = derived.instance(c)
        for hp, tt in zip(t.half_plans[c], ("", "_t")):
            row_ptr = getattr(inst, "row_ptr" + tt)
            nnz = int(row_ptr[-1])
            assert np.array_equal(_bits(hp.row_ptr), _bits(row_ptr))
            assert hp.col_idx.shape == hp.vals.shape == (nnz,)
            for f in ("col_idx", "vals"):
                full = getattr(inst, f + tt)
                assert np.array_equal(_bits(getattr(hp, f)),
                                      _bits(full[:nnz]))
                assert not full[nnz:].any()
        # scattered back: the reference's half-plan tiles, both directions
        fwd, bwd = t.half_plans[c]
        jf = jCH.host_chunk_inputs("blocksparse", c, plan=j.bsp)
        jt = jCH.host_chunk_inputs_t("blocksparse", c, plan=j.bsp)
        for hp, jp in ((fwd, jf), (bwd, jt)):
            assert hp.n_src == jp.n_cols
            want = _dense_of_tiles(jp.blocks, jp.block_rows, jp.block_cols,
                                   jp.rows_padded, jp.cols_padded, jp.bs)
            got = _dense_of_rows(hp, jp.cols_padded)
            assert got.shape == want.shape
            assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


# ---------------------------------------------------------------------------
# One rank: streamed step against the reference and the in-memory step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    init = tmp_path_factory.mktemp("pg") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                            world_size=1, timeout=TIMEOUT)
    yield TPMesh()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference():
    """Per backend: the reference's loss and grads for both stream modes,
    the h2d entries of its second step, and the parameters (numpy)."""
    out = {}
    for agg in BACKENDS:
        j, _ = _bundles(agg)
        cfg = _cfg(j, jsynth, jST)
        params = jM.init_params(jax.random.PRNGKey(0), cfg)
        res = {"params": jax.tree.map(np.asarray, params)}
        for mode in jST.STREAM_MODES:
            vg = jST.make_stream_value_and_grad(cfg, j, mode=mode)
            loss, grads = vg(params, j.train_mask)
            res[mode] = (float(loss), _leaves_np(grads))
            if mode == "decoupled":
                with jcollect() as led:
                    vg(params, j.train_mask)
                res["h2d"] = led.as_dict()
        out[agg] = res
    return out


def _port_step(agg, mesh, params_np, mode="decoupled", n_stripes=None):
    """(loss, grads, ledger dict, bundle, cfg) of one streamed step."""
    _, t = _bundles(agg, mesh.size, n_stripes)
    cfg = _cfg(t, tsynth, tST)
    vg = tST.make_stream_value_and_grad(cfg, t, mesh, mode=mode)
    with tT.collect_comm() as led:
        loss, grads = vg(P.from_numpy_tree(params_np, "cpu"), t.train_mask)
    return loss.item(), P.tree_leaves(grads), led.as_dict(), t, cfg


def _in_memory_step(agg, mesh, params_np):
    """(loss, grads, ledger dict) of the port's in-memory decoupled step."""
    data = tsynth.sbm_power_law(**GRAPH)
    b = tD.prepare_bundle(data, n_workers=mesh.size, n_chunks=CHUNKS,
                          agg=agg, agg_block_size=BS, device="cpu")
    cfg = tD.padded_gnn_config(data, b, hidden_dim=HIDDEN,
                               num_layers=LAYERS, gamma=GAMMA)
    vg = tD.make_tp_value_and_grad(cfg, b, mesh, mode="decoupled")
    with tT.collect_comm() as led:
        loss, grads = vg(P.from_numpy_tree(params_np, "cpu"), b.train_mask)
    return loss.item(), P.tree_leaves(grads), led.as_dict()


def _split_ledger(d: dict) -> tuple[dict, dict]:
    h2d = {k: v for k, v in d.items() if k.startswith("h2d|")}
    return h2d, {k: v for k, v in d.items() if k not in h2d}


def _close(loss, grads, want_loss, want_grads, what):
    np.testing.assert_allclose(loss, want_loss, atol=ATOL, err_msg=what)
    assert len(grads) == len(want_grads)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=ATOL,
                                   err_msg=what)


@pytest.mark.parametrize("mode", tST.STREAM_MODES)
@pytest.mark.parametrize("agg", BACKENDS)
def test_streamed_step_matches_reference_and_in_memory(one_rank, reference,
                                                       agg, mode):
    ref = reference[agg]
    loss, grads, _, _, _ = _port_step(agg, one_rank, ref["params"], mode)
    _close(loss, grads, *ref[mode], f"{agg}/{mode} vs repro")
    mem_loss, mem_grads, _ = _in_memory_step(agg, one_rank, ref["params"])
    _close(loss, grads, mem_loss, mem_grads, f"{agg}/{mode} vs in-memory")


@pytest.mark.parametrize("model", ["sage", "gin"])
def test_streamed_gcn_like_models_match_reference(one_rank, model):
    """GIN's ``eps`` acts only in the coupled layers: the per-stripe
    gradient gives it zeros, as JAX does."""
    j, t = _bundles("segment")
    jcfg = _cfg(j, jsynth, jST, model=model)
    params = jM.init_params(jax.random.PRNGKey(3), jcfg)
    want_loss, want_grads = jST.make_stream_value_and_grad(jcfg, j)(
        params, j.train_mask)
    vg = tST.make_stream_value_and_grad(_cfg(t, tsynth, tST, model=model),
                                        t, one_rank)
    loss, grads = vg(P.from_numpy_tree(jax.tree.map(np.asarray, params),
                                       "cpu"), t.train_mask)
    _close(loss.item(), P.tree_leaves(grads), float(want_loss),
           _leaves_np(want_grads), f"{model} streamed vs repro")


@pytest.mark.parametrize("agg", BACKENDS)
def test_one_step_ledger(one_rank, reference, agg):
    ref = reference[agg]
    _, _, d, t, cfg = _port_step(agg, one_rank, ref["params"])
    h2d, coll = _split_ledger(d)
    assert sum(v["payload_bytes"] for v in h2d.values()) == \
        tST.expected_h2d_bytes(t, cfg)
    assert all(v["payload_bytes"] == v["wire_bytes"]
               and v["mirrored_calls"] == 0 for v in h2d.values())
    # stripes twice, each round's chunks forward and transposed
    assert [h2d[k]["calls"] for k in sorted(h2d)] == \
        [LAYERS * CHUNKS, LAYERS * CHUNKS, 2 * t.n_stripes]
    if agg != "blocksparse":       # blocksparse stages compressed rows
        assert h2d == ref["h2d"]
    _, _, mem = _in_memory_step(agg, one_rank, ref["params"])
    assert coll == mem
    led = tT.CommLedger.from_dict(coll)
    assert led.call_count("all_to_all", train=True) == 4


def test_stripes_padding_apart_from_chunks_matches_in_memory(one_rank,
                                                              reference):
    """n_stripes ∤ the in-memory padding: lcm(3, 5) pads 96 → 105 rows,
    which enter neither the loss nor the grads."""
    ref = reference["segment"]
    loss, grads, _, t, _ = _port_step("segment", one_rank, ref["params"],
                                      n_stripes=5)
    assert t.n_padded == 105 and t.stripe_rows == 21
    mem_loss, mem_grads, _ = _in_memory_step("segment", one_rank,
                                             ref["params"])
    _close(loss, grads, mem_loss, mem_grads, "n_stripes=5")


def test_footprint_contract():
    _, t = _bundles("segment")
    cfg = _cfg(t, tsynth, tST)
    foot = tST.device_resident_bytes(t, cfg)
    assert foot["staged_stripe_bytes"] == 2 * t.store.rank_block_nbytes
    assert t.store.nbytes == t.n_stripes * t.store.stripe_nbytes
    per_chunk = tST.chunk_input_nbytes(t, gamma=GAMMA)
    assert foot["staged_chunk_bytes"] == 2 * max(per_chunk) > 0
    assert len(per_chunk) == t.n_chunks


# ---------------------------------------------------------------------------
# Gates and primitives
# ---------------------------------------------------------------------------

def test_streamability_gates(one_rank):
    _, t = _bundles("segment")
    cfg = _cfg(t, tsynth, tST)
    with pytest.raises(ValueError, match="naive"):
        tST.make_stream_value_and_grad(cfg, t, one_rank, mode="naive")
    gat = _cfg(t, tsynth, tST, model="gat")
    with pytest.raises(ValueError, match="GAT"):
        tST.make_stream_value_and_grad(gat, t, one_rank)
    with pytest.raises(ValueError, match="blocksparse"):
        tST.make_stream_value_and_grad(cfg, t, one_rank, agg="blocksparse")
    with pytest.raises(ValueError, match="dense"):
        tST.make_stream_value_and_grad(cfg, t, one_rank, agg="dense")
    with pytest.raises(ValueError, match="stream backend must be "
                       "'explicit' or 'constraint', got 'xla'"):
        tST.make_stream_value_and_grad(cfg, t, one_rank, backend="xla")
    two = _bundles("segment", 2)[1]
    with pytest.raises(ValueError, match="n_workers=2"):
        tST.make_stream_value_and_grad(_cfg(two, tsynth, tST), two,
                                       one_rank)


@pytest.mark.parametrize("rs", [jRS, tRS])
def test_prefetched_is_double_buffered(rs):
    staged, order = [], []

    def stage(x):
        staged.append(x)
        return x

    for item in rs.prefetched(range(5), stage, depth=2):
        order.append(item)
        # when the consumer receives c, c+1 has already been staged
        assert len(staged) >= min(len(order) + 1, 5)
        # ...but never more than depth items ahead of consumption
        assert len(staged) - len(order) <= 2
    assert order == staged == list(range(5))
    with pytest.raises(ValueError, match="depth"):
        list(rs.prefetched(range(3), stage, depth=0))


def test_stage_records_h2d_bytes_and_copies():
    tree = {"a": torch.ones(4, 4), "b": torch.ones(2, dtype=torch.int32)}
    with tT.collect_comm() as led:
        out = tRS.stage(tree, "cpu", label="unit").take()
    assert led.as_dict() == {"h2d|unit|float32": {
        "calls": 1.0, "payload_bytes": 72.0, "wire_bytes": 72.0,
        "mirrored_calls": 0.0, "mirrored_wire_bytes": 0.0}}
    for k in tree:
        assert torch.equal(out[k], tree[k])
        assert out[k].data_ptr() != tree[k].data_ptr()


def test_stage_refuses_a_pageable_source_for_a_card():
    """Checked before any copy or record, so it runs without a card."""
    with tT.collect_comm() as led:
        with pytest.raises(ValueError, match="not pinned"):
            tRS.stage((torch.ones(3),), "cuda", copy_stream=object())
        with pytest.raises(ValueError, match="copy stream"):
            tRS.stage((torch.ones(3),), "cuda")
    assert not led


def test_primitives_without_a_card(one_rank):
    z = tRS.global_zeros((3, 4), "cpu")
    assert z.shape == (3, 4) and z.dtype == torch.float32 and not z.any()
    hp = tSP.HalfPlan(torch.zeros(2, dtype=torch.int32),
                      torch.zeros(1, dtype=torch.int32), torch.ones(1), 5)
    assert tRS.pinned(hp, "cpu") is hp
    assert len(tRS.tree_tensors([hp, (torch.ones(2),)])) == 4
    x = torch.ones(2)
    assert tRS.sync_for_collectives(x) is x        # one rank: no barrier


def test_backward_scope_records_backward_calls(one_rank):
    x = torch.zeros(3, 5)
    with tT.collect_comm() as led:
        tT.record("all_to_all", "model", x, group_size=4)
        with tT.backward_scope():
            tT.record("all_to_all", "model", x, group_size=4)
            ttp.gather(torch.zeros(4, 2), one_rank)
    assert led.as_dict() == {"all_to_all|model|float32": {
        "calls": 1.0, "payload_bytes": 60.0, "wire_bytes": 45.0,
        "mirrored_calls": 2.0, "mirrored_wire_bytes": 45.0}}


# ---------------------------------------------------------------------------
# Two ranks
# ---------------------------------------------------------------------------

def _two_rank_worker(rank, world, init, params, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        mesh, out, ledgers = TPMesh(), {}, {}
        for agg in BACKENDS:
            loss, grads, d, t, cfg = _port_step(agg, mesh, params,
                                                n_stripes=4)
            mem_loss, mem_grads, mem = _in_memory_step(agg, mesh, params)
            out[f"{agg}-loss"] = np.float32(loss)
            out[f"{agg}-mem-loss"] = np.float32(mem_loss)
            for i, (g, m) in enumerate(zip(grads, mem_grads)):
                out[f"{agg}-g{i}"], out[f"{agg}-mem-g{i}"] = g.numpy(), \
                    m.numpy()
            h2d, coll = _split_ledger(d)
            ledgers[agg] = {"coll": coll, "mem": mem, "h2d": h2d,
                            "expected": tST.expected_h2d_bytes(t, cfg),
                            "formula": 2 * t.n_padded // world * cfg.in_dim
                            * 4 + LAYERS * sum(
                                tST.chunk_input_nbytes(t, gamma=GAMMA)
                                + tST.chunk_input_nbytes(
                                    t, transposed=True, gamma=GAMMA))}
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(ledgers))
    finally:
        dist.destroy_process_group()


def test_two_ranks_match_in_memory(tmp_path):
    world = 2
    _, t = _bundles("segment", world)
    params = _params(dict(in_dim=t.in_dim_padded, hidden_dim=HIDDEN,
                          num_classes=t.c_padded, num_layers=LAYERS))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_two_rank_worker,
                         args=(r, world, tmp_path / "rendezvous", params,
                               tmp_path)) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * world
    for r in range(world):
        got = np.load(tmp_path / f"rank{r}.npz")
        ledgers = json.loads((tmp_path / f"rank{r}.json").read_text())
        for agg in BACKENDS:
            np.testing.assert_allclose(got[f"{agg}-loss"],
                                       got[f"{agg}-mem-loss"], atol=ATOL)
            for i in range(2 * LAYERS):
                np.testing.assert_allclose(got[f"{agg}-g{i}"],
                                           got[f"{agg}-mem-g{i}"],
                                           atol=ATOL, err_msg=agg)
            led = ledgers[agg]
            assert led["coll"] == led["mem"], agg
            assert tT.CommLedger.from_dict(led["coll"]).wire_bytes(
                "all_to_all", train=True) > 0
            assert sum(v["payload_bytes"] for v in led["h2d"].values()) \
                == led["expected"] == led["formula"], agg
