"""The port's host graph code is byte-equal to the JAX package's: the
generators (the typed edges of ``heterogeneous_sbm`` too), the chunk
partition, the per-chunk tile plans (forward and
transposed), the chunk comm tables, the dense adjacency, and the
partitioners, workload statistics and halo plans of ``graph/partition.py``."""
import numpy as np
import pytest

from repro.core import chunks as jchunks
from repro.graph import format as jformat
from repro.graph import partition as jpart
from repro.graph import synthetic as jsynth
from repro_torch.core import chunks as tchunks
from repro_torch.graph import format as tformat
from repro_torch.graph import partition as tpart
from repro_torch.graph import synthetic as tsynth

SIZES = [dict(n=200, num_classes=4, feat_dim=12, avg_degree=6, seed=3),
         dict(n=517, num_classes=7, feat_dim=9, avg_degree=10, seed=11)]


def assert_fields_equal(a, b, fields):
    for f in fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


@pytest.fixture(scope="module", params=range(len(SIZES)))
def pair(request):
    kw = SIZES[request.param]
    return jsynth.sbm_power_law(**kw), tsynth.sbm_power_law(**kw)


def test_generator_byte_equal(pair):
    jd, td = pair
    assert_fields_equal(jd, td, ["features", "labels", "train_mask",
                                 "val_mask", "test_mask"])
    assert_fields_equal(jd.graph, td.graph, ["src", "dst", "weight",
                                             "indptr"])
    assert jd.num_classes == td.num_classes


def test_reddit_like_byte_equal():
    jd, td = jsynth.reddit_like(0.01, seed=2), tsynth.reddit_like(0.01, seed=2)
    assert td.features.shape == (1024, 602) and td.num_classes == 41
    assert_fields_equal(jd, td, ["features", "labels", "train_mask"])
    assert_fields_equal(jd.graph, td.graph, ["src", "dst", "weight"])


def test_heterogeneous_sbm_byte_equal():
    kw = dict(n=300, num_classes=4, num_edge_types=3, feat_dim=9,
              avg_degree=7, seed=5)
    jd, td = jsynth.heterogeneous_sbm(**kw), tsynth.heterogeneous_sbm(**kw)
    assert td.num_edge_types == jd.num_edge_types == 3
    assert td.edge_types.shape == (td.graph.e,)
    assert_fields_equal(jd, td, ["features", "labels", "train_mask",
                                 "val_mask", "test_mask", "edge_types"])
    assert_fields_equal(jd.graph, td.graph, ["src", "dst", "weight",
                                             "indptr"])


def test_barabasi_albert_byte_equal_and_registry():
    kw = dict(n=150, m=3, feat_dim=6, num_classes=4, seed=1)
    jd, td = jsynth.barabasi_albert(**kw), tsynth.barabasi_albert(**kw)
    assert td.edge_types is None and td.num_edge_types == 1
    assert_fields_equal(jd, td, ["features", "labels", "train_mask"])
    assert_fields_equal(jd.graph, td.graph, ["src", "dst", "weight",
                                             "indptr"])
    assert {k: v.__name__ for k, v in tsynth.REGISTRY.items()} == \
        {k: v.__name__ for k, v in jsynth.REGISTRY.items()}


@pytest.mark.parametrize("n_chunks", [3, 4])
def test_chunk_graph_and_comm_plan_byte_equal(pair, n_chunks):
    jd, td = pair
    jcg = jformat.chunk_graph(jd.graph, n_chunks)
    tcg = tformat.chunk_graph(td.graph, n_chunks)
    assert (jcg.n, jcg.n_chunks, jcg.chunk_size) == \
        (tcg.n, tcg.n_chunks, tcg.chunk_size)
    assert_fields_equal(jcg, tcg, ["src", "dst_local", "weight", "edge_id",
                                   "new_src", "new_src_count"])
    n_padded = n_chunks * jcg.chunk_size
    for workers in (1, 2):
        if n_padded % workers:
            continue
        jp = jchunks.build_chunk_comm_plan(jcg, workers, n_padded)
        tp = tchunks.build_chunk_comm_plan(tcg, workers, n_padded,
                                           device="cpu")
        assert (jp.m_split, jp.m_gather) == (tp.m_split, tp.m_gather)
        for f in ("split_rows", "gather_rows"):
            x = np.asarray(getattr(jp, f))
            y = getattr(tp, f).numpy()
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


PLAN_FIELDS = ["block_rows", "block_cols", "row_first", "blocks",
               "block_rows_t", "block_cols_t", "row_first_t", "blocks_t"]


@pytest.mark.parametrize("bs", [32, 64])
def test_chunk_block_sparse_byte_equal(pair, bs):
    jd, td = pair
    jp = jformat.chunk_block_sparse(jd.graph, 3, bs=bs)
    tp = tformat.chunk_block_sparse(td.graph, 3, bs=bs)
    assert (jp.n_rows, jp.n_cols, jp.rows_padded, jp.cols_padded) == \
        (tp.n_rows, tp.n_cols, tp.rows_padded, tp.cols_padded)
    assert_fields_equal(jp, tp, PLAN_FIELDS)


@pytest.mark.parametrize("bs", [32, 64])
def test_block_sparse_and_transpose_byte_equal(pair, bs):
    jd, td = pair
    jb = jformat.block_sparse(jd.graph, bs=bs)
    tb = tformat.block_sparse(td.graph, bs=bs)
    fields = ["block_rows", "block_cols", "row_first", "blocks"]
    assert_fields_equal(jb, tb, fields)
    assert_fields_equal(jformat.block_sparse_transpose(jb),
                        tformat.block_sparse_transpose(tb), fields)


def test_coo_tiles_accumulate_duplicate_edges():
    """Parallel (dst, src) entries accumulate in a tile cell."""
    dst = np.array([0, 0, 5], np.int32)
    src = np.array([1, 1, 2], np.int32)
    w = np.array([0.5, 0.25, 1.0], np.float32)
    rows, cols, blocks = tformat._coo_tiles(dst, src, w, 1, 1, 32)
    assert blocks[0, 0, 1] == np.float32(0.75) and blocks[0, 5, 2] == 1.0


def test_dense_adjacency_byte_equal(pair):
    jd, td = pair
    a, b = jd.graph.dense_adjacency(), td.graph.dense_adjacency()
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _partitions(mod, g, k):
    return {"chunk-vertex": mod.chunk_partition(g, k, balance="vertex"),
            "chunk-edge": mod.chunk_partition(g, k, balance="edge"),
            "hash": mod.hash_partition(g, k, seed=4),
            "greedy": mod.greedy_edge_cut_partition(g, k)}


@pytest.mark.parametrize("k", [1, 2, 3])
def test_partitions_and_workload_stats_byte_equal(pair, k):
    jd, td = pair
    jparts, tparts = _partitions(jpart, jd.graph, k), \
        _partitions(tpart, td.graph, k)
    for name, jp in jparts.items():
        tp = tparts[name]
        assert jp.k == tp.k, name
        fields = ["owner"] + (["bounds"] if jp.bounds is not None else [])
        assert (tp.bounds is None) == (jp.bounds is None), name
        assert_fields_equal(jp, tp, fields)
        js = jpart.workload_stats(jd.graph, jp)
        ts = tpart.workload_stats(td.graph, tp)
        assert_fields_equal(js, ts, ["vertices", "edges", "remote_srcs"])
        assert js.as_dict() == ts.as_dict(), name
    assert jpart.tensor_parallel_stats(jd.graph, k, 16).as_dict() == \
        tpart.tensor_parallel_stats(td.graph, k, 16).as_dict()


@pytest.mark.parametrize("balance", ["vertex", "edge"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_halo_plan_byte_equal(pair, k, balance):
    jd, td = pair
    jh = jpart.halo_plan(jd.graph, jpart.chunk_partition(jd.graph, k,
                                                         balance=balance))
    th = tpart.halo_plan(td.graph, tpart.chunk_partition(td.graph, k,
                                                         balance=balance))
    assert (jh.k, jh.m, jh.halo_size) == (th.k, th.m, th.halo_size)
    assert_fields_equal(jh, th, ["send_idx", "recv_pos", "n_local"])
    for f in ("local_src", "local_dst", "local_w"):
        a, b = getattr(jh, f), getattr(th, f)
        assert len(a) == len(b) == k, f
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
