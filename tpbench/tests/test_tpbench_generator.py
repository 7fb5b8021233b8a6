"""The benchmark's graph generator and load step at a tiny size."""
import torch

from tiny import GRAPH, tiny_cell

from tpbench import graphgen

SEED = 2 ** 31 + 17


def _draw(seed=SEED):
    return graphgen.draw_graph(tiny_cell("gcn-reddit.tp1")["config"]["graph"],
                               seed, "cpu")


def test_sizes_and_splits():
    raw = _draw()
    n = GRAPH["num_vertices"]
    assert raw["features"].shape == (n, GRAPH["num_features"])
    assert raw["features"].dtype == torch.float32
    assert raw["labels"].shape == (n,)
    assert int(raw["labels"].max()) < GRAPH["num_classes"]
    for split, count in GRAPH["split"].items():
        assert int(raw[split].sum()) == count
    assert not (raw["train"] & raw["val"]).any()
    assert not (raw["train"] & raw["test"]).any()
    assert raw["src"].numel() == GRAPH["num_edges"]
    assert torch.unique(raw["dst"] * n + raw["src"]).numel() == \
        GRAPH["num_edges"]
    assert not (raw["src"] == raw["dst"]).any()
    assert int(raw["src"].max()) < n and int(raw["dst"].max()) < n


def test_one_graph_every_seed_its_own_data():
    a, b, c = _draw(), _draw(), _draw(SEED + 1)
    for k in ("src", "dst", "features", "labels", "train"):
        assert torch.equal(a[k], b[k])
    for k in ("src", "dst", "labels"):          # the structure
        assert torch.equal(a[k], c[k])
    for k in ("features", "train"):
        assert not torch.equal(a[k], c[k])


def test_normalize_dedups_sorts_and_weighs():
    raw = _draw()
    n = raw["n"]
    g = graphgen.normalize(raw["src"], raw["dst"], n)
    src, dst = g["src"].long(), g["dst"].long()
    key = dst * n + src
    assert torch.equal(key, torch.unique(key))          # sorted, no repeats
    pairs = set(zip(raw["dst"].tolist(), raw["src"].tolist()))
    pairs |= {(v, v) for v in range(n)}
    assert set(zip(dst.tolist(), src.tolist())) == pairs
    din = torch.bincount(dst, minlength=n).double()
    dout = torch.bincount(src, minlength=n).double()
    w = 1 / torch.sqrt(din[dst] * dout[src])
    assert torch.allclose(g["weight"].double(), w, rtol=1e-7)
    assert torch.equal(g["indptr"][1:] - g["indptr"][:-1], din.long())


def test_weights_tree_and_seed():
    dims = [GRAPH["num_features"], 16, 5]
    gcn = graphgen.init_weights("gcn", dims, SEED, "cpu")
    gat = graphgen.init_weights("gat", dims, SEED, "cpu")
    assert [sorted(layer) for layer in gcn["layers"]] == [["b", "w"]] * 2
    assert [sorted(layer) for layer in gat["layers"]] == \
        [["a_l", "a_r", "w"]] * 2
    assert gcn["layers"][0]["w"].shape == (21, 16)
    assert torch.equal(gcn["layers"][0]["w"],
                       graphgen.init_weights("gcn", dims, SEED, "cpu")
                       ["layers"][0]["w"])
    lim = (6 / (21 + 16)) ** 0.5
    assert float(gcn["layers"][0]["w"].abs().max()) <= lim
