"""The plain reference's training step against dense matrix arithmetic
and ``torch.optim.AdamW`` on a tiny graph."""
import pytest
import torch
import torch.nn.functional as F

from tiny import tiny_cell

from tpbench import compare, graphgen
from tpbench.reference import gnn

SEED = 11


def _inputs(model):
    cell = tiny_cell(f"{model}-reddit.tp1")
    conf = cell["config"]
    raw = graphgen.draw_graph(conf["graph"], SEED, "cpu")
    dims = [23, 16, 7]            # padded rows and class columns
    params = compare.flatten(graphgen.init_weights(model, dims, SEED, "cpu"))
    m = dict(conf["model"], num_classes=raw["num_classes"])
    return conf, raw, params, m


def _dense_loss(params, model, raw, graph):
    n, f = raw["n"], raw["features"].shape[1]
    h = raw["features"] @ params["layers.0.w"][:f]
    if model == "gcn":
        h = torch.relu(h + params["layers.0.b"])
        h = h @ params["layers.1.w"] + params["layers.1.b"]
        a = torch.zeros(n, n, dtype=torch.float64)
        a[graph["dst"], graph["src"]] = graph["weight"].double()
        a = a.float()
    else:
        h = F.elu(h) @ params["layers.1.w"]
        e = F.leaky_relu((h @ params["layers.1.a_l"])[None, :]
                         + (h @ params["layers.1.a_r"])[:, None], 0.2)
        adj = torch.zeros(n, n, dtype=torch.bool)
        adj[graph["dst"], graph["src"]] = True
        a = torch.softmax(e.masked_fill(~adj, float("-inf")), dim=1)
    z = a @ (a @ h)
    logp = torch.log_softmax(z[:, :raw["num_classes"]], dim=1)
    nll = -logp[torch.arange(n), raw["labels"]]
    return (nll * raw["train"]).sum() / raw["train"].sum()


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_step_against_dense(model):
    conf, raw, params, m = _inputs(model)
    graph = gnn.normalize(raw["src"], raw["dst"], raw["n"])
    got = gnn.train(params, m, conf["optimizer"], raw["features"],
                    raw["labels"], raw["train"], graph, steps=1)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    want = _dense_loss(leaves, model, raw, graph)
    grads = torch.autograd.grad(want, list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
    assert got["losses"][0] == pytest.approx(float(want.detach()), rel=1e-5)
    for k, g in zip(leaves, grads):
        assert torch.allclose(got["grad1"][k], g, rtol=1e-4, atol=1e-6), k
    if model == "gat":          # the first layer's scores are unused
        assert float(got["grad1"]["layers.0.a_l"].abs().max()) == 0.0


def test_aggregate_backward_against_autograd():
    g = torch.Generator().manual_seed(3)
    n, e, d = 9, 40, 5
    src = torch.randint(0, n, (e,), generator=g)
    dst = torch.randint(0, n, (e,), generator=g)
    z = torch.randn(n, d, generator=g, requires_grad=True)
    w = torch.rand(e, generator=g, requires_grad=True)
    out = gnn.aggregate(z, w, {"src": src, "dst": dst})
    plain = torch.zeros(n, d).index_add(0, dst, z[src] * w[:, None])
    assert torch.allclose(out, plain, atol=1e-6)
    up = torch.randn(n, d, generator=g)
    a = torch.autograd.grad((out * up).sum(), (z, w))
    b = torch.autograd.grad((plain * up).sum(), (z, w))
    for x, y in zip(a, b):
        assert torch.allclose(x, y, atol=1e-5)


def test_adamw_against_torch():
    conf, raw, params, m = _inputs("gcn")
    opt = conf["optimizer"]
    graph = gnn.normalize(raw["src"], raw["dst"], raw["n"])
    got = gnn.train(params, m, opt, raw["features"], raw["labels"],
                    raw["train"], graph, steps=3)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    mats = [v for v in leaves.values() if v.dim() >= 2]
    vecs = [v for v in leaves.values() if v.dim() < 2]
    torch_opt = torch.optim.AdamW(
        [{"params": mats, "weight_decay": opt["weight_decay"]},
         {"params": vecs, "weight_decay": 0.0}],
        lr=opt["lr"], betas=(opt["b1"], opt["b2"]), eps=opt["eps"])
    for _ in range(3):
        torch_opt.zero_grad()
        gnn.loss(gnn.logits(leaves, "gcn", 2, raw["features"], graph),
                 raw["labels"], raw["train"], raw["num_classes"]).backward()
        torch_opt.step()
    for k, v in leaves.items():
        assert torch.allclose(got["delta"][k], v.detach() - params[k],
                              atol=1e-6), k


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, 1 + 2 ** -10,
                      -3.0000002])
    r = gnn.tf32_round(x)
    assert r.tolist()[:4] == [1.0, 1.0, 1 + 2 ** -9, 1 + 2 ** -10]
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    assert float(r[4]) == -3.0
