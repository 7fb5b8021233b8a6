"""The port's decoupled GCN (NN phase, propagation, masked loss) and AdamW
against the JAX package on the same numpy inputs, forward and grads, at
atol 1e-5 (fp32; sums in a different order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.gnn import layers as jL
from repro.gnn import models as jM
from repro_torch import optim as toptim
from repro_torch import params as P
from repro_torch.gnn import layers as tL
from repro_torch.gnn import models as tM
from repro_torch.graph import synthetic as tsynth

ATOL = 1e-5


@pytest.fixture(scope="module")
def problem():
    data = tsynth.sbm_power_law(n=150, num_classes=5, feat_dim=12,
                                avg_degree=6, seed=4)
    cfg = dict(in_dim=12, hidden_dim=10, num_classes=6, num_layers=2,
               gamma=0.9)
    jcfg, tcfg = jM.GNNConfig(**cfg), tM.GNNConfig(**cfg)
    params = jax.tree.map(np.asarray,
                          jM.init_params(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(0)
    mask = (rng.random(data.graph.n) < 0.6).astype(np.float32)
    return data, jcfg, tcfg, params, mask


def _jax_edges(g):
    return jL.EdgeListDev(src=jnp.asarray(g.src), dst=jnp.asarray(g.dst),
                          weight=jnp.asarray(g.weight), n=g.n)


def assert_trees_close(t_tree, j_tree, atol=ATOL):
    for a, b in zip(P.tree_leaves(P.to_numpy_tree(t_tree)),
                    jax.tree.leaves(j_tree)):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol)


def test_weight_bridge_round_trip(problem):
    _, _, _, params, _ = problem
    back = P.to_numpy_tree(P.from_numpy_tree(params, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    nested = {"a": [np.ones(2), (np.zeros(3),)], "b": {"c": np.eye(2)}}
    assert jax.tree.structure(P.to_numpy_tree(
        P.from_numpy_tree(nested, "cpu"))) == jax.tree.structure(nested)


@pytest.mark.parametrize("stage", ["mlp_phase", "decoupled_forward",
                                   "masked_loss"])
def test_forward_and_grads_match_jax(problem, stage):
    data, jcfg, tcfg, params, mask = problem
    g = data.graph
    x = data.features
    labels = data.labels

    def jax_fn(p):
        if stage == "mlp_phase":
            out = jM.mlp_phase(p, jcfg, jnp.asarray(x))
            return out, jnp.mean(out ** 2)
        logits = jM.decoupled_forward(p, jcfg, _jax_edges(g), jnp.asarray(x))
        if stage == "decoupled_forward":
            return logits, jnp.sum(jnp.sin(logits))
        ls, corr, cnt = jM.masked_loss_and_acc(
            logits, jnp.asarray(labels), jnp.asarray(mask), 5)
        return jnp.stack([ls, corr, cnt]), ls / cnt

    def torch_fn(p):
        if stage == "mlp_phase":
            out = tM.mlp_phase(p, tcfg, torch.from_numpy(x))
            return out, torch.mean(out ** 2)
        logits = tM.decoupled_forward(p, tcfg, tL.edge_list_dev(g, "cpu"),
                                      torch.from_numpy(x))
        if stage == "decoupled_forward":
            return logits, torch.sum(torch.sin(logits))
        ls, corr, cnt = tM.masked_loss_and_acc(
            logits, torch.from_numpy(labels), torch.from_numpy(mask), 5)
        return torch.stack([ls, corr, cnt]), ls / cnt

    j_out, _ = jax_fn(params)
    j_grads = jax.grad(lambda p: jax_fn(p)[1])(params)
    tp = P.tree_map(lambda t: t.requires_grad_(),
                    P.from_numpy_tree(params, "cpu"))
    t_out, t_scalar = torch_fn(tp)
    t_grads = P.tree_unflatten(tp, torch.autograd.grad(
        t_scalar, P.tree_leaves(tp)))
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               atol=ATOL, rtol=1e-6)
    assert_trees_close(t_grads, j_grads)


def test_padded_classes_get_no_probability():
    logits = torch.zeros(3, 4, requires_grad=True)
    labels = torch.tensor([0, 1, 1])
    ls, corr, cnt = tM.masked_loss_and_acc(logits, labels,
                                           torch.ones(3), num_classes=2)
    np.testing.assert_allclose(ls.item(), 3 * np.log(2.0), rtol=1e-6)
    (g,) = torch.autograd.grad(ls, logits)
    assert not g[:, 2:].any()


@pytest.mark.parametrize("lr", ["float", "cosine"])
def test_adamw_trajectory_matches_jax(lr):
    rng = np.random.default_rng(7)
    params = {"layers": [{"w": rng.normal(size=(6, 5)).astype(np.float32),
                          "b": rng.normal(size=(5,)).astype(np.float32)},
                         {"w": rng.normal(size=(5, 3)).astype(np.float32),
                          "b": np.zeros(3, np.float32)}]}
    kw = dict(weight_decay=5e-2, grad_clip_norm=1.0)
    if lr == "float":
        jopt, topt = joptim.adamw(1e-2, **kw), toptim.adamw(1e-2, **kw)
    else:
        jopt = joptim.adamw(joptim.cosine_decay(3e-2, 10, 1e-3), **kw)
        topt = toptim.adamw(toptim.cosine_decay(3e-2, 10, 1e-3), **kw)
    jp, tp = jax.tree.map(jnp.asarray, params), P.from_numpy_tree(params,
                                                                  "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(10):
        # gradients large enough that the clip engages on some steps
        grads = jax.tree.map(
            lambda a: (rng.normal(size=a.shape) * (0.1 + step % 3)
                       ).astype(np.float32), params)
        ju, js = jopt.update(jax.tree.map(jnp.asarray, grads), js, jp)
        jp = joptim.apply_updates(jp, ju)
        tu, ts = topt.update(P.from_numpy_tree(grads, "cpu"), ts, tp)
        tp = toptim.apply_updates(tp, tu)
        assert_trees_close(tp, jp)
    assert ts.count == int(js.count) == 10


def test_schedules_match_jax():
    pairs = [(joptim.constant(0.3), toptim.constant(0.3)),
             (joptim.cosine_decay(1.0, 8, 0.1),
              toptim.cosine_decay(1.0, 8, 0.1)),
             (joptim.linear_warmup_cosine(2.0, 3, 10, 0.2),
              toptim.linear_warmup_cosine(2.0, 3, 10, 0.2))]
    for jf, tf in pairs:
        for step in range(12):
            np.testing.assert_allclose(tf(step), float(jf(step)), rtol=1e-6)
