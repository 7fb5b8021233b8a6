"""The port's ``checkpoint`` against the JAX package's, on the CPU.

* ``tests/test_checkpoint.py``'s cases on the port: the round trip with
  metadata, a leaf-count, a treedef, a shape and a dtype mismatch (each
  error naming the leaf's path as ``jax.tree_util.keystr`` does), and
  plain host leaves.
* A ``DTensor`` that is not replicated is refused, naming the leaf, on a
  1-rank gloo mesh; a replicated one saves.
* For all five models, a parameter checkpoint saved by one package
  restores in the other, both ways, with the manifest's ``treedef``
  byte-equal to ``str(jax.tree_util.tree_structure(...))``.
* Optimizer state (AdamW, and SGD with its ``nu=None``) round-trips within
  the port, its Python ``int`` step count included.
"""
import datetime
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import checkpoint as jckpt
from repro import optim as joptim
from repro.gnn import models as jM
from repro_torch import checkpoint
from repro_torch import optim as toptim
from repro_torch import params as P
from repro_torch.gnn import models as tM
from repro_torch.runtime import TPMesh

TIMEOUT = datetime.timedelta(seconds=60)


def params(dtype=torch.float32, step=np.int32(3)):
    return {"layers": [{"w": torch.ones((4, 2), dtype=dtype),
                        "b": torch.zeros(2)}],
            "step": step}


def test_roundtrip(tmp_path):
    p = params()
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, p, metadata={"epoch": 9})
    out = checkpoint.restore(path, P.tree_map(
        lambda t: torch.zeros_like(t) if isinstance(t, torch.Tensor)
        else np.zeros_like(t), p))
    for a, b in zip(P.tree_leaves(p), P.tree_leaves(out)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert isinstance(out["layers"][0]["w"], torch.Tensor)
    assert checkpoint.load_metadata(path)["epoch"] == 9


def test_restore_rejects_leaf_count_mismatch(tmp_path):
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, params())
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(path, {"w": torch.ones((4, 2))})


def test_restore_rejects_treedef_mismatch(tmp_path):
    """Same leaf count, different structure: refused instead of restoring
    leaves into the wrong slots."""
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, params())
    renamed = params()
    renamed["step_count"] = renamed.pop("step")     # same arity
    with pytest.raises(ValueError) as ei:
        checkpoint.restore(path, renamed)
    msg = str(ei.value)
    assert "tree structure" in msg
    assert "stored:" in msg and "template:" in msg
    as_tuple = params()
    as_tuple["layers"] = tuple(as_tuple["layers"])  # a list became a tuple
    with pytest.raises(ValueError, match="tree structure"):
        checkpoint.restore(path, as_tuple)


def test_restore_rejects_shape_mismatch_naming_path(tmp_path):
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, params())
    bad = params()
    bad["layers"][0]["w"] = torch.ones((4, 3))
    with pytest.raises(ValueError) as ei:
        checkpoint.restore(path, bad)
    assert "['layers'][0]['w']" in str(ei.value)
    assert "(4, 2)" in str(ei.value) and "(4, 3)" in str(ei.value)


def test_restore_rejects_dtype_mismatch_naming_path(tmp_path):
    """The int-step-counter-restored-as-float corruption, pinned."""
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, params())
    with pytest.raises(ValueError) as ei:
        checkpoint.restore(path, params(step=torch.tensor(3.0)))
    msg = str(ei.value)
    assert "['step']" in msg and "int32" in msg and "float32" in msg


def test_save_accepts_plain_host_leaves(tmp_path):
    path = str(tmp_path / "ckpt")
    tree = {"a": np.arange(3), "b": 1.5}
    checkpoint.save(path, tree)
    out = checkpoint.restore(path, tree)
    np.testing.assert_array_equal(out["a"], tree["a"])
    assert out["b"] == 1.5 and type(out["b"]) is float


def test_save_refuses_a_sharded_dtensor(tmp_path):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1, timeout=TIMEOUT)
    try:
        dm = TPMesh().device_mesh("cpu")
        w = torch.arange(8.0).reshape(4, 2)
        sharded = {"layers": [{"w": DTensor.from_local(w, dm, [Shard(0)])}]}
        where = r"leaf \['layers'\]\[0\]\['w'\] is a DTensor"
        with pytest.raises(ValueError, match=where):
            checkpoint.save(str(tmp_path / "sharded"), sharded)
        path = str(tmp_path / "replicated")
        checkpoint.save(path, {"w": DTensor.from_local(w, dm, [Replicate()])})
        out = checkpoint.restore(path, {"w": torch.zeros(4, 2)})
        assert torch.equal(out["w"], w)
    finally:
        dist.destroy_process_group()


def _cfg(model):
    return dict(model=model, in_dim=6, hidden_dim=5, num_classes=3,
                num_layers=2, num_edge_types=3)


@pytest.mark.parametrize("direction", ["reference->port", "port->reference"])
@pytest.mark.parametrize("model", tM.MODELS)
def test_parameters_restore_across_packages(tmp_path, model, direction):
    jtree = jM.init_params(jax.random.PRNGKey(1),
                           jM.GNNConfig(**_cfg(model)))
    ttree = tM.init_params(tM.GNNConfig(**_cfg(model)),
                           torch.Generator().manual_seed(1), "cpu")
    path = str(tmp_path / "ckpt")
    if direction == "reference->port":
        jckpt.save(path, jtree, metadata={"by": "reference"})
        got = checkpoint.restore(path, P.tree_map(torch.zeros_like, ttree))
        got = P.tree_leaves(P.to_numpy_tree(got))
        want = jax.tree.leaves(jtree)
    else:
        checkpoint.save(path, ttree, metadata={"by": "port"})
        got = jckpt.restore(path, jax.tree.map(jnp.zeros_like, jtree))
        got, want = jax.tree.leaves(got), P.tree_leaves(
            P.to_numpy_tree(ttree))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    manifest = json.loads((tmp_path / "ckpt.manifest.json").read_text())
    assert manifest["treedef"] == str(jax.tree_util.tree_structure(jtree))
    assert jckpt.load_metadata(path) == checkpoint.load_metadata(path)


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_optimizer_state_round_trips(tmp_path, opt):
    tree = tM.init_params(tM.GNNConfig(**_cfg("gcn")),
                          torch.Generator().manual_seed(2), "cpu")
    optimizer = toptim.adamw(1e-2) if opt == "adamw" else toptim.sgd(
        1e-2, momentum=0.9)
    state = optimizer.init(tree)
    grads = P.tree_map(torch.ones_like, tree)
    for _ in range(3):
        _, state = optimizer.update(grads, state, tree)
    path = str(tmp_path / "opt")
    checkpoint.save(path, state)
    fresh = optimizer.init(tree)
    out = checkpoint.restore(path, fresh)
    assert type(out) is toptim.OptState and out.count == 3
    assert type(out.count) is int
    assert (out.nu is None) == (opt == "sgd")
    for a, b in zip(P.tree_leaves(out.mu), P.tree_leaves(state.mu)):
        assert torch.equal(a, b)
    # the treedef of the reference's state of the same tree
    jopt = joptim.adamw(1e-2) if opt == "adamw" else joptim.sgd(1e-2, 0.9)
    jtree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)
    assert checkpoint._flatten(state)[2] == \
        str(jax.tree_util.tree_structure(jopt.init(jtree)))
