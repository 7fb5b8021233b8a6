"""``gnn/dp_baseline.py::make_dp_loss_fn`` against the JAX package's: the
DP halo-exchange baseline's differentiable (params, mask) → loss.

Its loss, and the gradients ``torch.autograd.grad`` takes through it,
within atol 1e-5 of ``jax.value_and_grad`` of the reference's
``make_dp_loss_fn`` on the same weights, for the explicit and constraint
engine backends and the segment and blocksparse aggregation backends: at
one gloo rank in process (k=1, ``tp_mesh(1)``), and at four spawned gloo
ranks (k=4) against a JAX child with four forced host devices — each
rank's gradients summed over the ranks in the backward, as
``make_dp_value_and_grad``'s.  One spawn of four ranks for the file,
beside the JAX child."""
import datetime
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.gnn import dp_baseline as jDP
from repro.gnn import models as jM
from repro.graph import synthetic as jsynth
from repro.runtime import tp_mesh
from repro_torch import params as P
from repro_torch.gnn import dp_baseline as tDP
from repro_torch.gnn import models as tM
from repro_torch.graph import synthetic as tsynth
from repro_torch.runtime import TPMesh

ATOL = 1e-5
GRAPH = dict(n=130, num_classes=5, feat_dim=10, avg_degree=6, seed=2)
BS, HIDDEN, LAYERS = 32, 8, 2
ENGINES = ("explicit", "constraint")
AGGS = ("segment", "blocksparse")
TIMEOUT = datetime.timedelta(seconds=60)
ROOT = Path(__file__).resolve().parents[1]


def _cfgs():
    kw = dict(in_dim=GRAPH["feat_dim"], hidden_dim=HIDDEN,
              num_classes=GRAPH["num_classes"], num_layers=LAYERS)
    return jM.GNNConfig(**kw, decoupled=False), tM.GNNConfig(**kw)


def _params(seed):
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray,
                        jM.init_params(jax.random.PRNGKey(seed), jcfg))


def _reference(k: int, seed: int, mesh) -> dict:
    """The reference's loss and gradients at k partitions, every case."""
    jcfg, _ = _cfgs()
    data = jsynth.sbm_power_law(**GRAPH)
    params = jax.tree.map(jnp.asarray, _params(seed))
    out = {}
    for agg in AGGS:
        bundle = jDP.prepare_dp_bundle(data, k=k, agg=agg, agg_block_size=BS)
        for engine in ENGINES:
            loss_fn = jDP.make_dp_loss_fn(jcfg, bundle, mesh, backend=engine,
                                          agg=agg)
            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
                params, bundle.train_mask)
            out[f"{engine}-{agg}"] = [np.asarray(loss)] + [
                np.asarray(g) for g in jax.tree.leaves(grads)]
    return out


def _port(k: int, seed: int) -> dict:
    """The port's loss and gradients through ``make_dp_loss_fn`` at k
    partitions on the initialised default group, every case."""
    _, cfg = _cfgs()
    data = tsynth.sbm_power_law(**GRAPH)
    out = {}
    for agg in AGGS:
        bundle = tDP.prepare_dp_bundle(data, k=k, agg=agg, agg_block_size=BS,
                                       device="cpu")
        for engine in ENGINES:
            p = P.from_numpy_tree(_params(seed), "cpu")
            leaves = [t.requires_grad_() for t in P.tree_leaves(p)]
            loss_fn = tDP.make_dp_loss_fn(cfg, bundle, TPMesh(), agg=agg,
                                          backend=engine)
            loss = loss_fn(P.tree_unflatten(p, leaves), bundle.train_mask)
            grads = torch.autograd.grad(loss, leaves)
            out[f"{engine}-{agg}"] = [loss.detach().numpy()] + [
                g.numpy() for g in grads]
    return out


def _held(got: list, want: list, what: str) -> None:
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.shape(a) == np.shape(b), (what, i)
        np.testing.assert_allclose(a, b, atol=ATOL,
                                   err_msg=f"{what} leaf {i}")


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    init = tmp_path_factory.mktemp("pg") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                            world_size=1, timeout=TIMEOUT)
    try:
        yield _port(1, seed=3), _reference(1, 3, tp_mesh(1))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("engine", ENGINES)
def test_one_rank_matches_reference(one_rank, engine, agg):
    got, want = one_rank
    _held(got[f"{engine}-{agg}"], want[f"{engine}-{agg}"], engine)


def _reference_child(out: str) -> None:
    assert len(jax.devices()) == 4
    np.savez(out, **{f"{k}/{i}": a for k, v in
                     _reference(4, 5, tp_mesh(4)).items()
                     for i, a in enumerate(v)})


def _port_rank(rank, world, init, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        np.savez(f"{out_dir}/rank{rank}.npz",
                 **{f"{k}/{i}": a for k, v in _port(world, 5).items()
                    for i, a in enumerate(v)})
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    world, tmp = 4, tmp_path_factory.mktemp("four")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={world} "
           "--xla_cpu_multi_thread_eigen=false"}
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; "
            "import test_torch_dp_loss_fn as t; "
            "t._reference_child({!r})").format(
                str(ROOT / "tests"), str(ROOT / "src"), str(tmp / "ref.npz"))
    child = subprocess.Popen([sys.executable, "-c", code], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_port_rank,
                         args=(r, world, tmp / "rendezvous", tmp))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
    for p in procs:
        if p.is_alive():
            p.kill()
    _, err = child.communicate(timeout=180)
    assert child.returncode == 0, err[-3000:]
    assert [p.exitcode for p in procs] == [0] * world

    def load(path):
        npz = np.load(path)
        out = {}
        for key in npz.files:
            case, i = key.split("/")
            out.setdefault(case, {})[int(i)] = npz[key]
        return {c: [v[i] for i in sorted(v)] for c, v in out.items()}
    return ([load(tmp / f"rank{r}.npz") for r in range(world)],
            load(tmp / "ref.npz"))


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("engine", ENGINES)
def test_four_ranks_match_reference(four_ranks, engine, agg):
    ranks, want = four_ranks
    for r, got in enumerate(ranks):
        _held(got[f"{engine}-{agg}"], want[f"{engine}-{agg}"],
              f"rank {r} {engine}")


def test_loss_fn_grads_equal_value_and_grad(one_rank):
    """At one rank, the gradients through ``make_dp_loss_fn`` equal
    ``make_dp_value_and_grad``'s, bitwise, on both engines."""
    _, cfg = _cfgs()
    data = tsynth.sbm_power_law(**GRAPH)
    bundle = tDP.prepare_dp_bundle(data, k=1, agg="segment", device="cpu")
    for engine in ENGINES:
        p = P.from_numpy_tree(_params(3), "cpu")
        leaves = [t.requires_grad_() for t in P.tree_leaves(p)]
        loss = tDP.make_dp_loss_fn(cfg, bundle, TPMesh(), backend=engine)(
            P.tree_unflatten(p, leaves), bundle.train_mask)
        grads = torch.autograd.grad(loss, leaves)
        vloss, vgrads = tDP.make_dp_value_and_grad(cfg, bundle, TPMesh(),
                                                   backend=engine)(
            P.from_numpy_tree(_params(3), "cpu"), bundle.train_mask)
        assert torch.equal(loss.detach(), vloss.detach()), engine
        for a, b in zip(grads, P.tree_leaves(vgrads)):
            assert torch.equal(a, b), engine
