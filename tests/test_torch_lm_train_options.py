"""The LM train step's options, against the JAX package where it has
them (reduced configs, fp32, 2 × 16 tokens): one ``sgd`` step's
parameters against the reference's at 1e-5·(1 + max|ref|);
``remat`` True / False / ``"dots"`` giving equal losses and gradients,
the recompute counted and nothing recomputed under ``no_grad``; the
softcapped logits equal with and without a gradient; ``donate``; a sharded
step at one gloo rank against the unsharded one, under neutron_tp and
megatron, with its refusals (shardings that are not the sharder's); and a
config whose forward calls a forward-only kernel,
refused beside the reference's own failure on the same config."""
import dataclasses
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro import optim as joptim
from repro.data.synthetic_lm import SyntheticLM as JSyntheticLM
from repro.train import loop as jloop
from repro.train.state import init_train_state as j_init_train_state
from repro_torch import configs, optim
from repro_torch.data import SyntheticLM
from repro_torch.models import blocks as TB
from repro_torch.models import transformer as TT
from repro_torch.params import (from_numpy_tree, to_numpy_tree, tree_leaves,
                                tree_map, tree_unflatten)
from repro_torch.train import init_train_state, make_loss_fn, make_train_step
from torch_lm_configs_cases import one_torch_thread  # noqa: F401

ARCHS = jconfigs.list_archs()
SEQ = 16
RTOL = 1e-5


def _ref_model(arch: str, n_batches: int = 1):
    """``arch`` reduced: the reference's config, weights drawn by the port
    (as numpy), ``n_batches`` batches."""
    cfg = jconfigs.get_config(arch).reduced()
    params = to_numpy_tree(TT.init_transformer(
        configs.get_config(arch + "-reduced"), seed=0, device="cpu"))
    data = JSyntheticLM(cfg.vocab_size, seed=1).batches(2, SEQ, cfg)
    return cfg, params, [next(data) for _ in range(n_batches)]


def _port_model(arch: str):
    """``arch`` reduced with the port's own weights and one batch."""
    tcfg = configs.get_config(arch + "-reduced")
    params = TT.init_transformer(tcfg, seed=0, device="cpu")
    batch = next(SyntheticLM(tcfg.vocab_size, seed=1).batches(2, SEQ, tcfg))
    return tcfg, params, batch


@pytest.mark.parametrize("arch", ["gemma2-9b", "internvl2-1b", "zamba2-2.7b",
                                  "deepseek-v2-lite-16b"])
def test_sgd_step_params_match_reference(arch):
    cfg, params, (batch,) = _ref_model(arch)
    jstep = jloop.make_train_step(cfg, joptim.sgd(0.1), donate=False)
    jstate, _ = jstep(j_init_train_state(params, joptim.sgd(0.1)), batch)
    opt = optim.sgd(0.1)
    state, _ = make_train_step(configs.get_config(arch + "-reduced"), opt)(
        init_train_state(from_numpy_tree(params, "cpu"), opt), batch)
    leaves_j = jax.tree.leaves(jstate.params)
    assert len(leaves_j) == len(tree_leaves(state.params))
    for got, want in zip(tree_leaves(state.params), leaves_j):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        assert err <= RTOL * (1 + np.abs(want).max()), err
class _OpCount(TorchDispatchMode):
    """Counts aten calls by name (on the CPU the backward, recompute
    included, runs on the calling thread)."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.n[name] = self.n.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


# gemma2-reduced's group is one repeat of (local, global): not checkpointed
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-2.7b",
                                  "internvl2-1b", "gemma2-9b"])
def test_remat_modes_agree_and_recompute(arch):
    """``remat`` True, False and ``"dots"`` give the same total and
    gradients bitwise; each repeat of a repeated group runs its blocks
    twice under True and ``"dots"`` (forward and recompute), once under
    False; ``"dots"`` recomputes no plain matmul (``aten.mm``) but the
    batched ones, True both."""
    tcfg, params, batch = _port_model(arch)
    repeated = sum(len(g.unit) * g.repeats for g in TB.layer_groups(tcfg)
                   if g.repeats > 1)
    out, calls, ops = {}, {}, {}
    apply_block = TB.apply_block
    for remat in (False, True, "dots"):
        n = [0]

        def counting(*a, **k):
            n[0] += 1
            return apply_block(*a, **k)
        live = [t.detach().requires_grad_() for t in tree_leaves(params)]
        with mock.patch.object(TB, "apply_block", counting):
            total, _ = make_loss_fn(tcfg, remat=remat)(
                tree_unflatten(params, live), batch)
            with _OpCount() as c:
                grads = torch.autograd.grad(total, live)
        out[remat], calls[remat], ops[remat] = (total, grads), n[0], c.n
    for remat in (True, "dots"):
        assert torch.equal(out[remat][0], out[False][0])
        for a, b in zip(out[remat][1], out[False][1]):
            assert torch.equal(a, b)
        assert calls[remat] == calls[False] + repeated
    assert calls[False] == tcfg.num_layers
    assert ops["dots"].get("mm", 0) == ops[False].get("mm", 0)
    if repeated:
        assert ops[True]["mm"] > ops[False]["mm"]
        if tcfg.moe:
            assert ops["dots"]["bmm"] == ops[True]["bmm"] > ops[False]["bmm"]


def test_remat_under_no_grad_runs_once():
    """Scoring under ``no_grad`` checkpoints nothing: one call a block."""
    tcfg = configs.get_config("zamba2-2.7b-reduced")
    params = TT.init_transformer(tcfg, seed=0, device="cpu")
    tokens = torch.zeros(1, 8, dtype=torch.long)
    apply_block = TB.apply_block
    n = [0]

    def counting(*a, **k):
        n[0] += 1
        return apply_block(*a, **k)
    with torch.no_grad(), mock.patch.object(TB, "apply_block", counting):
        TT.forward(params, tcfg, tokens, remat=True)
    assert n[0] == tcfg.num_layers
    with pytest.raises(ValueError, match="remat"):
        TT.forward(params, tcfg, tokens, remat="all")


def test_softcapped_logits_equal_with_and_without_grad():
    """gemma2's logit softcap: in place under ``no_grad``, out of place
    under a gradient, the same values."""
    tcfg = configs.get_config("gemma2-9b-reduced")
    params = TT.init_transformer(tcfg, seed=0, device="cpu")
    tokens = torch.arange(12).reshape(1, 12)
    with torch.no_grad():
        want, _ = TT.forward(params, tcfg, tokens)
    params["embed"].requires_grad_()
    got, _ = TT.forward(params, tcfg, tokens)
    assert got.requires_grad and torch.equal(got.detach(), want)
    got.sum().backward()
    assert torch.isfinite(params["embed"].grad).all()


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "internvl2-1b"])
def test_donate(arch):
    """``donate=False`` leaves the state passed in bitwise unchanged;
    ``donate=True`` gives the same new state, in the state's own tensors."""
    tcfg, params, batch = _port_model(arch)
    opt = optim.adamw(1e-3)
    kept = init_train_state(params, opt)
    before = [t.clone() for t in tree_leaves(kept.params)]
    new, m = make_train_step(tcfg, opt, donate=False)(kept, batch)
    assert kept.step == 0 and kept.opt_state.count == 0 and new.step == 1
    for a, b in zip(tree_leaves(kept.params), before):
        assert torch.equal(a, b)
    assert all(not t.any() for t in tree_leaves(kept.opt_state.mu))

    donated = init_train_state(tree_map(torch.clone, params), opt)
    ptrs = [t.data_ptr() for t in tree_leaves(donated.params)
            + tree_leaves(donated.opt_state.mu)
            + tree_leaves(donated.opt_state.nu)]
    new_d, m_d = make_train_step(tcfg, opt, donate=True)(donated, batch)
    assert [t.data_ptr() for t in tree_leaves(new_d.params)
            + tree_leaves(new_d.opt_state.mu)
            + tree_leaves(new_d.opt_state.nu)] == ptrs
    assert new_d.step == 1 and new_d.opt_state.count == 1
    for a, b in zip(tree_leaves(new_d.params) + tree_leaves(
            new_d.opt_state.mu) + tree_leaves(new_d.opt_state.nu),
            tree_leaves(new.params) + tree_leaves(new.opt_state.mu)
            + tree_leaves(new.opt_state.nu)):
        assert torch.equal(a, b)
    assert all(torch.equal(m[k], m_d[k]) for k in m)


def test_sharded_training_raises(tmp_path):
    """Sharded training is ported (ROADMAP item 25a): at one gloo rank on a
    (data=1, model=1) mesh, ``sharded_setup``'s step (its
    ``in_shardings`` the setup's own) and ``make_loss_fn(sharder=)`` give
    the unsharded step's metrics and parameters within 1e-6, and so does
    the megatron strategy's step.  What raises: ``in_shardings`` that are
    not the sharder's layouts or come without a sharder."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import Sharder, ShardingRules
    from repro_torch.train import init_sharded_state, sharded_setup
    tcfg, params, batch = _port_model("internvl2-1b")
    shape = dataclasses.replace(configs.get_shape("train_4k"),
                                global_batch=2, seq_len=SEQ)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(model=1, data=1)
        setup = sharded_setup(tcfg, shape, mesh, ShardingRules(), lr=1e-3)
        state = init_sharded_state(params, tcfg, setup["optimizer"],
                                   setup["sharder"])
        state, got = setup["train_step"](state, batch)
        opt = optim.adamw(1e-3)
        want_state, want = make_train_step(tcfg, opt, donate=False)(
            init_train_state(params, opt), batch)
        for key in want:
            assert abs(got[key].item() - want[key].item()) <= 1e-6 * max(
                1.0, abs(want[key].item())), key
        for a, b in zip(tree_leaves(state.params),
                        tree_leaves(want_state.params)):
            assert (a - b).abs().max().item() <= 1e-6 * (
                1 + b.abs().max().item())
        total, (loss, _) = make_loss_fn(tcfg, setup["sharder"])(
            state.params, batch)
        assert torch.isfinite(total) and loss.item() > 0
        with pytest.raises(ValueError, match="layouts"):
            make_train_step(tcfg, opt, setup["sharder"],
                            in_shardings=(setup["state_shardings"], {}))
        with pytest.raises(ValueError, match="pass its sharder"):
            make_train_step(tcfg, opt, in_shardings=(
                setup["state_shardings"], setup["batch_shardings"]))
        megatron = sharded_setup(tcfg, shape, mesh,
                                 ShardingRules("megatron"), lr=1e-3)
        assert isinstance(megatron["sharder"], Sharder)
        state, got = megatron["train_step"](init_sharded_state(
            params, tcfg, megatron["optimizer"], megatron["sharder"]),
            batch)
        for key in want:
            assert abs(got[key].item() - want[key].item()) <= 1e-6 * max(
                1.0, abs(want[key].item())), key
        for a, b in zip(tree_leaves(state.params),
                        tree_leaves(want_state.params)):
            assert (a - b).abs().max().item() <= 1e-6 * (
                1 + b.abs().max().item())
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,over,ref_error", [
    ("internlm2-1.8b", dict(attn_impl="flash"), AssertionError),
    ("mamba2-1.3b", dict(ssm_impl="fused"), ValueError),
])
def test_forward_only_kernels_refuse_training(arch, over, ref_error):
    """The port refuses a training step on a config whose forward calls a
    forward-only kernel, when the step is made; the reference's own step
    fails on the same config when it is traced."""
    cfg, params, (batch,) = _ref_model(arch)
    jstep = jloop.make_train_step(dataclasses.replace(cfg, **over),
                                  joptim.adamw(1e-3), donate=False)
    with pytest.raises(ref_error):
        jstep(j_init_train_state(params, joptim.adamw(1e-3)), batch)
    tcfg = dataclasses.replace(configs.get_config(arch + "-reduced"), **over)
    key = next(iter(over))
    for make in (lambda: make_train_step(tcfg, optim.adamw(1e-3)),
                 lambda: make_loss_fn(tcfg)):
        with pytest.raises(RuntimeError, match=f"{key}=.*no backward"):
            make()
    # the other impl alone is not on this config's path: it trains
    other = dict(attn_impl="flash") if key == "ssm_impl" else \
        dict(ssm_impl="fused")
    make_train_step(dataclasses.replace(configs.get_config(
        arch + "-reduced"), **other), optim.adamw(1e-3))


