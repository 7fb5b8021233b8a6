"""LM training's loss and gradient against the JAX package:
``make_loss_fn``'s total, loss, aux and every gradient leaf against
``jax.value_and_grad`` of the reference's ``make_loss_fn`` for each of the
ten configs at ``reduced()`` (fp32, 2 × 16 tokens from ``SyntheticLM``,
behind the prefix where the config has one) — dense, moe, local/global
with both softcaps (the regression test of the in-place softcap that broke
autograd), MLA, mamba2, zamba2's shared block and the two prefixed configs
— at 1e-5·(1 + max|ref|); and the grad-mode guard in both kernel wrappers
(neither kernel has a backward, in either package).  The step itself is
in ``test_torch_lm_train_step.py``."""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.synthetic_lm import SyntheticLM as JSyntheticLM
from repro.train import loop as jloop
from repro_torch import configs
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.ssd import ssd_chunked_fused
from repro_torch.models import transformer as TT
from repro_torch.params import (from_numpy_tree, to_numpy_tree, tree_leaves,
                                tree_unflatten)
from repro_torch.train import make_loss_fn
from torch_lm_configs_cases import one_torch_thread  # noqa: F401

ARCHS = jconfigs.list_archs()
SEQ = 16
TOL = 1e-5


def _ref_model(arch: str, seed: int = 0):
    """``arch`` reduced: the reference's config, weights drawn by the port
    (as numpy), a batch."""
    cfg = jconfigs.get_config(arch).reduced()
    params = to_numpy_tree(TT.init_transformer(
        configs.get_config(arch + "-reduced"), seed=0, device="cpu"))
    batch = next(JSyntheticLM(cfg.vocab_size, seed=seed).batches(2, SEQ,
                                                                  cfg))
    return cfg, params, batch


def _grads(cfg, params, batch, remat=True):
    """(total, loss, aux, gradient leaves) of the port's loss on tensors
    made from ``params``."""
    live = [t.requires_grad_() for t in
            tree_leaves(from_numpy_tree(params, "cpu"))]
    loss_fn = make_loss_fn(cfg, remat=remat)
    total, (loss, aux) = loss_fn(tree_unflatten(params, live), batch)
    grads = torch.autograd.grad(total, live, allow_unused=True,
                                materialize_grads=True)
    return total.item(), loss.item(), aux.item(), grads


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    cfg, params, batch = _ref_model(arch)
    (total_j, (loss_j, aux_j)), grads_j = jax.jit(jax.value_and_grad(
        jloop.make_loss_fn(cfg, None), has_aux=True))(params, batch)
    total, loss, aux, grads = _grads(configs.get_config(arch + "-reduced"),
                                     params, batch)
    for got, want in ((total, total_j), (loss, loss_j), (aux, aux_j)):
        want = float(want)
        assert abs(got - want) <= TOL * (1 + abs(want)), (got, want)
    assert (aux > 0) == cfg.moe
    leaves_j = jax.tree.leaves(grads_j)
    assert len(grads) == len(leaves_j)
    for g, gj in zip(grads, leaves_j):
        gj = np.asarray(gj)
        assert g.shape == gj.shape
        err = np.abs(g.numpy() - gj).max()
        assert err <= TOL * (1 + np.abs(gj).max()), err


def _flash_args(requires_grad):
    gen = torch.Generator().manual_seed(0)
    return [torch.randn(1, 8, h, 16, generator=gen).requires_grad_(
        requires_grad) for h in (4, 2, 2)]


def _ssd_args(requires_grad):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 32, 2, 8, generator=gen)
    dt = torch.rand(1, 32, 2, generator=gen)
    a = -torch.rand(2, generator=gen)
    b = torch.randn(1, 32, 4, generator=gen)
    c = torch.randn(1, 32, 4, generator=gen)
    return [x.requires_grad_(requires_grad), dt, a, b, c]


@pytest.mark.parametrize("name", ["flash_attention", "ssd_chunked_fused"])
def test_kernel_wrappers_refuse_grad(name):
    """A grad-enabled call with an input that requires grad raises (the
    kernel has no backward in either package); under ``no_grad``, or with
    no input requiring grad, the wrapper runs and gives the same values."""
    if name == "flash_attention":
        def call(args):
            return flash_attention(*args)
        make = _flash_args
    else:
        def call(args):
            return ssd_chunked_fused(*args, chunk=16)[0]
        make = _ssd_args
    with pytest.raises(RuntimeError, match="no backward"):
        call(make(True))
    with torch.no_grad():
        want = call(make(True))
    got = call(make(False))
    assert not got.requires_grad and torch.equal(got, want)
