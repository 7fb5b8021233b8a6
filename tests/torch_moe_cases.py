"""The port's MoE layer (``repro_torch/nn/moe.py``) against the JAX
package's ``repro/nn/moe.py``, fp32 on the CPU, on the reference's weights
and the same numpy inputs: outputs and the Switch aux loss at
|Δ| ≤ 1e-5·(1 + max|ref|) across capacity factors (from dropping most
assignments to none), ``dropless``, shared experts and the gelu
activation; the drop count; and the grouping of DeepSeek's
``first_dense_layers`` ahead of the repeated MoE unit.

The tests are spread over ``tests/test_torch_moe_*.py``
(``tests/torch_split.py``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import blocks as JB
from repro.nn import moe as JM
from repro_torch.configs import get_config
from repro_torch.models import blocks as TB
from repro_torch.nn import layers as TL
from repro_torch.nn import moe as TM
from repro_torch.params import from_numpy_tree
from torch_lm_configs_cases import one_torch_thread  # noqa: F401

TOL = 1e-5


def _held(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= TOL * (1 + np.abs(want).max()), err


def _setup(arch, seed=0, **over):
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), **over)
    tcfg = dataclasses.replace(get_config(arch + "-reduced"), **over)
    p = jax.tree.map(lambda l: np.asarray(l.value),
                     JM.init_moe(jax.random.PRNGKey(seed), jcfg),
                     is_leaf=lambda x: hasattr(x, "names"))
    x = np.random.default_rng(seed).standard_normal(
        (2, 24, jcfg.d_model), np.float32)
    return jcfg, tcfg, p, x


def _both(arch, seed=0, over=None, **kw):
    """``moe_apply`` on both sides; ``kw`` goes to both (``dropless``)."""
    jcfg, tcfg, p, x = _setup(arch, seed, **(over or {}))
    y_j, aux_j = jax.jit(lambda p, x: JM.moe_apply(p, jcfg, x, **kw))(p, x)
    y_t, aux_t = TM.moe_apply(from_numpy_tree(p, "cpu"), tcfg,
                              torch.from_numpy(x), **kw)
    _held(y_t, y_j)
    assert abs(aux_t.item() - float(aux_j)) <= TOL * abs(float(aux_j))
    return tcfg, p, x


@pytest.mark.parametrize("cf", [0.25, 0.5, 1.0, 1.25, 2.0])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b"])
def test_moe_apply_across_capacity(arch, cf):
    """granite: 4 experts top-2, no shared expert; deepseek: 4 experts
    top-2 plus 1 shared expert (reduced); the capacity factor from the
    config, as in both packages' blocks."""
    tcfg, p, x = _both(arch, over={"moe_capacity_factor": cf})
    if cf <= 0.5:
        # the case drops assignments, so the hold above covers which ones
        xf = torch.from_numpy(x).reshape(-1, tcfg.d_model)
        top_e = TM.route(from_numpy_tree(p, "cpu"), tcfg, xf)[2]
        per_expert = torch.bincount(top_e.reshape(-1),
                                    minlength=tcfg.num_experts)
        assert (per_expert > TM.capacity(tcfg, xf.shape[0])).any()


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b"])
def test_moe_dropless(arch):
    _both(arch, seed=1, dropless=True)


def test_moe_dropless_is_per_token():
    """Dropless: each token's output is the same alone as in the batch (the
    decode path's property)."""
    _, tcfg, p, x = _setup("deepseek-v2-lite-16b", 2)
    tp = from_numpy_tree(p, "cpu")
    y, _ = TM.moe_apply(tp, tcfg, torch.from_numpy(x), dropless=True)
    for i in (0, 7, 23):
        y1, _ = TM.moe_apply(tp, tcfg, torch.from_numpy(x[1:2, i:i + 1]),
                             dropless=True)
        torch.testing.assert_close(y1[0, 0], y[1, i], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_moe_activation(act):
    _both("deepseek-v2-lite-16b", seed=3, over={"act": act})


def test_moe_wider_routing():
    """8 experts, top-3, 2 shared experts."""
    _both("deepseek-v2-lite-16b", seed=4,
          over={"num_experts": 8, "num_experts_per_tok": 3,
                "num_shared_experts": 2})


def test_shared_experts_are_added():
    """The shared experts' MLP is the whole difference between a config with
    and one without them, on the same routed experts."""
    _, tcfg, p, x = _setup("deepseek-v2-lite-16b", 5)
    tp = from_numpy_tree(p, "cpu")
    y, _ = TM.moe_apply(tp, tcfg, torch.from_numpy(x))
    routed = {k: v for k, v in tp.items() if k != "shared"}
    y0, _ = TM.moe_apply(routed, tcfg, torch.from_numpy(x))
    torch.testing.assert_close(
        y - y0, TL.mlp(tp["shared"], torch.from_numpy(x), tcfg.act),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t,k,e,cf", [(4096, 6, 64, 1.25), (1, 2, 4, 1.25),
                                      (48, 2, 4, 0.5), (7, 8, 32, 1.0),
                                      (100, 2, 64, 0.25)])
def test_capacity(t, k, e, cf):
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              num_experts=e, num_experts_per_tok=k,
                              moe_capacity_factor=cf)
    assert TM.capacity(cfg, t) == int(max(1, -(-t * k // e) * cf))
    assert TM.capacity(cfg, t, dropless=True) == t


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b",
                                  "deepseek-v2-lite-16b-reduced",
                                  "granite-moe-1b-a400m",
                                  "granite-moe-1b-a400m-reduced"])
def test_first_dense_layers_grouping(name):
    got = [(g.unit, g.repeats) for g in TB.layer_groups(get_config(name))]
    want = [(g.unit, g.repeats)
            for g in JB.layer_groups(j_get_config(name))]
    assert got == want
    if name == "deepseek-v2-lite-16b":
        assert got == [(("dense",), 1), (("moe",), 26)]


def test_moe_block_aux_and_output():
    """One ``moe`` block (norms, MLA, MoE) against the reference's
    ``apply_block``: output and aux loss."""
    jcfg = j_get_config("deepseek-v2-lite-16b").reduced()
    tcfg = get_config("deepseek-v2-lite-16b-reduced")
    p = jax.tree.map(lambda l: np.asarray(l.value),
                     JB.init_block(jax.random.PRNGKey(6), jcfg, "moe"),
                     is_leaf=lambda x: hasattr(x, "names"))
    x = np.random.default_rng(6).standard_normal((2, 20, jcfg.d_model),
                                                 np.float32)
    pos = np.broadcast_to(np.arange(20)[None], (2, 20))
    y_j, aux_j = jax.jit(lambda p, x: JB.apply_block(p, jcfg, "moe", x,
                                                     pos))(p, x)
    y_t, aux_t = TB.apply_block(from_numpy_tree(p, "cpu"), tcfg, "moe",
                                torch.from_numpy(x),
                                torch.from_numpy(pos.copy()))
    _held(y_t, y_j)
    assert abs(aux_t.item() - float(aux_j)) <= TOL * abs(float(aux_j))
