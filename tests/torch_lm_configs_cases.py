"""The seven LM configs this port added, each at ``reduced()`` (2 layers,
d=256, fp32), against the JAX package on the reference's weights: config
fields (full and reduced); the bf16 init tree (key paths, shapes, dtypes:
norms, the MoE router and mamba2's decay rates stay fp32); ``forward``
logits and MoE aux loss; ``lm_loss``; prefill logits and caches (dense,
MLA's compressed, SSM); greedy ``generate`` tokens identical to
``repro.serve.engine.generate`` on the naive + jnp impls and on the
kernels' impls (the plain versions on the CPU).  gemma2's ring cache is
held in ``test_torch_lm_ring_cache.py``.  Logits are held to
|Δ| ≤ 1e-5·max(1, max|ref|) (tied logits reach ~300, where an fp32 ulp is
3e-5), losses and aux to 1e-5 relative.

The configs are spread over ``tests/test_torch_lm_configs_*.py``
(``tests/torch_split.py``), each config the reference jits in one file."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.models import transformer as JT
from repro.serve import engine as j_engine
from repro_torch.configs import get_config, list_archs
from repro_torch.models import transformer as TT
from repro_torch.params import (from_numpy_tree, to_numpy_tree, tree_leaves,
                                tree_map)
from repro_torch.serve import generate

ARCHS = ["gemma2-9b", "deepseek-v2-lite-16b", "granite-moe-1b-a400m",
         "mamba2-1.3b", "minitron-8b", "internlm2-1.8b", "qwen1.5-4b"]
KERNEL_IMPLS = dict(attn_impl="flash", ssm_impl="fused")
PROMPT, STEPS = 24, 6
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's torch ops: beside other test
    workers on a busy machine, torch's thread pool waits for cores it
    cannot get (an ``index_add_`` of a few rows then takes 0.2 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _held(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), err


def _rel(a, b):
    assert abs(a - b) <= TOL * max(abs(b), 1e-3), (a, b)


def _np_values(tree):
    return jax.tree.map(lambda l: np.asarray(l.value), tree,
                        is_leaf=lambda x: hasattr(x, "names"))


def _flat_caches(caches):
    """Every cache's fields in order, as the reference's pytree leaves
    (a ring cache's ``window`` is static there)."""
    return [getattr(c, f.name) for unit in caches for c in unit
            for f in dataclasses.fields(c) if f.name != "window"]


def _held_caches(got, want):
    flat_t, flat_j = _flat_caches(got), jax.tree.leaves(want)
    assert len(flat_t) == len(flat_j)
    for t, j in zip(flat_t, flat_j):
        if isinstance(t, int):
            assert np.all(np.asarray(j) == t)
        else:
            _held(t, j)


@pytest.mark.parametrize("name", ARCHS + [a + "-reduced" for a in ARCHS])
def test_config_fields_equal_reference(name):
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
        j_get_config(name))


def test_registry_and_unported_configs():
    """Every config of the reference is registered: these seven, Zamba2
    and the two modality configs."""
    assert list_archs() == j_list_archs()
    assert set(ARCHS) | {"zamba2-2.7b", "internvl2-1b",
                         "musicgen-large"} == set(list_archs())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_dtype_tree_bf16_matches_reference(arch):
    """``init_transformer(dtype=torch.bfloat16)``: the reference's tree and
    each leaf's dtype."""
    jcfg = j_get_config(arch).reduced()
    want = jax.eval_shape(lambda: JT.init_transformer(
        jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16))
    want = jax.tree.map(lambda l: (l.value.shape, str(l.value.dtype)), want,
                        is_leaf=lambda x: hasattr(x, "names"))
    tp = TT.init_transformer(get_config(arch + "-reduced"), seed=0,
                             device="cpu", dtype=torch.bfloat16)
    got = tree_map(lambda t: (tuple(t.shape),
                              str(t.dtype).removeprefix("torch.")), tp)
    assert got == want
    assert {t.dtype for t in tree_leaves(tp)} == {torch.bfloat16,
                                                  torch.float32}


def ref_fixture(archs):
    """The module fixture ``ref`` over ``archs`` (:func:`reference` of
    each), for the test file that runs those configs."""
    @pytest.fixture(scope="module", params=list(archs))
    def ref(request):
        return reference(request.param)
    return ref


def reference(arch):
    """The reference on naive + jnp: weights, a batch, forward logits, aux
    and loss, prefill logits and caches, greedy generation."""
    cfg = j_get_config(arch).reduced()
    params = _np_values(jax.jit(lambda k: JT.init_transformer(k, cfg))(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(len(arch))
    tokens = rng.integers(0, cfg.vocab_size, (2, PROMPT + 1)).astype(
        np.int32)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]

    def score(p, t, y):
        logits, aux = JT.forward(p, cfg, t)
        return logits, aux, JT.lm_loss(logits, y)
    logits, aux, loss = jax.jit(score)(params, inputs, targets)
    pre = jax.jit(lambda p, t: JT.prefill(p, cfg, t,
                                          max_len=PROMPT + STEPS))(
        params, inputs)
    gen = j_engine.generate(params, cfg, inputs, STEPS)
    return dict(arch=arch, params=params, inputs=inputs, targets=targets,
                logits=logits, aux=float(aux), loss=float(loss),
                prefill=pre, gen=gen)


def test_weight_bridge_round_trip(ref):
    """The reference's leaves (MLA's, MoE's, the SSM's) cross to tensors and
    back byte for byte, in the reference's tree."""
    jl, treedef = jax.tree.flatten(ref["params"])
    back = to_numpy_tree(from_numpy_tree(ref["params"], "cpu"))
    assert jax.tree.structure(back) == treedef
    for a, b in zip(jl, jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _tcfg(arch, kernels: bool):
    cfg = get_config(arch + "-reduced")
    return dataclasses.replace(cfg, **KERNEL_IMPLS) if kernels else cfg


@pytest.mark.parametrize("kernels", [False, True], ids=["naive", "kernels"])
def test_forward_aux_and_loss(ref, kernels):
    tcfg = _tcfg(ref["arch"], kernels)
    with torch.no_grad():
        logits, aux = TT.forward(from_numpy_tree(ref["params"], "cpu"), tcfg,
                                 torch.from_numpy(ref["inputs"]))
        loss = TT.lm_loss(logits, torch.from_numpy(ref["targets"]))
    _held(logits, ref["logits"])
    _rel(aux.item(), ref["aux"])
    assert (ref["aux"] > 0) == tcfg.moe
    _rel(loss.item(), ref["loss"])


def test_prefill_logits_and_caches(ref):
    tcfg = _tcfg(ref["arch"], False)
    with torch.no_grad():
        logits, caches = TT.prefill(from_numpy_tree(ref["params"], "cpu"),
                                    tcfg, torch.from_numpy(ref["inputs"]),
                                    max_len=PROMPT + STEPS)
    logits_j, caches_j = ref["prefill"]
    _held(logits, logits_j)
    _held_caches(caches, caches_j)


@pytest.mark.parametrize("kernels", [False, True], ids=["naive", "kernels"])
def test_generate_greedy(ref, kernels):
    got = generate(from_numpy_tree(ref["params"], "cpu"),
                   _tcfg(ref["arch"], kernels), ref["inputs"], STEPS,
                   device="cpu")
    np.testing.assert_array_equal(got.tokens, np.asarray(ref["gen"].tokens))
    _held(got.prefill_logits, ref["gen"].prefill_logits)
