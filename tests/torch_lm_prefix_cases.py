"""Modality prefixes and the last two configs (``internvl2-1b``,
``musicgen-large``) against the JAX package: the ten configs' fields,
``param_count`` / ``active_param_count`` and ``INPUT_SHAPES``; the init
tree with ``mm_proj`` (fp32 and bf16); on each modality config at
``reduced()`` (2 layers, d=256, 8 prefix embeddings, fp32) on the
reference's weights: ``assemble_inputs``, ``forward`` logits and
``lm_loss``, prefill logits and caches and greedy ``generate`` tokens with
a prefix, on naive and on the kernel impl (its plain version on the CPU);
``SyntheticLM.batches(cfg=)`` byte for byte, prefix included; and
``examples/serve_lm_torch.py --device cpu``.  Logits are held to
|Δ| ≤ 1e-5·max(1, max|ref|), losses to 1e-5 relative.

The tests are spread over ``tests/test_torch_lm_prefix_*.py``
(``tests/torch_split.py``)."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.synthetic_lm import SyntheticLM as JSyntheticLM
from repro.models import transformer as JT
from repro.serve import engine as j_engine
from repro_torch import configs
from repro_torch.data import SyntheticLM
from repro_torch.models import transformer as TT
from repro_torch.params import from_numpy_tree, tree_map
from repro_torch.serve import generate
from torch_lm_configs_cases import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ARCHS = jconfigs.list_archs()
MODALITY = ["internvl2-1b", "musicgen-large"]
PROMPT, STEPS = 16, 6
TOL = 1e-5


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


@pytest.mark.parametrize("name", ARCHS + [a + "-reduced" for a in ARCHS])
def test_config_fields_equal_reference(name):
    assert dataclasses.asdict(configs.get_config(name)) == \
        dataclasses.asdict(jconfigs.get_config(name))


def test_registry_equals_reference():
    assert configs.list_archs() == jconfigs.list_archs()
    assert len(configs.list_archs()) == 10


@pytest.mark.parametrize("name", ARCHS + [a + "-reduced" for a in ARCHS])
def test_param_counts_equal_reference(name):
    got, want = configs.get_config(name), jconfigs.get_config(name)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


def test_input_shapes_equal_reference():
    assert list(configs.INPUT_SHAPES) == list(jconfigs.INPUT_SHAPES)
    for name, shape in jconfigs.INPUT_SHAPES.items():
        got = configs.get_shape(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(shape)
        assert dataclasses.asdict(got.reduced()) == \
            dataclasses.asdict(shape.reduced())
        assert dataclasses.asdict(got.reduced(seq_len=32, batch=4)) == \
            dataclasses.asdict(shape.reduced(seq_len=32, batch=4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MODALITY)
def test_init_tree_with_mm_proj(arch, dtype):
    """``init_transformer``: the reference's tree (``mm_proj`` a dense
    (d, d) without bias, in ``dtype``), each leaf's shape and dtype."""
    jcfg = jconfigs.get_config(arch).reduced()
    want = jax.eval_shape(lambda: JT.init_transformer(
        jax.random.PRNGKey(0), jcfg, dtype=getattr(jnp, dtype)))
    want = jax.tree.map(lambda l: (l.value.shape, str(l.value.dtype)), want,
                        is_leaf=lambda x: hasattr(x, "names"))
    tp = TT.init_transformer(configs.get_config(arch + "-reduced"), seed=0,
                             device="cpu", dtype=getattr(torch, dtype))
    got = tree_map(lambda t: (tuple(t.shape),
                              str(t.dtype).removeprefix("torch.")), tp)
    assert got == want
    assert got["mm_proj"] == {"w": ((256, 256), dtype)}


@pytest.fixture(scope="module", params=MODALITY)
def ref(request):
    """The reference on naive: weights, a batch with its prefix,
    ``assemble_inputs``, forward logits and loss, prefill logits and
    caches, greedy generation behind the prefix."""
    arch = request.param
    cfg = jconfigs.get_config(arch).reduced()
    params = _np_values(jax.jit(lambda k: JT.init_transformer(k, cfg))(
        jax.random.PRNGKey(0)))
    batch = next(JSyntheticLM(cfg.vocab_size, seed=len(arch)).batches(
        2, PROMPT, cfg))
    inputs, targets, prefix = batch["tokens"], batch["targets"], \
        batch["prefix"]
    off = cfg.num_prefix_embeddings

    def score(p, t, pre, y):
        logits, aux = JT.forward(p, cfg, t, pre)
        return JT.assemble_inputs(p, cfg, t, pre), logits, aux, \
            JT.lm_loss(logits[:, off:], y)
    emb, logits, aux, loss = jax.jit(score)(params, inputs, prefix, targets)
    pre = jax.jit(lambda p, t, x: JT.prefill(
        p, cfg, t, x, max_len=PROMPT + STEPS + off))(params, inputs, prefix)
    gen = j_engine.generate(params, cfg, inputs, STEPS, prefix=prefix)
    return dict(arch=arch, params=params, inputs=inputs, targets=targets,
                prefix=prefix, emb=emb, logits=logits, aux=float(aux),
                loss=float(loss), prefill=pre, gen=gen)


def _tcfg(arch, kernels: bool):
    cfg = configs.get_config(arch + "-reduced")
    return dataclasses.replace(cfg, attn_impl="flash") if kernels else cfg


def test_assemble_inputs(ref):
    tcfg = _tcfg(ref["arch"], False)
    got = TT.assemble_inputs(from_numpy_tree(ref["params"], "cpu"), tcfg,
                             torch.from_numpy(ref["inputs"]),
                             torch.from_numpy(ref["prefix"]))
    assert got.shape == (2, tcfg.num_prefix_embeddings + PROMPT,
                         tcfg.d_model)
    _held(got, ref["emb"])


def test_missing_prefix_raises(ref):
    with pytest.raises(ValueError, match="needs frontend embeddings"):
        TT.forward(from_numpy_tree(ref["params"], "cpu"),
                   _tcfg(ref["arch"], False),
                   torch.from_numpy(ref["inputs"]))


@pytest.mark.parametrize("kernels", [False, True], ids=["naive", "kernels"])
def test_forward_and_loss(ref, kernels):
    tcfg = _tcfg(ref["arch"], kernels)
    off = tcfg.num_prefix_embeddings
    with torch.no_grad():
        logits, aux = TT.forward(from_numpy_tree(ref["params"], "cpu"), tcfg,
                                 torch.from_numpy(ref["inputs"]),
                                 torch.from_numpy(ref["prefix"]))
        loss = TT.lm_loss(logits[:, off:], torch.from_numpy(ref["targets"]))
    _held(logits, ref["logits"])
    assert aux.item() == ref["aux"] == 0.0
    _rel(loss.item(), ref["loss"])


def test_prefill_logits_and_caches(ref):
    """Prefill behind the prefix: the logits of every position and each
    layer's K/V cache (its length P + S)."""
    tcfg = _tcfg(ref["arch"], False)
    off = tcfg.num_prefix_embeddings
    with torch.no_grad():
        logits, caches = TT.prefill(
            from_numpy_tree(ref["params"], "cpu"), tcfg,
            torch.from_numpy(ref["inputs"]), torch.from_numpy(ref["prefix"]),
            max_len=PROMPT + STEPS + off)
    logits_j, caches_j = ref["prefill"]
    _held(logits, logits_j)
    flat_t = [getattr(c, f.name) for unit in caches for c in unit
              for f in dataclasses.fields(c)]
    flat_j = jax.tree.leaves(caches_j)
    assert len(flat_t) == len(flat_j)
    for t, j in zip(flat_t, flat_j):
        if isinstance(t, int):
            assert t == off + PROMPT and np.all(np.asarray(j) == t)
        else:
            _held(t, j)


@pytest.mark.parametrize("kernels", [False, True], ids=["naive", "kernels"])
def test_generate_greedy(ref, kernels):
    """The prompt and the new tokens (not the prefix), identical to the
    reference's."""
    got = generate(from_numpy_tree(ref["params"], "cpu"),
                   _tcfg(ref["arch"], kernels), ref["inputs"], STEPS,
                   prefix=ref["prefix"], device="cpu")
    assert got.tokens.shape == (2, PROMPT + STEPS)
    np.testing.assert_array_equal(got.tokens, np.asarray(ref["gen"].tokens))
    _held(got.prefill_logits, ref["gen"].prefill_logits)


@pytest.mark.parametrize("arch", MODALITY + ["internlm2-1.8b"])
def test_synthetic_batches_with_prefix(arch):
    """``batches(cfg=)`` byte for byte over three batches: tokens, targets
    and, for a modality config, the prefix drawn after them."""
    cfg = configs.get_config(arch + "-reduced")
    got = SyntheticLM(cfg.vocab_size, seed=3).batches(2, 40, cfg)
    want = JSyntheticLM(cfg.vocab_size, seed=3).batches(
        2, 40, jconfigs.get_config(arch + "-reduced"))
    for _ in range(3):
        g, w = next(got), next(want)
        assert sorted(g) == sorted(w) == sorted(
            ["tokens", "targets"] + (["prefix"] if cfg.modality else []))
        for key in w:
            assert g[key].dtype == w[key].dtype
            assert g[key].tobytes() == w[key].tobytes()


def test_serve_example_runs_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "serve_lm_torch.py"),
         "--arch", "internvl2-1b-reduced", "--device", "cpu", "--batch", "2",
         "--prompt-len", "8", "--gen", "4"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "generated 8 tokens" in out.stdout
    assert "family=vlm on cpu" in out.stdout
