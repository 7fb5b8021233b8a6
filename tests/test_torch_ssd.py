"""The port's SSD (the intra-chunk kernel's plain version, the full
``ssd_chunked_fused``, the plain-torch ``ssd_chunked``, the dense oracle
and the mamba2 block, fused and jnp) against the JAX package's Pallas
kernel in interpret mode and its jnp paths, on the same numpy inputs, at
atol/rtol 2e-4 as ``test_kernel_ssd.py`` (fp32; prefix sums and exps in
another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.ssd import ssd_chunked_pallas, ssd_dense_ref as j_dense
from repro.kernels.ssd.ssd import ssd_intra_chunk as j_intra
from repro.nn import ssm as j_ssm
from repro_torch.configs import get_config
from repro_torch.kernels import ssd as tssd
from repro_torch.nn import ssm as t_ssm
from repro_torch.params import from_numpy_tree

TOL = 2e-4


def _mk(b, s, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    b_mat = (rng.standard_normal((b, s, n)) / np.sqrt(n)).astype(np.float32)
    c_mat = (rng.standard_normal((b, s, n)) / np.sqrt(n)).astype(np.float32)
    return x, dt, a, b_mat, c_mat


def _j(args):
    return [jnp.asarray(a) for a in args]


def _t(args):
    return [torch.from_numpy(a) for a in args]


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s,chunk,h,p,n", [(32, 8, 3, 8, 16),
                                           (64, 16, 2, 32, 32),
                                           (64, 64, 1, 16, 8)])
def test_intra_chunk_plain_version_matches_pallas(s, chunk, h, p, n):
    args = _mk(2, s, h, p, n, seed=s + chunk)
    y_j, st_j = j_intra(*_j(args), chunk=chunk, interpret=True)
    y_t, st_t = tssd.ssd_intra_chunk_ref(*_t(args), chunk=chunk)
    _close(y_t, y_j)
    _close(st_t, st_j)


@pytest.mark.parametrize("s,chunk", [(32, 8), (40, 16), (64, 64), (17, 8)])
def test_fused_matches_pallas_and_dense_oracle(s, chunk):
    args = _mk(2, s, 3, 8, 16, seed=s)
    before = tssd.ssd_intra_chunk.launches
    y_t, st_t = tssd.ssd_chunked_fused(*_t(args), chunk)
    assert tssd.ssd_intra_chunk.launches == before
    y_j, st_j = ssd_chunked_pallas(*_j(args), chunk, interpret=True)
    _close(y_t, y_j)
    _close(st_t, st_j)
    _close(tssd.ssd_dense_ref(*_t(args)), j_dense(*_j(args)))
    _close(y_t, j_dense(*_j(args)))


@pytest.mark.parametrize("h,p,n,s", [(1, 4, 8, 48), (4, 16, 32, 48),
                                     (2, 8, 8, 41)])
def test_plain_chunked_matches_jnp(h, p, n, s):
    args = _mk(1, s, h, p, n, seed=3)
    y_t, st_t = t_ssm.ssd_chunked(*_t(args), 16)
    y_j, st_j = jax.jit(j_ssm.ssd_chunked, static_argnums=5)(*_j(args), 16)
    _close(y_t, y_j)
    _close(st_t, st_j)
    y_f, st_f = tssd.ssd_chunked_fused(*_t(args), 16)
    _close(y_f, y_j)
    _close(st_f, st_j)


@pytest.fixture(scope="module")
def mamba():
    cfg = j_get_config("zamba2-2.7b").reduced()
    leafs = j_ssm.init_mamba2(jax.random.PRNGKey(0), cfg)
    p = jax.tree.map(lambda l: np.asarray(l.value), leafs,
                     is_leaf=lambda x: hasattr(x, "names"))
    x = (0.3 * np.random.default_rng(1).standard_normal(
        (2, 24, cfg.d_model))).astype(np.float32)
    return cfg, p, x


@pytest.mark.parametrize("impl", ["fused", "jnp"])
def test_mamba2_forward(mamba, impl):
    cfg, p, x = mamba
    jcfg = dataclasses.replace(cfg, ssm_impl=impl)
    want = jax.jit(lambda p, x: j_ssm.mamba2_forward(p, jcfg, x))(p, x)
    tcfg = dataclasses.replace(get_config("zamba2-2.7b-reduced"),
                               ssm_impl=impl)
    got = t_ssm.mamba2_forward(from_numpy_tree(p, "cpu"), tcfg,
                               torch.from_numpy(x))
    _close(got, want)


def test_mamba2_prefill_then_decode(mamba):
    cfg, p, x = mamba
    tcfg = get_config("zamba2-2.7b-reduced")
    tp = from_numpy_tree(p, "cpu")
    y_j, c_j = jax.jit(lambda p, x: j_ssm.mamba2_prefill(p, cfg, x))(
        p, x[:, :20])
    decode = jax.jit(lambda p, x, c: j_ssm.mamba2_decode(p, cfg, x, c))
    y_t, c_t = t_ssm.mamba2_prefill(tp, tcfg, torch.from_numpy(x[:, :20]))
    _close(y_t, y_j)
    _close(c_t.conv_state, c_j.conv_state)
    _close(c_t.ssm_state, c_j.ssm_state)
    assert c_t.length == int(c_j.length) == 20
    for i in range(20, 24):
        y_j, c_j = decode(p, x[:, i:i + 1], c_j)
        y_t, c_t = t_ssm.mamba2_decode(tp, tcfg,
                                       torch.from_numpy(x[:, i:i + 1]), c_t)
        _close(y_t, y_j)
        _close(c_t.ssm_state, c_j.ssm_state)
    assert c_t.length == int(c_j.length) == 24


def test_kernel_wrapper_takes_cuda_tensors_only():
    args = _t(_mk(1, 16, 2, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_intra_chunk(*args, chunk=8)
