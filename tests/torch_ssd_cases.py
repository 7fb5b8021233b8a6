"""The port's SSD (the intra-chunk kernel's plain version, the full
``ssd_chunked_fused``, the plain-torch ``ssd_chunked``, the dense oracle
and the mamba2 block, fused and jnp) against the JAX package's Pallas
kernel in interpret mode and its jnp paths, on the same numpy inputs, at
atol/rtol 2e-4 as ``test_kernel_ssd.py`` (fp32; prefix sums and exps in
another order).

The tests are spread over ``tests/test_torch_ssd_*.py``
(``tests/torch_split.py``).
"""
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
from torch_tf32 import one_pass as _one_pass
from torch_tf32 import tf32 as _tf32
from torch_tf32 import three_pass as _three_pass

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


def _intra_chunk_with(mm, x, dt, a, b_mat, c_mat, chunk):
    """``ref.ssd_intra_chunk_ref`` with its three products (the scores, M·x
    and the states) through ``mm``."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    q = chunk
    nc = s // q
    xh = x.float().reshape(bsz, nc, q, h, p).permute(0, 1, 3, 2, 4)
    dth = dt.float().reshape(bsz, nc, q, h).permute(0, 1, 3, 2)
    bc = b_mat.float().reshape(bsz, nc, 1, q, n)
    cc = c_mat.float().reshape(bsz, nc, 1, q, n)
    da = dth * a.float()[:, None]
    cs = torch.cumsum(da, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    l_mat = torch.where(causal, torch.exp(seg), 0.0)
    scores = mm(cc, bc.transpose(-1, -2))
    m = scores * l_mat * dth[..., None, :]
    y = mm(m, xh).permute(0, 1, 3, 2, 4).reshape(bsz, s, h, p)
    w = torch.exp(cs[..., -1:] - cs) * dth
    st = mm(xh.transpose(-1, -2), bc * w[..., None])
    return y, st


@pytest.mark.parametrize("q", [64, 256])
def test_tf32_three_pass_split_keeps_the_kernel_hold(q):
    """Why the CUDA kernel runs its products as three TF32 passes: with
    TF32 rounding emulated on the plain version's products, one pass misses
    the hold ``chip_smoke.py`` puts on the kernel (max|Δ| ≤ 1e-4·(1 +
    max|ref|), on y_intra and on the states), and the hi/lo split meets it
    with at least 10× to spare."""
    args = _t(_mk(2, 2 * q, 4, 64, 64, seed=q))
    want = tssd.ssd_intra_chunk_ref(*args, chunk=q)
    exact = _intra_chunk_with(torch.matmul, *args, q)
    assert all(torch.equal(g, w) for g, w in zip(exact, want))

    def worst(mm):
        """max over (y_intra, states) of max|Δ| / (1e-4·(1 + max|ref|))"""
        got = _intra_chunk_with(mm, *args, q)
        return max(((g - w).abs().max() / (1e-4 * (1 + w.abs().max())))
                   .item() for g, w in zip(got, want))

    assert worst(_one_pass) > 1.0
    assert worst(_three_pass) <= 0.1


@pytest.mark.parametrize("where", ["x", "dt"])
def test_tf32_three_pass_split_keeps_nan(where):
    """A NaN in x or dt reaches y_intra and the states through the hi/lo
    split exactly where it reaches them in the plain version, for a NaN
    with the card's canonical bits 0x7fffffff (which the add-and-mask
    rounding alone turns into -0)."""
    x, dt, a, b_mat, c_mat = _t(_mk(1, 128, 3, 16, 16, seed=7))
    nan = torch.tensor([0x7fffffff], dtype=torch.int32).view(torch.float32)
    assert ((nan.view(torch.int32) + 0x1000) & -0x2000).item() \
        == -0x80000000
    assert _tf32(nan).isnan().all()
    if where == "x":
        x[0, 70, 1, 5] = nan[0]
    else:
        dt[0, 70, 1] = nan[0]
    args = (x, dt, a, b_mat, c_mat)
    want = tssd.ssd_intra_chunk_ref(*args, chunk=64)
    got = _intra_chunk_with(_three_pass, *args, 64)
    for g, w in zip(got, want):
        assert w.isnan().any()
        assert torch.equal(g.isnan(), w.isnan())
        fin = ~w.isnan()
        assert (g[fin] - w[fin]).abs().max() <= 1e-4 * (1 + w[fin].abs().max())
