"""The SpMM's one-shot entry points (``block_sparse_dev``,
``square_plan_dev``, ``aggregate_pallas``, ``spmm_dense_ref``) against the
JAX package's, whose Pallas kernel runs in interpret mode, on the same
numpy inputs, at the reference tests' own tolerances
(``tests/test_kernel_spmm.py``); and the flash and SSD kernels'
``hbm_bytes_model`` against the reference's where the two schedules move
the same bytes, and against counts written out from the kernels'
constants."""
import inspect
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import block_sparse as jblock_sparse
from repro.graph import build_graph as jbuild_graph
from repro.kernels import flash_attn as jflash
from repro.kernels import spmm as jspmm
from repro.kernels import ssd as jssd
from repro_torch.graph import format as tformat
from repro_torch.kernels import flash_attn as tflash
from repro_torch.kernels import spmm as tspmm
from repro_torch.kernels import ssd as tssd
from repro_torch.kernels.flash_attn import flash as tflash_mod
from repro_torch.kernels.ssd import ssd as tssd_mod

CSRC = Path(tssd_mod.__file__).resolve().parents[1]


def _constant(source: str, name: str) -> int:
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def graphs(n, avg_deg, seed, self_loops=True):
    """The same random graph in both packages (``test_kernel_spmm.py``'s
    ``random_graph``)."""
    rng = np.random.default_rng(seed)
    e = n * avg_deg
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    return (jbuild_graph(src, dst, n, add_self_loops=self_loops),
            tformat.build_graph(src, dst, n, add_self_loops=self_loops))


def both(jg, tg, bs, dtype=None):
    """The reference's and the port's ``block_sparse_dev`` of one graph
    (the port's on the CPU), the tiles rounded through ``dtype``."""
    jkw = {} if dtype is None else {"dtype": jnp.bfloat16}
    tkw = {} if dtype is None else {"dtype": torch.bfloat16}
    return (jspmm.block_sparse_dev(jblock_sparse(jg, bs=bs), **jkw),
            tspmm.block_sparse_dev(tformat.block_sparse(tg, bs=bs),
                                   device="cpu", **tkw))


def features(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("bs,d", [(32, 8), (64, 32), (128, 128)])
def test_spmm_shape_sweep(bs, d):
    jg, tg = graphs(300, 5, seed=bs + d)
    jdev, tdev = both(jg, tg, bs)
    h = features(jg.n, d, 0)
    want = jspmm.aggregate_pallas(jdev, jnp.asarray(h), d_tile=min(d, 128),
                                  interpret=True)
    got = tspmm.aggregate_pallas(tdev, torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    dense = tspmm.spmm_dense_ref(torch.from_numpy(tg.dense_adjacency()),
                                 torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmm_dtype_sweep(dtype):
    """fp32 and bf16 h through fp32 tiles: the output keeps h's dtype
    (bf16 at the reference test's atol 0.15: the TPU kernel rounds after
    each tile, the port once)."""
    jg, tg = graphs(256, 6, seed=7)
    jdev, tdev = both(jg, tg, 64)
    h = np.array(jax.random.normal(jax.random.PRNGKey(0), (jg.n, 64)))
    jh = jnp.asarray(h).astype(getattr(jnp, dtype))
    th = torch.from_numpy(h).to(getattr(torch, dtype))
    want = jspmm.aggregate_pallas(jdev, jh, d_tile=64, interpret=True)
    got = tspmm.aggregate_pallas(tdev, th)
    assert got.dtype == getattr(torch, dtype)
    assert want.dtype == jh.dtype
    atol = 1e-4 if dtype == "float32" else 0.15
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=atol)


def test_bf16_rounded_tiles():
    """Tiles rounded through bf16 and held as fp32 compute what the
    reference's bf16 tiles compute."""
    jg, tg = graphs(240, 5, seed=21)
    jdev, tdev = both(jg, tg, 64, dtype="bfloat16")
    assert jdev.blocks.dtype == jnp.bfloat16 and tdev.vals.dtype == \
        torch.float32
    h = features(jg.n, 24, 5)
    want = jspmm.aggregate_pallas(jdev, jnp.asarray(h), d_tile=24,
                                  interpret=True)
    got = tspmm.aggregate_pallas(tdev, torch.from_numpy(h))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_spmm_non_divisible_dims_padded():
    jg, tg = graphs(197, 4, seed=3)           # n not divisible by bs
    jdev, tdev = both(jg, tg, 64)
    h = features(jg.n, 52, 1)                 # d not divisible by a tile
    want = jspmm.aggregate_pallas(jdev, jnp.asarray(h), d_tile=32,
                                  interpret=True)
    got = tspmm.aggregate_pallas(tdev, torch.from_numpy(h))
    assert got.shape == (197, 52) and tdev.n_padded == 256
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_spmm_empty_rows_no_self_loops():
    """Vertices with no in-edges give zero rows."""
    n = 160
    src = np.array([1, 2, 3], np.int32)
    dst = np.array([0, 0, 1], np.int32)
    kw = dict(add_self_loops=False, normalization="none")
    jdev = jspmm.block_sparse_dev(
        jblock_sparse(jbuild_graph(src, dst, n, **kw), bs=32))
    tdev = tspmm.block_sparse_dev(
        tformat.block_sparse(tformat.build_graph(src, dst, n, **kw), bs=32),
        device="cpu")
    h = features(n, 32, 2)
    want = np.asarray(jspmm.aggregate_pallas(jdev, jnp.asarray(h), d_tile=32,
                                             interpret=True))
    got = tspmm.aggregate_pallas(tdev, torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got[0], h[1] + h[2], atol=1e-5)
    np.testing.assert_allclose(got[1], h[3], atol=1e-5)
    assert not got[2:].any()


def test_square_plan_value_and_grad():
    """``square_plan_dev``'s product and its ``torch.autograd`` gradient
    against the reference's and its ``jax.grad``, n not a multiple of bs,
    at atol 1e-5."""
    jg, tg = graphs(197, 4, seed=11)
    jplan = jspmm.square_plan_dev(jblock_sparse(jg, bs=64))
    tplan = tspmm.square_plan_dev(tformat.block_sparse(tg, bs=64),
                                  device="cpu")
    h, cot = features(jg.n, 20, 2), features(jg.n, 20, 3)

    def f(hh):
        return jnp.vdot(jspmm.aggregate_pallas(jplan, hh, interpret=True),
                        jnp.asarray(cot))

    want, want_g = jax.value_and_grad(f)(jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_()
    out = tspmm.aggregate_pallas(tplan, th)
    got = (out * torch.from_numpy(cot)).sum()
    (got_g,) = torch.autograd.grad(got, th)
    assert out.shape == (197, 20)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-5)


def test_block_sparse_dev_refuses_grad_runs_under_no_grad():
    """Through a ``BlockSparseDev`` a gradient is refused, as the
    reference's ``jax.grad`` through the kernel raises; under no_grad (or
    with an h that needs none) it runs."""
    jg, tg = graphs(120, 4, seed=13)
    jdev, tdev = both(jg, tg, 32)
    h = features(jg.n, 16, 4)
    with pytest.raises(NotImplementedError):
        jax.grad(lambda x: jspmm.aggregate_pallas(
            jdev, x, d_tile=16, interpret=True).sum())(jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward.*square_plan_dev"):
        tspmm.aggregate_pallas(tdev, th)
    with torch.no_grad():
        got = tspmm.aggregate_pallas(tdev, th)
    want = jspmm.aggregate_pallas(jdev, jnp.asarray(h), d_tile=16,
                                  interpret=True)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_spmm_dense_ref_matches_reference():
    jg, tg = graphs(90, 3, seed=17)
    a = jg.dense_adjacency()
    np.testing.assert_array_equal(a, tg.dense_adjacency())
    h = features(jg.n, 12, 6)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jspmm.spmm_dense_ref(jnp.asarray(a), jnp.asarray(h).astype(jdt))
        got = tspmm.spmm_dense_ref(torch.from_numpy(a),
                                   torch.from_numpy(h).to(tdt))
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=1e-5 if tdt == torch.float32
                                   else 2 ** -7 * np.abs(a @ h).max())


def test_block_sparse_dev_defaults_to_the_card():
    """The entry points run on the card unless the caller asks for the
    CPU (read from the signatures: there is no card here)."""
    for fn in (tspmm.block_sparse_dev, tspmm.square_plan_dev):
        params = inspect.signature(fn).parameters
        assert params["device"].default == "cuda"
        assert params["dtype"].default is torch.float32


def test_flash_hbm_bytes_model():
    """Equal to the reference's model where both schedules move the same
    bytes (g = 1, block_q 512, every key read), and to the count written
    out from the kernels' constants at Zamba2's (2, 32, 2048, 80) causal:
    both buckets there take 128 query rows and 64-key tiles
    (``flash_attention_mma.cu`` kBQ, kBKV; ``flash_attention_tf32x3.cu``'s
    (80, 80) bucket, 8 warps), so query tile i reads keys 0 .. 128(i + 1),
    and every query head re-reads them.  The model's bucket tables are
    the kernels' sources' own."""
    cases = re.findall(r"REPRO_FLASH_TF32X3_CASE\((\d+), (\d+), (\d+), "
                       r"(\d+), \d+\)\n",
                       (CSRC / "flash_attn/csrc/flash_attention_tf32x3.cu")
                       .read_text())
    assert tflash_mod._BUCKETS[4] == tuple(
        (int(dk), int(dv), 16 * int(w), int(bkv)) for dk, dv, w, bkv in cases)
    mma = "flash_attn/csrc/flash_attention_mma.cu"
    assert tflash_mod._BUCKETS[2] == ((256, 256, _constant(mma, "kBQ"),
                                       _constant(mma, "kBKV")),)
    for args, kw in (((2, 8, 8, 1000, 1300, 64, 48), {}),
                     ((1, 4, 4, 4096, 4096, 128, 128), {"itemsize": 2}),
                     ((3, 2, 2, 512, 64, 256, 256), {})):
        assert tflash.hbm_bytes_model(*args, block_q=512, **kw) == \
            jflash.hbm_bytes_model(*args, block_q=512, **kw)
    b, hq, s, hd = 2, 32, 2048, 80
    keys = sum(128 * (i + 1) for i in range(s // 128))
    elems = b * hq * s * 2 * hd + b * hq * keys * 2 * hd
    assert tflash.hbm_bytes_model(b, hq, hq, s, s, hd, hd, itemsize=2,
                                  causal=True) == 2 * elems
    assert tflash.hbm_bytes_model(b, hq, hq, s, s, hd, hd,
                                  causal=True) == 4 * elems
    # GQA (g = 2): every query head's blocks read K and V
    assert tflash.hbm_bytes_model(1, 16, 8, 512, 512, 64, 64,
                                  block_q=512) == \
        jflash.hbm_bytes_model(1, 16, 16, 512, 512, 64, 64, block_q=512)


def test_ssd_hbm_bytes_model():
    """At one head a group and one 64-row tile a chunk the port's bytes
    are the reference model's plus the state block's second read of dt,
    B and x and its two reads of ``a``; at Zamba2's (2, 2048, 80, 64)
    N = 64 and Mamba2-1.3B's (2, 2048, 64, 64) N = 128, Q = 256, the count
    written out from ``ssd_intra_chunk.cu``'s constants (kT = 64, kG = 4;
    the state block takes 4 heads a pass, 2 where N > 64, and reads B
    once a pass)."""
    source = "ssd/csrc/ssd_intra_chunk.cu"
    assert (tssd_mod._TILE, tssd_mod._GROUP) == (
        _constant(source, "kT"), _constant(source, "kG"))
    for bsz, s, p, n in ((2, 640, 30, 40), (1, 256, 64, 128)):
        q, nc = 64, s // 64
        extra = bsz * nc * (q + q * n + q * p + 2) * 4
        assert tssd.hbm_bytes_model(bsz, s, 1, p, n) == \
            jssd.hbm_bytes_model(bsz, s, 1, p, n) + extra
    g, t, bsz, s, p, q = 4, 64, 2, 2048, 64, 256
    for h, n, passes, total in ((80, 64, 1, 499_409_920),
                                (64, 128, 2, 525_357_056)):
        row_blocks = sum(g * q + g + t * n + (i + 1) * t * (n + g * p)
                         + g * t * p for i in range(q // t))
        state_block = g * q + g + passes * q * n + g * q * p + g * p * n
        want = bsz * (s // q) * (h // g) * (row_blocks + state_block) * 4
        assert want == total
        assert tssd.hbm_bytes_model(bsz, s, h, p, n, chunk=q) == want
