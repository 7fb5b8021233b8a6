"""The port's flash attention (token-major entry point; on CPU tensors its
plain version) against the JAX package's Pallas kernel run in interpret
mode, on the same numpy inputs: the sweep of ``test_kernel_flash.py`` —
ragged shapes, GQA groups, dtypes, window, softcap, non-causal, hdv ≠ hd —
at atol/rtol 2e-5 in fp32 (sums in another order) and 2e-2 in bf16 (one
bf16 rounding of the output)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import flash_attention as j_flash
from repro.kernels.flash_attn.ref import flash_ref as j_flash_ref
from repro_torch.kernels import flash_attn as tflash
from repro_torch.kernels.flash_attn import flash_attention, flash_ref


def _mk(b, sq, skv, hq, hkv, hd, hdv=None, seed=0):
    rng = np.random.default_rng(seed)
    hdv = hdv or hd
    return (rng.standard_normal((b, sq, hq, hd), np.float32),
            rng.standard_normal((b, skv, hkv, hd), np.float32),
            rng.standard_normal((b, skv, hkv, hdv), np.float32))


def _check(qkv, dtype="float32", tol=2e-5, block_q=16, block_kv=16, **kw):
    before = tflash.flash_attention_bhsd.launches
    want = j_flash(*(jnp.asarray(a, dtype) for a in qkv), interpret=True,
                   block_q=block_q, block_kv=block_kv, **kw)
    got = flash_attention(*(torch.from_numpy(a).to(getattr(torch, dtype))
                            for a in qkv), **kw)
    assert tflash.flash_attention_bhsd.launches == before
    assert tuple(got.shape) == want.shape and got.dtype == getattr(
        torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("sq,skv,bq,bkv", [
    (64, 64, 16, 16),        # exact tiling
    (60, 60, 16, 16),        # ragged: padding in both q and kv
    (33, 65, 16, 32),        # ragged + uneven blocks
    (128, 128, 128, 128),    # single block
])
def test_shape_sweep(sq, skv, bq, bkv):
    _check(_mk(2, sq, skv, 4, 4, 32), causal=True, block_q=bq, block_kv=bkv)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (8, 1), (6, 2)])
def test_gqa_groups(hq, hkv):
    _check(_mk(2, 48, 48, hq, hkv, 16), causal=True)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 2e-2)])
def test_dtypes(dtype, tol):
    _check(_mk(1, 64, 64, 4, 2, 32), dtype=dtype, tol=tol, causal=True,
           block_q=32, block_kv=32)


def test_window_and_softcap():
    qkv = _mk(2, 96, 96, 4, 4, 16, seed=3)
    _check(qkv, causal=True, window=24)
    _check(qkv, causal=True, softcap=30.0, block_q=32)


def test_non_causal():
    _check(_mk(1, 40, 72, 4, 2, 16, seed=4), causal=False)


def test_asymmetric_head_dims():
    """MLA's shape: the v head dim differs from the qk head dim."""
    _check(_mk(1, 64, 64, 4, 4, 32, hdv=16, seed=5), causal=True,
           block_kv=32)


def test_plain_version_matches_jax_oracle_head_major():
    q, k, v = (a.transpose(0, 2, 1, 3) for a in _mk(2, 40, 40, 6, 2, 16,
                                                      seed=6))
    want = j_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=True, window=9, softcap=5.0, scale=0.3)
    got = flash_ref(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), causal=True, window=9, softcap=5.0,
                    scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_kernel_wrapper_takes_cuda_tensors_only():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention_bhsd(q, q, q)


@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "mma_bf16"),
                                           (torch.float32, "fma_fp32")])
def test_kernel_wrapper_routes_by_dtype(monkeypatch, dtype, variant):
    """bf16 goes to the tensor-core entry and fp32 to the FMA entry, each
    counted under its variant; checked by the variant the launch asks
    ``_kernel`` for (a stand-in, since there is no card here)."""
    from repro_torch.kernels.flash_attn import flash as tf
    asked = []

    def fake_kernel(v):
        asked.append(v)
        return lambda *args: 0

    monkeypatch.setattr(tf, "_kernel", fake_kernel)
    monkeypatch.setattr(tf.flash_attention_bhsd, "launches", 0)
    monkeypatch.setattr(tf.flash_attention_bhsd, "launches_by_variant",
                        {"mma_bf16": 0, "fma_fp32": 0})
    q = torch.zeros(1, 4, 8, 80, dtype=dtype)
    kv = torch.zeros(1, 2, 8, 80, dtype=dtype)
    tf._launch(q, kv, kv, torch.empty_like(q), causal=True, window=None,
               softcap=None, scale=0.1, stream=0)
    assert asked == [variant]
    assert tf.flash_attention_bhsd.launches == 1
    assert tf.flash_attention_bhsd.launches_by_variant == {
        "mma_bf16": int(variant == "mma_bf16"),
        "fma_fp32": int(variant == "fma_fp32")}
