"""The arithmetic of the fp32 flash kernel
(``src/repro_torch/kernels/flash_attn/csrc/flash_attention_tf32x3.cu``),
emulated in torch on the CPU and held against the plain version
``flash_ref``: the kernel's head-dim buckets and key tiles, its walk over
the key tiles of each warp's 16 query rows with the tiles it skips, the
online softmax in base 2, and both products (S = Q·Kᵀ and O += P·V) as
three TF32 passes of a hi/lo split of each operand.  The hold is the one
``chip_smoke.py`` phase 4 puts on the kernel, max|Δ| ≤ 1e-5·(1 +
max|ref|), at small copies of phase 4's fp32 cases; one TF32 pass misses
it, which is why the kernel takes three.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attn import flash_ref
from torch_tf32 import one_pass, three_pass

KERNEL_TOL = 1e-5
NEG_INF = -1e30
LOG2E = 1.4426950408889634
SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "flash_attn" / "csrc" / "flash_attention_tf32x3.cu")
SMEM_PER_SM = 233472       # 228 KB an H100 SM, 1 KB of it reserved a block
SMEM_PER_BLOCK = 232448    # 227 KB


def _buckets():
    """(DK, DV, warps, keys a tile, blocks an SM) of each instantiation, in
    the order the C entry tries them, read from the source."""
    cases = re.findall(r"REPRO_FLASH_TF32X3_CASE\((\d+), (\d+), (\d+), "
                       r"(\d+), (\d+)\)", SOURCE.read_text())
    return [tuple(int(x) for x in c) for c in cases]


def _bucket(hd, hdv):
    return next(b for b in _buckets() if hd <= b[0] and hdv <= b[1])


def _smem_bytes(dk, dv, warps, bkv):
    """Q (16·warps rows) and two stages of K and V tiles, at the kernel's
    padded strides (q, k: DK + 8; v: DV + 4)."""
    return 4 * (16 * warps * (dk + 8) + 2 * bkv * ((dk + 8) + (dv + 4)))


def emulate(q, k, v, *, causal=True, window=None, softcap=None, scale=None,
            mm=three_pass, skip=True, stats=None):
    """The kernel's function as it computes it, on head-major fp32 CPU
    tensors: q (B, Hq, Sq, hd), k (B, Hkv, Skv, hd), v (B, Hkv, Skv, hdv).
    ``mm`` is the product (three TF32 passes, or one); ``skip`` drops the
    key tiles a block or a warp cannot see, as the kernel does (without
    it they go through the same arithmetic).  ``stats``, a dict, gets the
    count of warp tiles walked and skipped."""
    b, hq, sq, hd = q.shape
    hkv, skv, hdv = k.shape[1], k.shape[2], v.shape[3]
    dk, dv, warps, bkv, _ = _bucket(hd, hdv)
    scale = scale if scale is not None else hd ** -0.5
    # zero columns up to the bucket (exact), rows up to whole tiles
    nkv = -(-skv // bkv)
    bq = 16 * warps
    nq = -(-sq // bq)
    qp = torch.zeros(b, hq, nq * bq, dk)
    qp[:, :, :sq, :hd] = q
    kp = torch.zeros(b, hkv, nkv * bkv, dk)
    kp[:, :, :skv, :hd] = k
    vp = torch.zeros(b, hkv, nkv * bkv, dv)
    vp[:, :, :skv, :hdv] = v
    g = hq // hkv
    kp, vp = (t.repeat_interleave(g, dim=1) for t in (kp, vp))
    raw = softcap is None and scale > 0
    sl2 = (scale if raw else 1.0) * LOG2E
    out = torch.zeros(b, hq, nq * bq, dv)
    walked = skipped = 0
    for blk in range(nq):
        q0 = blk * bq
        j_hi = nkv - 1
        if causal:
            j_hi = min(j_hi, (min(q0 + bq, sq) - 1) // bkv)
        j_lo = (q0 - window + 1) // bkv if window and q0 - window + 1 > 0 \
            else 0
        for w in range(warps):
            qa = q0 + 16 * w
            qb = qa + 15
            qi = torch.arange(qa, qa + 16)[:, None]
            m = torch.full((b, hq, 16, 1), NEG_INF)
            lsum = torch.zeros(b, hq, 16, 1)
            acc = torch.zeros(b, hq, 16, dv)
            qw = qp[:, :, qa:qa + 16]
            for j in range(nkv):
                k0 = j * bkv
                masked = (causal and k0 > qb) or bool(
                    window and k0 + bkv - 1 <= qa - window)
                if skip and (j < j_lo or j > j_hi or masked):
                    skipped += 1
                    continue
                walked += 1
                s = mm(qw, kp[:, :, k0:k0 + bkv].transpose(-1, -2))
                if not raw:
                    s = s * scale
                    if softcap is not None:
                        s = softcap * torch.tanh(s / softcap)
                kj = torch.arange(k0, k0 + bkv)[None, :]
                ok = kj < skv
                if causal:
                    ok = ok & (kj <= qi)
                if window:
                    ok = ok & (kj > qi - window)
                s = torch.where(ok, s, NEG_INF)
                # fmaxf: a NaN score leaves the max to the others
                mx = torch.where(s.isnan(), NEG_INF, s).amax(-1, keepdim=True)
                m_new = torch.fmax(m, mx)
                alpha = torch.exp2((m - m_new) * sl2)
                mb = torch.where(m_new == NEG_INF, math.inf, m_new * sl2)
                p = torch.exp2(s * sl2 - mb)
                lsum = lsum * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + mm(p, vp[:, :, k0:k0 + bkv])
                m = m_new
            out[:, :, qa:qa + 16] = acc / torch.fmax(lsum,
                                                     torch.tensor(1e-30))
    if stats is not None:
        stats.update(walked=walked, skipped=skipped)
    return out[:, :, :sq, :hdv]


# small copies of phase 4's fp32 cases:
# b, hq, hkv, sq, skv, hd, hdv, causal, window, softcap
CASES = {
    "hd80_causal": (1, 4, 2, 160, 160, 80, 80, True, None, None),
    "hd256_window_softcap": (1, 2, 1, 144, 144, 256, 256, True, 40, 50.0),
    "mla_192_128": (1, 2, 2, 100, 100, 192, 128, True, None, None),
    "gqa_g7": (1, 7, 1, 96, 96, 64, 64, True, None, None),
    "sq_ne_skv": (1, 2, 2, 130, 70, 64, 64, True, None, None),
    "hd36_hdv20": (1, 4, 2, 100, 100, 36, 20, True, None, None),
}


def _inputs(case, seed):
    b, hq, hkv, sq, skv, hd, hdv = CASES[case][:7]
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, np.float32))
            for s in ((b, hq, sq, hd), (b, hkv, skv, hd), (b, hkv, skv, hdv))]


def _kw(case):
    causal, window, softcap = CASES[case][7:]
    scale = 192 ** -0.5 if case == "mla_192_128" else None
    return dict(causal=causal, window=window, softcap=softcap, scale=scale)


def _worst(got, want):
    """max|Δ| / (1e-5·(1 + max|ref|))"""
    return ((got - want).abs().max()
            / (KERNEL_TOL * (1 + want.abs().max()))).item()


@pytest.mark.parametrize("case", list(CASES))
def test_three_pass_emulation_keeps_the_kernel_hold(case):
    q, k, v = _inputs(case, seed=len(case))
    kw = _kw(case)
    assert _worst(emulate(q, k, v, **kw), flash_ref(q, k, v, **kw)) <= 0.1


def test_one_tf32_pass_misses_the_hold():
    """Why three passes: one TF32 pass (2^-11 a product) misses the hold
    in every case, where three (about 2^-22) keep it with 10× to spare."""
    worst = {}
    for case in CASES:
        q, k, v = _inputs(case, seed=len(case))
        kw = _kw(case)
        worst[case] = _worst(emulate(q, k, v, mm=one_pass, **kw),
                             flash_ref(q, k, v, **kw))
    assert min(worst.values()) > 1.0, worst


def test_skipped_tiles_are_exact():
    """A tile wholly above the diagonal or outside the window gives alpha =
    1 and p = 0 to every row: walking it changes no bit.  The windowed
    case skips tiles per block and per warp."""
    q, k, v = _inputs("hd256_window_softcap", seed=3)
    kw = _kw("hd256_window_softcap")
    stats = {}
    got = emulate(q, k, v, stats=stats, **kw)
    assert stats["skipped"] > stats["walked"] > 0
    assert torch.equal(got, emulate(q, k, v, skip=False, **kw))


@pytest.mark.parametrize("where", ["q", "k"])
def test_nan_lands_where_the_plain_version_puts_it(where):
    """A NaN with the card's canonical bits in one query row (its head's
    output row) or one key row (the rows that see the key, in the heads of
    its group) is NaN exactly where ``flash_ref`` has NaN."""
    q, k, v = _inputs("hd80_causal", seed=5)
    kw = dict(causal=True, window=50, softcap=None, scale=None)
    nan = torch.tensor([0x7fffffff], dtype=torch.int32).view(torch.float32)
    (q if where == "q" else k)[0, 1, 70, 9] = nan[0]
    got, want = emulate(q, k, v, **kw), flash_ref(q, k, v, **kw)
    assert want.isnan().any()
    assert torch.equal(got.isnan(), want.isnan())
    fin = ~want.isnan()
    assert _worst(got[fin], want[fin]) <= 0.1


def test_buckets_fit_shared_memory_and_cover_every_head_dim():
    """Each bucket's Q plus two K/V stages fits a block's 227 KB, and an
    SM's shared memory holds the blocks its registers are budgeted for;
    every hd, hdv ≤ 256 has a bucket, and the model's head dims take the
    tightest one."""
    for dk, dv, warps, bkv, minb in _buckets():
        assert dk % 8 == 0 and dv % 8 == 0 and bkv % 8 == 0
        smem = _smem_bytes(dk, dv, warps, bkv)
        assert smem <= SMEM_PER_BLOCK
        assert SMEM_PER_SM // (smem + 1024) >= minb
    for hd in range(1, 257, 5):
        for hdv in range(1, 257, 7):
            dk, dv = _bucket(hd, hdv)[:2]
            assert dk >= hd and dv >= hdv
    assert [_bucket(*d)[:2] for d in ((80, 80), (256, 256), (192, 128),
                                      (36, 20))] == [
        (80, 80), (256, 256), (192, 128), (64, 64)]
