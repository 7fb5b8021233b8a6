"""Ring attention and the ppermute under it, at four gloo ranks.

* ``collectives.ppermute``: a rank receives the operand of the rank that
  maps to it (zeros where none does); its backward sends the cotangent
  along the inverse permutation; the ledger records each call at the ring
  factor 1, forward and mirrored.
* ``nn.ring_attention.ring_attention_local``: each rank's query chunk of
  a sequence sharded over the four ranks, against the JAX package's
  unsharded ``attention_core`` on the whole sequence — causal, a sliding
  window, a softcap, GQA — outputs and the q/k/v gradients of a random
  cotangent (``jax.vjp``), at 1e-5; two ppermutes a step over n − 1
  steps, forward and mirrored.

One spawn of four ranks for the file."""
import datetime
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.nn import attention as jattn
from repro_torch.nn.ring_attention import ring_attention_local
from repro_torch.runtime import collectives as tC
from repro_torch.runtime import telemetry as tT

WORLD, B, S, HD = 4, 2, 32, 8
TOL = 1e-5
CASES = {"causal": dict(hq=4, hkv=4, window=None, softcap=None),
         "gqa-window": dict(hq=6, hkv=2, window=12, softcap=None),
         "softcap-mqa": dict(hq=3, hkv=1, window=None, softcap=5.0)}
TIMEOUT = datetime.timedelta(seconds=60)


def _inputs(hq, hkv):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, S, hq, HD), np.float32)
    k = rng.standard_normal((B, S, hkv, HD), np.float32)
    v = rng.standard_normal((B, S, hkv, HD), np.float32)
    ct = rng.standard_normal((B, S, hq, HD), np.float32)
    return q, k, v, ct


def _rank(rank, init, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=WORLD, timeout=TIMEOUT)
    try:
        res = {}
        # ppermute: a shift by one, and a partial permutation
        x = torch.full((3,), float(rank), requires_grad=True)
        with tT.collect_comm() as led:
            y = tC.ppermute(x, None, [(i, (i + 1) % WORLD)
                                      for i in range(WORLD)])
            (y * (rank + 1)).sum().backward()
        res["shift"] = [y.tolist(), x.grad.tolist(), led.as_dict()]
        res["partial"] = tC.ppermute(torch.full((2,), float(rank)), None,
                                     [(0, 2), (2, 0), (1, 1)]).tolist()
        sc = S // WORLD
        for name, c in CASES.items():
            q, k, v, ct = _inputs(c["hq"], c["hkv"])
            part = slice(rank * sc, (rank + 1) * sc)
            ql, kl, vl = (torch.tensor(a[:, part]).requires_grad_()
                          for a in (q, k, v))
            with tT.collect_comm() as led:
                out = ring_attention_local(ql, kl, vl, None, causal=True,
                                           window=c["window"],
                                           softcap=c["softcap"])
                out.backward(torch.tensor(ct[:, part]))
            res[name] = [out.tolist(), ql.grad.tolist(), kl.grad.tolist(),
                         vl.grad.tolist(), led.as_dict()]
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, tmp / "rendezvous", tmp))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * WORLD
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(WORLD)]


def test_ppermute_moves_and_transposes(ranks):
    for r, got in enumerate(ranks):
        y, grad, ledger = got["shift"]
        assert y == [float((r - 1) % WORLD)] * 3
        # the cotangent (r + 1) goes back to rank r − 1
        assert grad == [float((r + 1) % WORLD + 1)] * 3
        assert ledger == {"ppermute|model|float32": {
            "calls": 1.0, "payload_bytes": 12.0, "wire_bytes": 12.0,
            "mirrored_calls": 1.0, "mirrored_wire_bytes": 12.0}}
    assert [got["partial"] for got in ranks] == [
        [2.0, 2.0], [1.0, 1.0], [0.0, 0.0], [0.0, 0.0]]


def _reference(c):
    q, k, v, ct = _inputs(c["hq"], c["hkv"])
    mask = (jattn._window_mask(S, S, 0, c["window"]) if c["window"]
            else jattn._causal_mask(S, S, 0))[None]
    out, vjp = jax.vjp(lambda q, k, v: jattn.attention_core(
        q, k, v, mask, softcap=c["softcap"]), jnp.asarray(q),
        jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(ct))]


@pytest.mark.parametrize("case", CASES)
def test_ring_attention_matches_reference(ranks, case):
    want = _reference(CASES[case])
    sc = S // WORLD
    for r, got in enumerate(ranks):
        part = slice(r * sc, (r + 1) * sc)
        for g, w in zip(got[case][:4], want):
            g, w = np.asarray(g), w[:, part]
            assert np.abs(g - w).max() <= TOL * max(1.0, np.abs(w).max())
        ledger = got[case][4]
        assert set(ledger) == {"ppermute|model|float32"}
        e = ledger["ppermute|model|float32"]
        assert e["calls"] == e["mirrored_calls"] == 2 * (WORLD - 1)
