"""Small LM configs and greedy-serving helpers shared by the port's LM
test files.  No JAX here: the gloo ranks those files spawn import this
module, and each rank's import of JAX would cost seconds of CPU beside
the other test workers."""
import dataclasses

import torch

from repro_torch import configs
from repro_torch.configs.base import ArchConfig


def _tiny(**kw) -> ArchConfig:
    base = dict(name="tiny", arch_type="dense", num_layers=2, d_model=64,
                num_heads=8, num_kv_heads=8, head_dim=8, d_ff=128,
                vocab_size=64, act="silu", dtype="float32")
    return ArchConfig(**{**base, **kw})


def _reduced(arch: str, **kw) -> ArchConfig:
    return dataclasses.replace(configs.get_config(arch + "-reduced"),
                               dtype="float32", **kw)


_MOE = dict(arch_type="moe", moe=True, num_experts=8, num_experts_per_tok=2,
            num_shared_experts=1, moe_d_ff=32, moe_capacity_factor=8.0,
            first_dense_layers=0)


def _cache_leaves(caches):
    """Every cache's fields in order, as the reference's pytree leaves
    (a ring's ``window`` is not a leaf)."""
    return [getattr(c, f.name) for unit in caches for c in unit
            for f in dataclasses.fields(c) if f.name != "window"]


def _greedy(prefill_fn, decode_fn, params, prompt, max_len, last, step,
            steps: int):
    """Prefill and ``steps`` greedy steps: (prefill logits, caches after
    prefill, each step's logits, the tokens), each logits tensor through
    ``last`` (the gathered whole)."""
    logits, caches = prefill_fn(params, prompt, max_len=max_len)
    first = last(logits, prompt.shape[1])
    caches0 = _snapshot(caches)
    tok = first[:, -1].argmax(-1)
    toks, outs = [tok], []
    for _ in range(steps):
        out, caches = step(decode_fn, params, tok[:, None], caches)
        out = last(out, 1)
        outs.append(out)
        tok = out[:, -1].argmax(-1)
        toks.append(tok)
    return first, caches0, outs, toks


def _snapshot(caches):
    """A copy of a cache tree (decode writes in place)."""
    return [[dataclasses.replace(c, **{
        f.name: getattr(c, f.name).clone()
        for f in dataclasses.fields(c) if torch.is_tensor(getattr(c, f.name))
    }) for c in unit] for unit in caches]


def _plain_step(decode_fn, params, tok, caches):
    return decode_fn(params, tok, caches)
