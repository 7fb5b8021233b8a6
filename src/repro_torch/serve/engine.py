"""Serving engine: prefill, decode steps and batched generation — the port
of ``repro/serve/engine.py``.

Greedy decoding is ``argmax`` (the first index wins ties, as in jnp).
Temperature sampling draws from an explicit ``torch.Generator``; it is not
held against JAX, whose PRNG the port cannot reproduce.

``make_serve_fns(cfg, sharder)`` returns the per-rank program's closures
(``models/transformer.py``): ``prefill_fn`` and ``decode_fn`` take the
rank's parameter and cache shards and the global token batch and return
the rank's block of the logits' token layout.  ``generate`` runs on one
device, as the reference's (single host); a greedy loop over the sharded
closures gathers the last position's logits (``Sharder.unshard``) before
its ``argmax``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..configs.base import ArchConfig, InputShape
from ..models import transformer as T
from ..nn.shard import no_shard
from ..train.loop import TensorSpec


def make_serve_fns(cfg: ArchConfig, sharder=None, *,
                   long_context: bool = False, last_only: bool = False):
    """(prefill_fn, decode_fn) closures over ``cfg``; ``long_context`` puts
    gemma2's local layers on the O(window) ring cache; ``last_only`` has
    the prefill unembed its final position alone.  ``sharder`` is
    their ``shard``; ``decode_fn`` runs under it bound to the ``max_len``
    of the last ``prefill_fn`` call (or the one it was made with,
    ``Sharder.serving``)."""
    shard = [sharder or no_shard]

    def prefill_fn(params, tokens, prefix=None, *, max_len: int):
        shard[0] = shard[0].serving(max_len)
        return T.prefill(params, cfg, tokens, prefix, max_len=max_len,
                         long_context=long_context, shard=shard[0],
                         last_only=last_only)

    def decode_fn(params, token, caches):
        return T.decode_step(params, cfg, token, caches, shard=shard[0])

    return prefill_fn, decode_fn


def serve_step_spec(cfg: ArchConfig, shape: InputShape,
                    long_context: bool = False):
    """(token, caches) of one decode step with a ``shape.seq_len``-deep
    cache, for the dry-run: the (B, 1) int32 token's ``TensorSpec`` and
    the caches in the compute dtype as meta tensors (shapes and dtypes
    alone)."""
    b = shape.global_batch
    token = TensorSpec((b, 1), torch.int32)
    caches = T.init_caches(cfg, b, shape.seq_len,
                           dtype=T.compute_dtype(cfg), device="meta",
                           long_context=long_context)
    return token, caches


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray              # (B, prompt + generated)
    prefill_logits: torch.Tensor


@torch.no_grad()
def generate(params, cfg: ArchConfig, prompt, n_steps: int, *,
             prefix=None, temperature: float = 0.0, seed: int = 0,
             max_len: Optional[int] = None, long_context: bool = False,
             device="cuda") -> GenerationResult:
    """Greedy / temperature sampling for a batch of prompts (B, S) on
    ``device``, where ``params`` must lie; a modality config's prompts go
    behind ``prefix`` (B, P, D), whose P positions the caches hold too.
    Returns the prompts and the new tokens (not the prefix)."""
    prompt = torch.as_tensor(np.asarray(prompt), device=device)
    if prefix is not None:
        prefix = torch.as_tensor(np.asarray(prefix), device=device)
    b, s = prompt.shape
    off = cfg.num_prefix_embeddings if cfg.modality else 0
    max_len = max_len or (s + n_steps + off)
    prefill_fn, decode_fn = make_serve_fns(cfg, long_context=long_context)
    logits, caches = prefill_fn(params, prompt, prefix, max_len=max_len)
    gen = torch.Generator(device=device).manual_seed(seed)
    last = logits[:, -1]
    out = [prompt.cpu().numpy()]
    for _ in range(n_steps):
        if temperature > 0:
            probs = torch.softmax(last / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)
        else:
            tok = torch.argmax(last, dim=-1)[:, None]
        out.append(tok.cpu().numpy().astype(np.int32))
        step_logits, caches = decode_fn(params, tok.to(torch.int32), caches)
        last = step_logits[:, -1]
    return GenerationResult(tokens=np.concatenate(out, axis=1),
                            prefill_logits=logits)
