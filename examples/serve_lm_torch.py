"""Batched serving demo of the PyTorch port: prefill + token-by-token decode
with per-family caches (dense KV / MLA latent / SSM state / sliding-window
ring), behind a modality prefix for the vision and audio configs.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch mamba2-1.3b-reduced
    PYTHONPATH=src python examples/serve_lm_torch.py --arch gemma2-9b-reduced \
        --long-context
    PYTHONPATH=src python examples/serve_lm_torch.py \
        --arch internvl2-1b-reduced --device cpu

The port of ``examples/serve_lm.py``, with the same flags and ``--device``
(default ``cuda``).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.serve import generate


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b-reduced")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--long-context", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    print(f"{cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"family={cfg.arch_type} on {args.device}")
    params = T.init_transformer(cfg, seed=0, device=args.device)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size,
                          (args.batch, args.prompt_len)).astype(np.int32)
    prefix = None
    if cfg.modality:
        prefix = rng.normal(size=(args.batch, cfg.num_prefix_embeddings,
                                  cfg.d_model)).astype(np.float32)

    t0 = time.perf_counter()
    result = generate(params, cfg, prompt, args.gen, prefix=prefix,
                      temperature=args.temperature,
                      long_context=args.long_context, device=args.device)
    if args.device.startswith("cuda"):
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = args.batch * args.gen
    print(f"generated {toks} tokens in {dt:.1f}s ({toks / dt:.1f} tok/s)")
    print("sample continuation token ids:",
          result.tokens[0, args.prompt_len:][:16].tolist())


if __name__ == "__main__":
    main()
