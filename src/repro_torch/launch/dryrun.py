"""Dry-run of the LM's per-rank program on the production meshes — the
port of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minitron-8b \\
        --shape train_4k --mesh single --out results/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun

The reference lowers and compiles every (arch × input shape × mesh) for
256 or 512 forced host devices and reads XLA's analyses of the compiled
module.  Torch has no partitioner and no HLO: the port's program is the
per-rank program itself.  So the dry-run runs it once, as rank 0 of a
world of 256 (or 512) ranks on torch's ``fake`` process-group backend
(each collective returns at once and moves nothing), under
``FakeTensorMode`` (tensors carry shapes and dtypes and no data), on
parameters shaped by ``init_transformer(cfg, device="meta")``.  It needs
no card and touches no CUDA: CPU time only, seconds to a minute a combo.

Per kind, the reference's program: training, ``sharded_setup`` and one
AdamW step on the global batch; prefill, ``make_serve_fns(...,
last_only=)`` at the reference's ``max_len`` (the prompt + 1 rounded up
to 256, plus a modality config's prefix); decode, one step of
``make_serve_fns`` on ``serve_step_spec``'s token and caches.  The knobs
are the reference's: ``attn_impl`` (naive or blockwise: the kernels have
no trace, and their wrappers refuse fake tensors), ``logits_last``,
``mixing="a2a"`` and ``moe="ep"`` through ``ExplicitSharder``,
``cache_seq`` and ``remat``; the strategies ``neutron_tp``, ``megatron``
and ``dp``.

The record has the reference's keys, filled from the run (stated
departures):

* ``compile_seconds`` — the trace time: the wall seconds of building the
  mesh and running the program once under the fake modes; nothing is
  compiled.
* ``memory`` — ``argument_bytes`` exact from the shards' shapes: the
  rank's parameter shards, and the AdamW moments and count (training) or
  the cache shards (decode); the token batch, which every rank takes whole
  and slices, is not counted.  ``output_bytes``: the returned tensors
  that are not arguments (the step updates its state, and a decode step
  its caches, in place).  ``peak_bytes``: the most bytes live at once
  during the run, arguments included, from a live-storage tracker
  (``torch.distributed._tools.mem_tracker.MemTracker``) — XLA's
  ``memory_analysis`` has no counterpart, and the eager program holds
  what autograd saves and frees each buffer when its last reference
  goes; ``temp_bytes`` = peak − arguments − outputs.
* ``cost`` — ``flops`` and ``bytes accessed`` as ``roofline.census``
  counts them (``FlopCounterMode``; the eager byte model);
  ``transcendentals`` the elements the run's exp, log, tanh, sigmoid,
  silu, gelu, erf, rsqrt and softmax ops produce.
* ``collectives`` and ``roofline`` — ``roofline.census`` of the run's
  collective ledger, and its terms on the H100's peaks.
* ``ledger`` (the port's own key) — the collective ledger's ``as_dict``.

What the fake run meets: the port's LM path makes no data-dependent host
sync (no ``.item()``, ``nonzero`` or host-side capacity: the MoE
capacity is computed from shapes), so nothing needs a stand-in; a
decode step's caches carry the ``length`` that ``init_caches`` gives
(0), and attend over the whole cache as every step does.  Building the
mesh creates every rank's process groups on the fake backend (336 at
512 ranks), which takes milliseconds.

``lower_combo`` runs any world and mesh shape (``mesh_shape``), so tests
and ``chip_smoke.py`` run it small; it initialises the fake default group
itself (``runtime.distributed.fake_world``), refuses to run where one
already exists, and destroys it on exit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from ..configs import INPUT_SHAPES, get_config, list_archs
from ..configs.base import ArchConfig, InputShape
from ..models import transformer as T
from ..params import tree_leaves, tree_map
from ..runtime import telemetry
from ..runtime.distributed import fake_world
from ..serve import engine
from ..sharding import specs as S
from ..sharding.explicit import ExplicitSharder
from ..train import loop as train_loop
from ..train.state import init_sharded_state
from . import roofline
from .mesh import make_host_mesh, make_production_mesh

# long_500k runs only for sub-quadratic-capable archs
LONG_CONTEXT_ARCHS = {"mamba2-1.3b", "zamba2-2.7b", "gemma2-9b"}

PRODUCTION = {False: ("16x16", dict(model=16, data=16)),
              True: ("2x16x16", dict(model=16, data=16, pod=2))}

REMAT = {"full": True, "dots": "dots", "none": False}


def applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True


def _mesh_name(mesh_shape: dict) -> str:
    """"16x16" for (data 16, model 16); "2x16x16" with a pod axis."""
    dims = [mesh_shape.get("data", 1), mesh_shape["model"]]
    if mesh_shape.get("pod", 1) > 1:
        dims.insert(0, mesh_shape["pod"])
    return "x".join(str(d) for d in dims)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _storages(tensors) -> set:
    return {t.untyped_storage()._cdata for t in tensors}


def _config(arch, attn_impl: Optional[str]) -> ArchConfig:
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    kernels = train_loop._forward_only_kernels(cfg)
    if kernels:
        raise ValueError(
            f"the dry-run traces no kernel ({' and '.join(kernels)}): use "
            f"attn_impl naive or blockwise and ssm_impl jnp")
    return cfg


def _fake_like(tree):
    """A fake tensor of each meta tensor's shape and dtype (inside
    ``FakeTensorMode``)."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), tree)


def sharder_for(mesh, *, strategy: str = "neutron_tp", fsdp: bool = True,
                seq_cache=False, mixing: str = "constraint",
                moe: str = "spmd"):
    """The reference dry-run's sharder of a combo on ``mesh``: its rules,
    and ``ExplicitSharder`` with each knob's mechanism where ``mixing`` is
    ``"a2a"`` or ``moe`` is ``"ep"``."""
    rules = S.ShardingRules(strategy=strategy,
                            data_axes=tuple(mesh.data_axes),
                            seq_shard_cache=seq_cache, fsdp=fsdp)
    if mixing == "a2a" or moe == "ep":
        return ExplicitSharder(mesh, rules,
                               use_a2a_mixing=(mixing == "a2a"),
                               use_ep_moe=(moe == "ep"))
    return S.Sharder(mesh, rules)


def program(cfg: ArchConfig, shape: InputShape, mesh, *,
            strategy: str = "neutron_tp", fsdp: bool = True, remat="full",
            logits_last: bool = False, mixing: str = "constraint",
            moe: str = "spmd", cache_seq: Optional[str] = None,
            params=None):
    """(argument tensors, the call) of one combo's per-rank program on
    ``mesh`` (the knobs of :func:`lower_combo`): a training step, a
    prefill or a decode step by ``shape.kind``, on the whole tree
    ``params`` (by default fake tensors shaped by the meta init: call it
    inside ``FakeTensorMode``) placed as the rank's shards, and zero
    tokens."""
    b, s = shape.global_batch, shape.seq_len
    long_ctx = shape.name == "long_500k"
    sharder = sharder_for(mesh, strategy=strategy, fsdp=fsdp,
                          seq_cache=cache_seq if cache_seq else long_ctx,
                          mixing=mixing, moe=moe)
    remat = REMAT.get(remat, remat)
    full = _fake_like(T.init_transformer(cfg, device="meta")) \
        if params is None else params
    if shape.kind == "train":
        setup = train_loop.sharded_setup(cfg, shape, sharder.mesh,
                                         sharder.rules, sharder=sharder,
                                         remat=remat)
        state = init_sharded_state(full, cfg, setup["optimizer"], sharder)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype)
                 for k, v in setup["batch_specs"].items()}
        args = [t for t in tree_leaves(
            [state.params, state.opt_state.count, state.opt_state.mu,
             state.opt_state.nu]) if torch.is_tensor(t)]
        return args, lambda: setup["train_step"](state, batch)
    shards = S.place_params(full, cfg, sharder)
    args = tree_leaves(shards)
    if shape.kind == "prefill":
        prefill_fn, _ = engine.make_serve_fns(
            cfg, sharder, long_context=long_ctx, last_only=logits_last)
        tokens = torch.zeros(b, s, dtype=torch.int32)
        # round up so the cache seq dim stays shardable
        max_len = -(-(s + 1) // 256) * 256
        prefix = None
        if cfg.modality:
            prefix = torch.zeros(b, cfg.num_prefix_embeddings, cfg.d_model)
            max_len += cfg.num_prefix_embeddings

        def run():
            with torch.no_grad():
                return prefill_fn(shards, tokens, prefix, max_len=max_len)
        return args, run
    token_spec, like = engine.serve_step_spec(cfg, shape,
                                              long_context=long_ctx)
    _, decode_fn = engine.make_serve_fns(cfg, sharder.serving(s),
                                         long_context=long_ctx)
    caches = S.place_caches(S._map_caches(
        lambda name, t: torch.zeros(t.shape, dtype=t.dtype)
        if torch.is_tensor(t) else t, like), sharder)
    token = torch.zeros(token_spec.shape, dtype=token_spec.dtype)
    args += [t for t in _cache_tensors(caches)]

    def run():
        with torch.no_grad():
            return decode_fn(shards, token, caches)
    return args, run


def _cache_tensors(caches) -> list:
    out = []
    S._map_caches(lambda name, t: out.append(t) if torch.is_tensor(t)
                  else None, caches)
    return out


def lower_combo(arch, shape_name, *, multi_pod: bool = False,
                mesh_shape: Optional[dict] = None,
                strategy: str = "neutron_tp", fsdp: bool = True,
                remat="full", attn_impl: Optional[str] = None,
                logits_last: bool = False, mixing: str = "constraint",
                moe: str = "spmd", cache_seq: Optional[str] = None) -> dict:
    """Run one combination's per-rank program once, as rank 0 of the fake
    world of its mesh: the production mesh (``multi_pod``), or
    ``mesh_shape`` (``dict(model=, data=, pod=)``) of any size.  ``arch``
    and ``shape_name`` may be a config and an ``InputShape``.  Returns the
    run's ``cfg``, ``shape``, ``mesh`` name and ``chips``, its ``ledger``,
    ``flops``, ``bytes``, ``transcendentals``, ``memory`` and ``seconds``.

    §Perf knobs (default = paper-faithful baseline):
      attn_impl   — override cfg.attn_impl ("blockwise" = flash schedule)
      logits_last — prefill unembeds only the final position
      mixing      — "a2a": explicit all-to-alls for the seq↔heads
                    transitions (the paper's gather/split)
      moe         — "ep": expert-parallel dispatch via all-to-all
      cache_seq   — "model"/"data": shard the KV cache sequence dim
    """
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.time()
    cfg = _config(arch, attn_impl)
    shape = INPUT_SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name
    production = mesh_shape is None
    if production:
        name, mesh_shape = PRODUCTION[multi_pod]
    else:
        name = _mesh_name(mesh_shape)
    world = math.prod(mesh_shape.values())
    with fake_world(world):
        mesh = make_production_mesh(multi_pod=multi_pod) if production \
            else make_host_mesh(**mesh_shape)
        with FakeTensorMode():
            args, run = program(cfg, shape, mesh, strategy=strategy,
                                fsdp=fsdp, remat=remat,
                                logits_last=logits_last, mixing=mixing,
                                moe=moe, cache_seq=cache_seq)
            tracker = MemTracker()
            tracker.track_external(*args)
            flops, nbytes = FlopCounterMode(display=False), \
                roofline.ByteCounter()
            with telemetry.collect_comm() as ledger, tracker, flops, \
                    nbytes:
                out = run()
            peak = sum(snap["Total"] for snap in
                       tracker.get_tracker_snapshot("peak").values())
            outs = [t for t in tree_leaves(_plain(out))
                    if isinstance(t, torch.Tensor)]
            held = _storages(args)
            out_bytes = _nbytes([t for t in outs
                                 if t.untyped_storage()._cdata not in held])
    arg_bytes = _nbytes(args)
    memory = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
              "temp_bytes": max(0, peak - arg_bytes - out_bytes),
              "peak_bytes": max(peak, arg_bytes + out_bytes)}
    return dict(cfg=cfg, shape=shape, mesh=name, chips=world,
                ledger=ledger, flops=float(flops.get_total_flops()),
                bytes=float(nbytes.bytes),
                transcendentals=float(nbytes.transcendentals),
                memory=memory,
                seconds=time.time() - t0)


def _plain(tree):
    """A result as nested lists (dataclasses, train states and dicts
    opened)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [_plain(getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        return [_plain(v) for v in tree.values()]
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree


def run_combo(arch, shape_name, *, multi_pod: bool = False,
              mesh_shape: Optional[dict] = None,
              strategy: str = "neutron_tp", fsdp: bool = True,
              variant: str = "baseline", **knobs) -> dict:
    """One combination's record (module docstring), the reference's keys
    and ``ledger``."""
    run = lower_combo(arch, shape_name, multi_pod=multi_pod,
                      mesh_shape=mesh_shape, strategy=strategy, fsdp=fsdp,
                      **knobs)
    cfg, shape = run["cfg"], run["shape"]
    census = roofline.census(run["ledger"], run["flops"], run["bytes"])
    terms = roofline.derive_terms(
        cfg.name, shape.name, run["mesh"], run["chips"], census,
        roofline.model_flops_for(cfg, shape))
    return {
        "arch": cfg.name, "shape": shape.name, "mesh": run["mesh"],
        "strategy": strategy, "variant": variant, "knobs": knobs,
        "chips": run["chips"],
        "compile_seconds": run["seconds"],
        "memory": run["memory"],
        "cost": {"flops": run["flops"], "bytes accessed": run["bytes"],
                 "transcendentals": run["transcendentals"]},
        "collectives": census["collectives"],
        "roofline": terms.as_dict(),
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
        "ledger": run["ledger"].as_dict(),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--strategy", default="neutron_tp",
                    choices=["neutron_tp", "megatron", "dp"])
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    # §Perf knobs
    ap.add_argument("--variant", default="baseline",
                    help="tag for the output JSON name")
    ap.add_argument("--attn", default=None,
                    choices=[None, "naive", "blockwise"])
    ap.add_argument("--logits-last", action="store_true")
    ap.add_argument("--mixing", default="constraint",
                    choices=["constraint", "a2a"])
    ap.add_argument("--moe", default="spmd", choices=["spmd", "ep"])
    ap.add_argument("--cache-seq", default=None,
                    choices=[None, "model", "data"])
    ap.add_argument("--remat", default="full",
                    choices=["full", "dots", "none"])
    args = ap.parse_args()
    knobs = dict(attn_impl=args.attn, logits_last=args.logits_last,
                 mixing=args.mixing, moe=args.moe,
                 cache_seq=args.cache_seq, remat=args.remat)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    print("dry-run of rank 0's program on torch's fake backend")
    failures = []
    for arch in archs:
        for shape in shapes:
            if not applicable(arch, shape):
                print(f"SKIP {arch} × {shape} (no long-context variant)")
                continue
            for mp in meshes:
                tag = f"{arch}__{shape}__{PRODUCTION[mp][0]}" \
                    f"__{args.strategy}"
                if args.variant != "baseline":
                    tag += f"__{args.variant}"
                try:
                    rec = run_combo(arch, shape, multi_pod=mp,
                                    strategy=args.strategy,
                                    fsdp=not args.no_fsdp,
                                    variant=args.variant, **knobs)
                    with open(os.path.join(args.out, tag + ".json"),
                              "w") as f:
                        json.dump(rec, f, indent=2)
                    r = rec["roofline"]
                    print(f"OK   {tag}: trace {rec['compile_seconds']:.1f}s"
                          f" peak/dev {rec['memory']['peak_bytes']/2**30:.2f}"
                          f" GiB  dominant={r['dominant']}"
                          f" (c={r['compute_s']:.2e}s m={r['memory_s']:.2e}s"
                          f" coll={r['collective_s']:.2e}s)", flush=True)
                except Exception as e:  # noqa: BLE001
                    failures.append((tag, repr(e)))
                    print(f"FAIL {tag}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(" ", tag, err)
        raise SystemExit(1)
    print("\nall dry-run combinations traced")


if __name__ == "__main__":
    main()
