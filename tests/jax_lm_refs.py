"""The JAX package's megatron oracles for the port's LM test files, run in
a child process with four forced host devices.

The parent pickles the jobs (each config's fields, its weights as numpy,
the inputs, the mesh) and starts ``python -c "...; jax_lm_refs.main(job,
out)"``.  This module imports JAX and the JAX package only, never torch:
a child that imported the test file would spend seconds on torch's
import beside the other test workers."""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
# four host devices; one thread for XLA's CPU ops beside the other tests
CHILD_XLA = ("--xla_force_host_platform_device_count=4 "
             "--xla_cpu_multi_thread_eigen=false")


def _rules(job):
    from repro.sharding.specs import ShardingRules
    return ShardingRules("megatron", data_axes=tuple(job["data_axes"]),
                         seq_shard_cache=job.get("seq_shard_cache", False))


def _grads(job, out: Path) -> None:
    """Loss, aux and every gradient leaf of the reference's megatron
    ``make_loss_fn``, jitted once."""
    import jax
    from repro.configs.base import ArchConfig
    from repro.launch.mesh import make_host_mesh
    from repro.sharding.specs import Sharder
    from repro.train import loop as jloop
    mesh = make_host_mesh(**job["mesh"])
    loss_fn = jloop.make_loss_fn(ArchConfig(**job["cfg"]),
                                 Sharder(mesh=mesh, rules=_rules(job)),
                                 remat=False)
    with mesh:
        (total, (loss, aux)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(job["params"], job["batch"])
    np.savez(out / f"ref_{job['tag']}.npz", np.asarray(total),
             np.asarray(loss), np.asarray(aux),
             *[np.asarray(g) for g in jax.tree.leaves(grads)])


def _adamw(job, out: Path) -> None:
    """The metrics of the reference's jitted megatron ``sharded_setup``
    step over each batch."""
    from repro import optim as joptim
    from repro.configs.base import ArchConfig, InputShape
    from repro.launch.mesh import make_host_mesh
    from repro.train import loop as jloop
    from repro.train.state import init_train_state
    mesh = make_host_mesh(**job["mesh"])
    setup = jloop.sharded_setup(ArchConfig(**job["cfg"]),
                                InputShape(**job["shape"]), mesh,
                                _rules(job), lr=job["lr"])
    state = init_train_state(job["params"], joptim.adamw(job["lr"]))
    metrics = []
    with mesh:
        for batch in job["batches"]:
            state, m = setup["train_step"](state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    (out / f"ref_{job['tag']}.json").write_text(json.dumps(metrics))


def _serving(job, out: Path) -> None:
    """The reference's megatron serving: the jitted prefill's logits and
    caches and ``steps`` greedy decode steps' logits."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ArchConfig
    from repro.launch.mesh import make_host_mesh
    from repro.serve.engine import make_serve_fns
    from repro.sharding.specs import Sharder
    mesh = make_host_mesh(**job["mesh"])
    prefill_fn, decode_fn = make_serve_fns(
        ArchConfig(**job["cfg"]), Sharder(mesh=mesh, rules=_rules(job)),
        long_context=job["long_context"])
    p, max_len = job["params"], job["max_len"]
    with mesh:
        logits, caches = jax.jit(lambda p, t: prefill_fn(
            p, t, max_len=max_len))(p, jnp.asarray(job["prompt"]))
        leaves = [np.asarray(x) for x in jax.tree.leaves(caches)]
        dec = jax.jit(decode_fn)
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        steps = []
        for _ in range(job["steps"]):
            step_logits, caches = dec(p, tok, caches)
            steps.append(np.asarray(step_logits))
            tok = jnp.argmax(step_logits[:, -1], -1)[:, None].astype(
                jnp.int32)
    np.savez(out / f"ref_{job['tag']}.npz", np.asarray(logits), *steps,
             *leaves)


KINDS = {"grads": _grads, "adamw": _adamw, "serving": _serving}


def main(job_file: str, out_dir: str) -> None:
    import jax
    assert len(jax.devices()) == 4
    for job in pickle.loads(Path(job_file).read_bytes()):
        KINDS[job["kind"]](job, Path(out_dir))


def job(kind: str, tag: str, cfg, params, mesh: dict, data_axes, **kw):
    """One job: ``cfg`` a port config (its fields travel), ``params`` its
    weights as numpy."""
    return dict(kind=kind, tag=tag, cfg=dataclasses.asdict(cfg),
                params=params, mesh=mesh, data_axes=tuple(data_axes), **kw)


def start(jobs: list, tmp: Path) -> subprocess.Popen:
    """The child running ``jobs`` into ``tmp`` (pickled there first)."""
    (tmp / "jobs.pkl").write_bytes(pickle.dumps(jobs))
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; import jax_lm_refs; "
            "jax_lm_refs.main({!r}, {!r})").format(
                str(HERE), str(HERE.parent / "src"), str(tmp / "jobs.pkl"),
                str(tmp))
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": CHILD_XLA}
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
