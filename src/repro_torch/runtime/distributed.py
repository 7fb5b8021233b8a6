"""Multi-host process runtime: the env-contract process group and
per-rank placement of host data.

The engine (``core.decouple``, ``gnn.dp_baseline``, ``core.stream``) runs
one process per rank over ``torch.distributed`` process groups.  This
module is what starts that world on **N processes on N machines** (the
paper's 16-node cluster, §5), and what puts each rank's share of the
training data on its device.  It owns

* :func:`initialize` — the port's call of ``init_process_group`` for a
  job (coordinator_address / num_processes / process_id, from the arguments
  or the env contract :data:`ENV_COORDINATOR` / :data:`ENV_NUM_PROCESSES`
  / :data:`ENV_PROCESS_ID`), with eager validation and *actionable*
  errors: an unreachable coordinator or a job launched with too few
  processes raises, naming the address, ids and timeout, within the
  timeout instead of hanging.  :func:`fake_world` is the other: torch's
  ``fake`` backend at any world size in one process, for the dry-run
  (``launch/dryrun.py``).
* :func:`put_global` / :func:`replicate` — host data → this rank's shard
  on its device.  Every process builds the same host value from a shared
  seed and keeps only its block of it: ``prepare_bundle`` /
  ``prepare_dp_bundle`` / ``prepare_stream_bundle`` place their node
  arrays so (``mesh=``), so each rank holds V/N rows, as the reference's
  global arrays do.
* :func:`context` — the process topology for accounting:
  ``runtime.mesh`` appends it to device-accounting errors, the launcher
  prints only on :func:`is_coordinator`, and per-process ledgers merge at
  the coordinator (``CommLedger.merge_from`` / ``CommLedger.from_dict``).

Departures from the reference (``repro.runtime.distributed``):

* **One process is one rank on one device.**  A JAX process owns a slice
  of the job's devices; a torch process drives one, so
  ``local_device_count`` is 1 and ``global_device_count`` is the number
  of processes.  The env contract is the reference's and names no local
  rank, so a rank takes card ``process_id % torch.cuda.device_count()``:
  ``cuda:0`` where the scheduler sets ``CUDA_VISIBLE_DEVICES`` per
  process, and one card each for N processes on one N-card machine.
* **The device is explicit.**  :func:`initialize` takes ``device="cuda"``
  (NCCL) by default; the tests pass ``"cpu"`` (gloo).
* **One process still opens a group.**  The engine's collectives need a
  default process group, where JAX on one process needs no distributed
  client: with no coordinator and one process, :func:`initialize` opens
  a one-rank group on a free localhost port.
* **The host's cores are shared.**  Processes that share a machine each
  drive a card and each would start torch's intra-op pool over every core
  the machine has.  :func:`initialize` gives a CUDA rank its share of
  them (:func:`_share_host_threads`), as ``torchrun`` caps
  ``OMP_NUM_THREADS`` for the processes it starts; an ``OMP_NUM_THREADS``
  the launcher set is kept.
* **Placement is a slice, not a global array.**  :func:`put_global`
  returns this rank's block as a plain tensor; the engine's factories
  take it in place of the whole array.

Supported CI topology (no cluster needed): N processes on one machine,
coordinator on localhost::

    COORDINATOR_ADDRESS=127.0.0.1:<port> NUM_PROCESSES=N PROCESS_ID=i \\
        python -m repro_torch.launch.multihost --device cpu

``scripts/launch_multihost_torch.sh`` spawns exactly this.  On a cluster
the same variables point at the rank-0 host, one process per GPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from . import collectives as C

#: Environment contract of the launcher (scripts/launch_multihost_torch.sh
#: and any cluster scheduler export these for every process).
ENV_COORDINATOR = "COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "NUM_PROCESSES"
ENV_PROCESS_ID = "PROCESS_ID"
#: Optional: seconds before a connect attempt gives up (default 60; the
#: failure-mode tests shrink it so "unreachable" fails fast).
ENV_INIT_TIMEOUT = "DIST_INIT_TIMEOUT"
#: Every variable of the contract, for a parent that must not pass them on.
ENV_CONTRACT = (ENV_COORDINATOR, ENV_NUM_PROCESSES, ENV_PROCESS_ID,
                ENV_INIT_TIMEOUT)

_DEFAULT_TIMEOUT = 60.0


@dataclasses.dataclass(frozen=True)
class DistContext:
    """Resolved process topology after :func:`initialize`."""

    coordinator_address: str | None
    num_processes: int
    process_id: int
    local_device_count: int
    global_device_count: int
    device: str = "cuda"

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


_CONTEXT: DistContext | None = None


def env_topology(env=None) -> dict:
    """The launcher env contract as ``initialize`` kwargs (missing keys
    omitted).  ``{}`` means "no multihost env": single-process mode."""
    env = os.environ if env is None else env
    out: dict = {}
    if env.get(ENV_COORDINATOR):
        out["coordinator_address"] = env[ENV_COORDINATOR]
    for key, name in ((ENV_NUM_PROCESSES, "num_processes"),
                      (ENV_PROCESS_ID, "process_id")):
        if env.get(key):
            try:
                out[name] = int(env[key])
            except ValueError:
                raise ValueError(
                    f"environment variable {key}={env[key]!r} must be an "
                    f"integer") from None
    if env.get(ENV_INIT_TIMEOUT):
        try:
            out["timeout"] = float(env[ENV_INIT_TIMEOUT])
        except ValueError:
            raise ValueError(
                f"environment variable {ENV_INIT_TIMEOUT}="
                f"{env[ENV_INIT_TIMEOUT]!r} must be a number of "
                f"seconds") from None
    return out


def _validate(coordinator_address, num_processes, process_id) -> None:
    """Eager topology validation — catches the classic launcher mistakes
    before anything can block on the network."""
    problems = []
    if num_processes < 1:
        problems.append(f"num_processes={num_processes} must be >= 1")
    if not 0 <= process_id < max(num_processes, 1):
        problems.append(
            f"process_id={process_id} out of range for "
            f"num_processes={num_processes} (valid ids: 0.."
            f"{num_processes - 1}) — every process must be launched with "
            f"the same {ENV_NUM_PROCESSES} and a distinct {ENV_PROCESS_ID}")
    if num_processes > 1:
        if not coordinator_address:
            problems.append(
                f"multihost ({num_processes} processes) needs a "
                f"coordinator address — set {ENV_COORDINATOR}=host:port "
                f"(the rank-0 host) on every process")
        else:
            _, _, port = str(coordinator_address).rpartition(":")
            if not port.isdigit():
                problems.append(
                    f"coordinator address {coordinator_address!r} is not "
                    f"host:port")
    if problems:
        raise ValueError("invalid multihost topology: "
                         + "; ".join(problems))


def _await_coordinator(address: str, timeout: float,
                       num_processes: int, process_id: int) -> None:
    """TCP-probe the coordinator before ``init_process_group`` dials it.

    Probing first (with retries up to ``timeout``: the coordinator may
    simply not have bound yet) turns the common launcher mistake into a
    catchable, actionable ``RuntimeError`` naming the address, where the
    store's own connect error names neither the contract nor the fix.
    """
    host, _, port = address.rpartition(":")
    deadline = time.monotonic() + timeout
    last: Exception | None = None
    while True:                      # always probe at least once
        try:
            with socket.create_connection((host, int(port)),
                                          timeout=max(0.5, min(2.0,
                                                               timeout))):
                return
        except OSError as e:
            last = e
            if time.monotonic() >= deadline:
                break
            time.sleep(0.25)
    raise RuntimeError(
        f"coordinator at {address!r} unreachable after {timeout:.0f}s "
        f"(worker {process_id} of {num_processes}): {last}. Check that "
        f"process 0 is running and reachable at that host:port, that "
        f"{ENV_COORDINATOR} is identical on every process, and that "
        f"{ENV_NUM_PROCESSES}/{ENV_PROCESS_ID} describe the actual "
        f"launch ({ENV_INIT_TIMEOUT} raises this timeout).")


def _free_local_address() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _rank_device(device, process_id: int) -> torch.device:
    """This rank's device: for ``"cuda"`` card ``process_id % count``
    (module docstring), made current; an indexed device as given."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", process_id
                               % max(1, torch.cuda.device_count()))
        torch.cuda.set_device(dev)
    return dev


def _share_host_threads(num_processes: int, dev: torch.device) -> None:
    """Set torch's intra-op threads to this process's share of the cores
    it may run on: the ``min(num_processes, cards)`` processes on this
    machine (one a card, :func:`_rank_device`) split them evenly.  Only
    for CUDA ranks of a multi-process job, and only where the launcher set
    no ``OMP_NUM_THREADS``.  Four ranks of a Reddit-sized GCN step on a
    four-card machine are host-bound, and took longer to issue a step
    with every rank's pool over all of its cores."""
    if (dev.type != "cuda" or num_processes < 2
            or os.environ.get("OMP_NUM_THREADS")):
        return
    local = min(num_processes, max(1, torch.cuda.device_count()))
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // local))


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               timeout: float | None = None,
               device="cuda") -> DistContext:
    """Join (or start, as process 0) the job's default process group:
    NCCL on ``device="cuda"``, gloo on ``"cpu"``.  Arguments default to
    the env contract (:func:`env_topology`); with neither, one process
    opens a one-rank group (module docstring).

    Idempotent once initialized (returns the existing context);
    re-initializing with a *different* topology raises, and so does a
    default group the caller opened before.  A job launched with fewer
    processes than ``num_processes`` fails within ``timeout``: the
    rendezvous store raises when it runs out."""
    global _CONTEXT
    envkw = env_topology()
    if coordinator_address is None:
        coordinator_address = envkw.get("coordinator_address")
    if num_processes is None:
        num_processes = envkw.get("num_processes", 1)
    if process_id is None:
        process_id = envkw.get("process_id", 0)
    if timeout is None:
        timeout = envkw.get("timeout", _DEFAULT_TIMEOUT)
    _validate(coordinator_address, num_processes, process_id)

    if _CONTEXT is not None:
        same = (_CONTEXT.coordinator_address, _CONTEXT.num_processes,
                _CONTEXT.process_id) == \
               (coordinator_address, num_processes, process_id)
        if not same:
            raise RuntimeError(
                f"distributed runtime already initialized as process "
                f"{_CONTEXT.process_id}/{_CONTEXT.num_processes} "
                f"(coordinator {_CONTEXT.coordinator_address!r}); cannot "
                f"re-initialize as {process_id}/{num_processes} "
                f"(coordinator {coordinator_address!r})")
        return _CONTEXT
    if dist.is_initialized():
        raise RuntimeError(
            "a default process group is already open in this process — "
            "runtime.distributed.initialize() must be the one call of "
            "init_process_group (it checks the topology and keeps the "
            "context the launcher and the meshes read)")

    dev = _rank_device(device, process_id)
    _share_host_threads(num_processes, dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    address = coordinator_address or _free_local_address()
    if num_processes > 1:
        # preflight, to stderr: put the topology next to any failure
        print(f"[repro_torch.runtime.distributed] process {process_id}/"
              f"{num_processes} connecting to coordinator {address} "
              f"({backend}, timeout {timeout:.0f}s)", file=sys.stderr,
              flush=True)
        if process_id != 0:
            _await_coordinator(address, timeout, num_processes, process_id)
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://{address}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=timeout))
    except Exception as e:  # noqa: BLE001 — re-raise actionable
        role = ("coordinator" if process_id == 0
                else f"worker {process_id}")
        raise RuntimeError(
            f"init_process_group failed for {role} "
            f"(coordinator_address={address!r}, num_processes="
            f"{num_processes}, process_id={process_id}, timeout="
            f"{timeout:.0f}s): {type(e).__name__}: {e}. Check that the "
            f"coordinator host:port is reachable from every process, that "
            f"exactly {num_processes} processes were launched with "
            f"distinct {ENV_PROCESS_ID} values 0..{num_processes - 1}, and "
            f"that all share the same {ENV_NUM_PROCESSES} and "
            f"{ENV_COORDINATOR}.") from e
    if dist.get_world_size() != num_processes:
        raise RuntimeError(
            f"the process group has {dist.get_world_size()} ranks but "
            f"initialize was called with num_processes={num_processes}")
    _CONTEXT = DistContext(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id,
        local_device_count=1, global_device_count=num_processes,
        device=str(dev))
    return _CONTEXT


def shutdown() -> None:
    """Close the group :func:`initialize` opened and forget the context
    (the launcher's exit; a later :func:`initialize` starts afresh)."""
    global _CONTEXT
    if _CONTEXT is not None and dist.is_initialized():
        dist.destroy_process_group()
    _CONTEXT = None


@contextlib.contextmanager
def fake_world(world: int):
    """Torch's ``fake`` process-group backend as the default group of
    ``world`` ranks for the block, this process rank 0 (each collective
    returns at once and moves nothing); destroyed on exit.  Raises where
    the process already has a default group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError(
            "fake_world needs a process without a default process group "
            "(it initialises the fake backend itself): run it in a child "
            "process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def is_initialized() -> bool:
    return _CONTEXT is not None


def _require_initialized_under_multihost_env() -> None:
    """Topology queried before :func:`initialize` in a job whose env
    contract says this IS a multihost process: raise instead of answering
    for a single process (every rank would then think it is the
    coordinator — the duplicate-output hazard the process-0 gating exists
    to prevent)."""
    if env_topology().get("num_processes", 1) > 1:
        raise RuntimeError(
            f"multihost environment ({ENV_NUM_PROCESSES}/"
            f"{ENV_COORDINATOR} are set) but "
            f"runtime.distributed.initialize() has not run in this "
            f"process — call it before any topology or device query "
            f"(or unset {ENV_NUM_PROCESSES}/{ENV_COORDINATOR} if this "
            f"is not a multihost process)")


def context() -> DistContext:
    """The current topology; without :func:`initialize`, that of the
    default group a caller opened itself, or of a single process.  Raises
    if the multihost env contract is set but :func:`initialize` has not
    run."""
    if _CONTEXT is not None:
        return _CONTEXT
    _require_initialized_under_multihost_env()
    world, rank = ((dist.get_world_size(), dist.get_rank())
                   if dist.is_initialized() else (1, 0))
    return DistContext(coordinator_address=None, num_processes=world,
                       process_id=rank, local_device_count=1,
                       global_device_count=world)


def process_count() -> int:
    """Processes in the job; raises like :func:`context` does."""
    return context().num_processes


def is_coordinator() -> bool:
    """True on process 0 (and always on a single process) — the gate for
    anything that must happen once per job: printing result rows, writing
    files."""
    return context().process_id == 0


def topology_note() -> str:
    """Per-process device accounting, appended to mesh errors under
    multihost (``resolve_mesh_shape``'s ``note=``).  Decorative, so it
    never raises: empty before :func:`initialize` and on one process."""
    ctx = _CONTEXT
    if ctx is None or not ctx.is_distributed:
        return ""
    return (f" [multihost: {ctx.num_processes} processes × "
            f"{ctx.local_device_count} local device each = "
            f"{ctx.global_device_count} global devices; this process "
            f"({ctx.process_id}) holds only {ctx.device}]")


# ---------------------------------------------------------------------------
# Per-rank placement of host data
# ---------------------------------------------------------------------------

def _axis_coord(mesh, name: str) -> tuple[int, int]:
    """(index, size) of this rank on mesh axis ``name``."""
    group = mesh.group_of(name)
    return C.axis_index(group), C.axis_size(group)


def shard_slices(shape, mesh, spec) -> tuple:
    """This rank's block of an array of ``shape`` laid out ``spec`` on
    ``mesh``, as one slice per dim.  A dim sharded over several axes takes
    their flattened coordinate, outermost first — for the vertex spec
    ``((model, *data_axes),)`` that is ``core.tp.vertex_block``'s block
    ``m·R + r``; for the DP spec ``(model, data_axes)`` the partition
    index, then the replica block of its rows."""
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    out = []
    for dim, (length, entry) in enumerate(zip(shape, entries)):
        if entry is None:
            out.append(slice(None))
            continue
        idx, count = 0, 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            i, n = _axis_coord(mesh, a)
            idx, count = idx * n + i, count * n
        if length % count:
            raise ValueError(
                f"put_global: dim {dim} of shape {tuple(shape)} does not "
                f"divide the {count} shards of {entry!r} — pad it first "
                f"(runtime.padded_size)")
        block = length // count
        out.append(slice(idx * block, (idx + 1) * block))
    return tuple(out)


def rank_device():
    """The device :func:`initialize` gave this rank; ``"cuda"`` (the
    current card) before it has run."""
    return _CONTEXT.device if _CONTEXT is not None else "cuda"


def put_global(x, mesh, spec, device=None) -> torch.Tensor:
    """This rank's shard of the host value ``x`` (numpy or a tensor) laid
    out ``spec`` on ``mesh``, as a tensor on ``device`` (default: the
    rank's device).  Every process holds the whole host value (the
    bundles are built from a shared seed) and copies only its block to
    the device.  ``spec`` is the constraint backend's vocabulary: one
    entry per dim, ``None``, an axis name or a tuple of names; ``()`` is
    replicated and gives the whole value."""
    device = rank_device() if device is None else device
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    block = x[shard_slices(x.shape, mesh, spec)]
    # a buffer of the block's own size: a view would keep the whole host
    # value alive on a CPU rank
    return torch.empty(block.shape, dtype=block.dtype,
                       device=device).copy_(block)


def replicate(tree, mesh, device=None):
    """Every leaf of ``tree`` (a parameter tree, an optimizer state) whole
    on the rank's device: each process computes the identical host value,
    so replication is a copy, never a collective."""
    from ..params import tree_map
    return tree_map(lambda x: put_global(x, mesh, (), device), tree)
