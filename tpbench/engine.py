"""One rank of a cell: the system under test driven as its users train.

Set-up makes the graph and the weights from the seed on the device,
hands the program the graph in its own format, builds its training step
(``repro_torch.core.decouple.make_tp_train_fns``, the default aggregation
backend) and drives that one step object through its first steps, whose
losses, first gradient and change of the parameters are kept for the
comparison.  The same object then trains in the measured window, a closed
loop of full-graph steps.  After the window, the program's state is freed
and the plain reference follows the first steps from the same inputs.

Imports of the program happen inside the functions, so that the harness's
own modules import without it.
"""
from __future__ import annotations

import gc
import math
import statistics
import sys
import time

import torch

from . import compare, faults, graphgen, trace
from .reference import gnn as ref_gnn

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that a run may not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _graph_data(raw: dict, g: dict):
    """The program's ``GraphData`` on the host from the device's raw draws
    and normalised graph."""
    from repro_torch.graph.format import Graph
    from repro_torch.graph.synthetic import GraphData

    host = {k: v.cpu().numpy() for k, v in g.items()}
    return GraphData(
        graph=Graph(n=raw["n"], src=host["src"], dst=host["dst"],
                    weight=host["weight"], indptr=host["indptr"]),
        features=raw["features"].cpu().numpy(),
        labels=raw["labels"].int().cpu().numpy(),
        train_mask=raw["train"].cpu().numpy(),
        val_mask=raw["val"].cpu().numpy(),
        test_mask=raw["test"].cpu().numpy(),
        num_classes=raw["num_classes"])


class Program:
    """The program's training step with its model and optimizer state,
    built and driven through its first ``check_steps`` steps."""

    def __init__(self, cell: dict, seed: int, device, fault=None):
        from repro_torch.core import decouple as D
        from repro_torch.optim.adamw import adamw
        from repro_torch.runtime.mesh import TPMesh

        conf, traffic = cell["config"], cell["traffic"]
        model, opt = conf["model"], conf["optimizer"]
        self.device, self.world = device, traffic["tp_degree"]
        self.mesh = TPMesh()
        if self.mesh.size != self.world:
            raise RuntimeError(f"the process group has {self.mesh.size} "
                               f"ranks, the cell asks for {self.world}")
        raw = graphgen.draw_graph(conf["graph"], seed, device)
        g = graphgen.normalize(raw["src"], raw["dst"], raw["n"])
        self.n, self.e = raw["n"], int(g["src"].numel())
        if self.world > 1:
            _check_same_graph(graphgen.checksum(
                [g["src"], g["dst"], g["weight"], raw["features"],
                 raw["labels"], raw["train"]]), device)
        data = _graph_data(raw, g)
        del raw, g
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)

        t = time.perf_counter()
        if self.world == 1:
            bundle = D.prepare_bundle(data, n_workers=1,
                                      n_chunks=traffic["n_chunks"],
                                      device=device)
        else:
            bundle = D.prepare_bundle(data, n_chunks=traffic["n_chunks"],
                                      mesh=self.mesh, device=device)
        _sync(device)
        self.prepare_s = time.perf_counter() - t
        self.cfg = D.padded_gnn_config(
            data, bundle, model=model["model"],
            hidden_dim=model["hidden_dim"], num_layers=model["num_layers"],
            decoupled=True, gamma=model["gamma"])
        del data
        self.dims = ([self.cfg.in_dim]
                     + [self.cfg.hidden_dim] * (self.cfg.num_layers - 1)
                     + [self.cfg.num_classes])
        self.params0 = graphgen.init_weights(model["model"], self.dims,
                                             seed, device)
        if fault is not None:
            bundle = faults.plant_input(fault, bundle)
        self.optimizer = adamw(opt["lr"], b1=opt["b1"], b2=opt["b2"],
                               eps=opt["eps"],
                               weight_decay=opt["weight_decay"])
        self.train_step, _ = D.make_tp_train_fns(
            self.cfg, bundle, self.mesh, self.optimizer,
            mode=traffic["mode"])
        if fault is not None:
            self.train_step = faults.plant_step(fault, self.train_step)
        self.bundle = bundle
        self.params = {"layers": [{k: v.clone() for k, v in layer.items()}
                                  for layer in self.params0["layers"]]}
        self.state = self.optimizer.init(self.params)
        self.first = self._first_steps(traffic["check_steps"], opt["b1"])

    def step(self) -> float:
        self.params, self.state, loss = self.train_step(self.params,
                                                        self.state)
        _sync(self.device)
        return float(loss)

    def _first_steps(self, steps: int, b1: float) -> dict:
        """Drive ``steps`` steps; keep each loss, the first gradient as
        AdamW got it, and the parameters' change over them."""
        losses, grad1 = [], None
        for _ in range(steps):
            losses.append(self.step())
            if grad1 is None:
                grad1 = {k: v / (1 - b1) for k, v in
                         compare.flatten(self.state.mu).items()}
        p0, p = compare.flatten(self.params0), compare.flatten(self.params)
        return {"losses": losses, "grad1": grad1,
                "delta": {k: p[k] - p0[k] for k in p0}}

    def free(self) -> dict:
        """Drop the program's state; return the initial weights, which
        the reference takes."""
        params0 = compare.flatten(self.params0)
        del self.bundle, self.train_step, self.params, self.state
        faults.clear()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return params0


def reference(cell: dict, seed: int, device, params0: dict, *,
              tf32: bool = False, half_batch: bool = False) -> dict:
    """The plain reference's first steps on the inputs of ``seed``."""
    conf, traffic = cell["config"], cell["traffic"]
    raw = graphgen.draw_graph(conf["graph"], seed, device)
    graph = ref_gnn.normalize(raw["src"], raw["dst"], raw["n"])
    mask = raw["train"]
    if half_batch:
        mask = faults.half(mask)
    model = dict(conf["model"], num_classes=raw["num_classes"])
    return ref_gnn.train(params0, model, conf["optimizer"],
                         raw["features"], raw["labels"], mask, graph,
                         traffic["check_steps"], tf32=tf32)


def _agree(flag: bool, device, world: int) -> bool:
    """Rank 0's ``flag`` on every rank."""
    if world == 1:
        return flag
    import torch.distributed as dist
    t = torch.tensor([int(flag)], device=device)
    dist.broadcast(t, src=0)
    return bool(t.item())


def _barrier(device, world: int):
    if world > 1:
        _agree(True, device, world)


def window(prog: Program, seconds: float) -> dict:
    """Closed-loop steps until ``seconds`` have passed on rank 0's clock:
    the window's wall time over the steps completed in it."""
    times, failed = [], 0
    _barrier(prog.device, prog.world)
    start = last = time.perf_counter()
    while True:
        loss = prog.step()
        now = time.perf_counter()
        times.append(now - last)
        last = now
        failed += not math.isfinite(loss)
        if _agree(now - start >= seconds, prog.device, prog.world):
            break
    q = statistics.quantiles(times, n=20) if len(times) > 1 else times * 19
    return {"window_s": last - start, "steps": len(times), "failed": failed,
            "step_ms": (last - start) / len(times) * 1e3,
            "step_p50_ms": statistics.median(times) * 1e3,
            "step_p95_ms": q[-1] * 1e3}


def traced(prog: Program, steps: int) -> dict:
    """One step's collective ledger, then ``steps`` steps profiled, the
    ranks starting them together."""
    from repro_torch.runtime import telemetry as T
    with T.collect_comm() as ledger:
        prog.step()
    _barrier(prog.device, prog.world)
    out = trace.profile_steps(prog.step, steps,
                              lambda: _sync(prog.device))
    out["wire_bytes"] = ledger.wire_bytes(train=True)
    return out


def _check_same_graph(checksum: float, device):
    """Every rank holds the same graph: the ranks' checksums agree."""
    import torch.distributed as dist
    t = torch.tensor([checksum, -checksum], dtype=torch.float64,
                     device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    if float(t[0]) != -float(t[1]):
        raise RuntimeError(f"the ranks built different graphs: checksums "
                           f"from {-float(t[1])} to {float(t[0])}")


def run_rank(cell: dict, seed: int, seconds: float, trace_on: bool,
             t0: float, device="cuda", fault=None) -> dict:
    """One rank's run of ``cell``: set-up, the window, the traced steps
    where ``trace_on``, then the reference and the comparison.
    ``t0`` is the run's start on the host clock (``time.time()``)."""
    from repro_torch.runtime import distributed as RD

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(RD.initialize(device=device).device)
    try:
        prog = Program(cell, seed, device, fault)
        for _ in range(cell["traffic"]["warmup_steps"]):
            prog.step()
        _barrier(device, prog.world)
        setup_s = time.time() - t0
        out = window(prog, seconds)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        tr = traced(prog, cell["traffic"]["trace_steps"]) \
            if trace_on else None
        bad = forbidden_modules()
        first = prog.first
        shapes = {"model": cell["config"]["model"]["model"], "n": prog.n,
                  "e": prog.e, "dims": prog.dims, "world": prog.world,
                  "rounds": prog.cfg.num_layers}
        prepare_s = prog.prepare_s
        params0 = prog.free()
        _barrier(device, prog.world)
    finally:
        RD.shutdown()
    ref = reference(cell, seed, device, params0)
    values = compare.readings(first, ref)
    correct, checks = compare.verdict(values, cell["limits"])
    return dict(out, setup_s=setup_s, peak_bytes=peak, trace=tr,
                prepare_s=prepare_s, shapes=shapes, correct=correct,
                checks=checks, forbidden=bad)
