"""The PHub loop: K workers against a chunk-sharded ``PBoxFabric``, driven
by the program's ``WorkerHarness`` in synchronous mode.

One round is ``WorkerHarness.run`` advanced by one step: each worker
pulls the flat parameters, unflattens them, computes its loss and
gradient on its next batch, flattens the gradient and pushes it (through
the wire codec); the last push fires the shards' aggregate and optimizer
update.  Worker ``w`` takes its batches in turn, ``batches[w][s %
len]`` at its step ``s``.
"""
from __future__ import annotations

import contextlib

import torch

from portbench.drivers.common import (
    grad_from_state,
    optimizer_spec,
    ranged,
    wrap_attr,
)
from portbench.yardstick.costs import update_bytes
from portbench.yardstick.inputs import make_params


class System:
    def __init__(self, family, cfg: dict, traffic: dict, seed: int, device):
        from repro_torch.core.chunking import ParamSpace
        from repro_torch.core.compression import CompressionConfig
        from repro_torch.core.config import FabricConfig, WireConfig
        from repro_torch.core.fabric import PBoxFabric, WorkerHarness

        self.opt = traffic["optimizer"]
        self.workers = traffic["workers"]
        params = make_params(family.param_spec(cfg, traffic), seed, device)
        self.space = ParamSpace.build(params, chunk_elems=traffic["chunk_elems"])
        wire = WireConfig(compression=CompressionConfig(codec=traffic["codec"]))
        self.fab = PBoxFabric(
            self.space, optimizer_spec(self.opt), self.space.flatten(params),
            device=device, config=FabricConfig(
                num_shards=traffic["shards"], num_workers=self.workers,
                mode="sync", wire=wire))
        self.params = self.space.payload_elems
        del params
        self.batches = family.batches(cfg, traffic, seed, device)
        self.samples_per_round = sum(family.samples(b[0])
                                     for b in self.batches)
        self.losses: list | None = None
        self.bad = torch.zeros((), dtype=torch.int32, device=device)
        grad = family.port_grad(cfg, traffic)

        def grad_fn(params, ws):
            w, s = ws
            batch = self.batches[w][s % len(self.batches[w])]
            with ranged("pb.fwd_bwd", self.tracing):
                loss, g = grad(params, batch)
            self.bad += (~torch.isfinite(loss)).int()
            if self.losses is not None:
                self.losses[-1].append(loss)
            return g

        self.harness = WorkerHarness(self.fab, grad_fn, lambda w, s: (w, s))
        self.rounds = 0
        self.tracing = False
        self.update_bytes = update_bytes(
            self.params, self.workers, self.opt["name"], traffic["codec"],
            traffic["chunk_elems"])

    def round(self) -> None:
        self.rounds += 1
        self.harness.run(self.rounds)

    def first_steps(self, steps: int) -> dict:
        """The first ``steps`` rounds, and what they produced: each round's
        losses, the gradient the optimizer got in round 1 (from its state)
        and the parameters after the last round, on the host."""
        self.losses = []
        first_grad = None
        for s in range(steps):
            self.losses.append([])
            self.round()
            if s == 0:
                state = self.fab.snapshot()["state"]
                first_grad = self.space.unflatten(grad_from_state(
                    self.opt, torch.from_numpy(state[0])))
        params = torch.from_numpy(self.fab.snapshot()["params"])
        losses = [[float(x) for x in row] for row in self.losses]
        self.losses = None
        return {"losses": losses, "first_grad": first_grad,
                "params": self.space.unflatten(params)}

    def counters(self) -> dict:
        s = self.fab.stats
        return {"bytes_pushed": s.bytes_pushed, "bytes_pulled": s.bytes_pulled}

    @contextlib.contextmanager
    def instrumented(self):
        """Ranges around the program's own calls into each layer: the
        fabric's pull and push, the space's flatten and unflatten (the
        exchange), and each shard's update (inside the push that fires
        it)."""
        with contextlib.ExitStack() as stack:
            for attr in ("pull", "push"):
                stack.enter_context(wrap_attr(self.fab, attr, "pb.exchange"))
            for attr in ("flatten", "unflatten"):
                stack.enter_context(wrap_attr(self.space, attr,
                                              "pb.exchange"))
            for shard in self.fab.shards:
                for attr in ("apply", "apply_wire"):
                    stack.enter_context(wrap_attr(shard, attr,
                                                  "pb.ps_update"))
            self.tracing = True
            try:
                yield
            finally:
                self.tracing = False

    def close(self) -> None:
        del self.harness, self.fab, self.batches
