"""The SPMD parameter-server step: the plan ``launch/steps`` builds for the
cell, the step ``launch/train.py`` runs, in a world of one rank (NCCL on
the card, gloo on the CPU).

One round is one call of the plan's ``fn``: the forward and backward on
the rank's batch, then ``PSExchange.device_update`` (the push, the owned
slab's fused optimizer update and the pull).  The batches are taken in
turn.
"""
from __future__ import annotations

import contextlib
import shutil
import tempfile

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
        import torch.distributed as dist

        from repro_torch.launch.mesh import init_process_group, make_mesh
        from repro_torch.launch.steps import make_exchange
        from repro_torch.runtime.trainer import init_train_state, local_state

        self.opt = traffic["optimizer"]
        self.workers = 1
        self._dir = tempfile.mkdtemp(prefix="portbench_")
        init_process_group(device, init_method=f"file://{self._dir}/rdv")
        self._dist = dist
        mesh = make_mesh((1, 1), ("data", "model"))
        self.ex = make_exchange(mesh, "gnn", traffic["strategy"],
                                optimizer_spec(self.opt))
        self.plan = family.port_plan(cfg, traffic, mesh, self.ex)
        self.space = self.plan.meta["space"]
        params = make_params(family.param_spec(cfg, traffic), seed, device)
        self.params = sum(t.numel() for t in _leaves(params))
        state = init_train_state(
            mesh, init_params_fn=lambda _: params, exchange=self.ex,
            space=self.space, n_groups=1, key=None, device=device)
        del params
        self.state = list(local_state(state, mesh, self.ex))
        del state
        self.batches = family.batches(cfg, traffic, seed, device)[0]
        self.samples_per_round = family.samples(self.batches[0])
        self.bad = torch.zeros((), dtype=torch.int32, device=device)
        self.rounds = 0
        self.tracing = False
        self.update_bytes = update_bytes(self.params, 1, self.opt["name"],
                                         "none", traffic["chunk_elems"])

    def round(self) -> torch.Tensor:
        batch = self.batches[self.rounds % len(self.batches)]
        self.rounds += 1
        with ranged("pb.fwd_bwd", self.tracing):
            *state, met = self.plan.fn(*self.state, batch)
        self.state = state
        self.bad += (~torch.isfinite(met["loss"])).int()
        return met["loss"]

    def first_steps(self, steps: int) -> dict:
        losses, first_grad = [], None
        for s in range(steps):
            losses.append([self.round()])
            if s == 0:
                m = self.state[1][0].reshape(-1).cpu()
                first_grad = self.space.unflatten(grad_from_state(self.opt, m))
        params = self.state[0].reshape(-1).cpu()
        return {"losses": [[float(x) for x in row] for row in losses],
                "first_grad": first_grad,
                "params": self.space.unflatten(params)}

    def counters(self) -> dict:
        return {}

    @contextlib.contextmanager
    def instrumented(self):
        """Ranges around the exchange (``device_update``) and, inside it,
        the owned slab's optimizer update."""
        from repro_torch.core import exchange

        with wrap_attr(self.ex, "device_update", "pb.exchange"), \
                wrap_attr(exchange, "fused_aggregate_update", "pb.ps_update"):
            self.tracing = True
            try:
                yield
            finally:
                self.tracing = False

    def close(self) -> None:
        del self.state, self.batches, self.plan
        self._dist.destroy_process_group()
        shutil.rmtree(self._dir, ignore_errors=True)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v
