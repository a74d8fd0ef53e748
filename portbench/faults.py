"""Faults planted in the program under the timed path, each a context
manager: the check has to come out false under every one that a cell
can have (``tests/test_portbench_faults.py`` on the CPU;
``calibrate.py`` reads them on the card at the cell's own size).

``unchanged_state``  every server update returns the parameters and the
                     optimizer state as they were;
``half_batch``       each worker's loss is the mean over the first half of
                     its batch (images, or molecules by their mask);
``push_left_out``    the fabric aggregates every round without the last
                     worker's push (the exchange between workers left
                     out for one of them), the mean taken over the rest.
"""
from __future__ import annotations

import contextlib
from unittest import mock


@contextlib.contextmanager
def unchanged_state():
    from repro_torch.core import exchange, fabric

    def same(rows, param, state, *args, **kwargs):
        return param, tuple(state)

    def same_wire(payload, scales, param, state, *args, **kwargs):
        return param, tuple(state)

    with mock.patch.object(fabric, "fused_aggregate_update", same), \
            mock.patch.object(fabric, "fused_wire_update", same_wire), \
            mock.patch.object(exchange, "fused_aggregate_update", same):
        yield


@contextlib.contextmanager
def half_batch():
    from repro_torch.models import resnet
    from repro_torch.models.gnn import equiformer_v2

    rn_loss, eq_loss = resnet.loss_fn, equiformer_v2.loss_fn

    def rn_half(params, batch, cfg, *args, **kwargs):
        n = batch["labels"].shape[0] // 2
        return rn_loss(params, {k: v[:n] for k, v in batch.items()}, cfg,
                       *args, **kwargs)

    def eq_half(params, graph, cfg, *args, **kwargs):
        mask = graph["graph_mask"].clone()
        mask[mask.shape[0] // 2:] = 0
        return eq_loss(params, {**graph, "graph_mask": mask}, cfg, *args,
                       **kwargs)

    with mock.patch.object(resnet, "loss_fn", rn_half), \
            mock.patch.object(equiformer_v2, "loss_fn", eq_half):
        yield


@contextlib.contextmanager
def push_left_out():
    from repro_torch.core.fabric import PBoxFabric

    real = PBoxFabric._aggregate

    def aggregate(self):
        self._inbox.pop(max(self._inbox))
        return real(self)

    with mock.patch.object(PBoxFabric, "_aggregate", aggregate):
        yield


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "push_left_out": push_left_out}
# the faults each driver's cells can have
FAULTS_OF = {"phub": ("unchanged_state", "half_batch", "push_left_out"),
             "spmd": ("unchanged_state", "half_batch")}
