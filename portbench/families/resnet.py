"""ResNet's pieces for the drivers: the program's model config and
gradient, the reference's loss, the inputs, and one worker batch on meta
tensors for the FLOP count."""
from __future__ import annotations

import torch

from portbench.reference import resnet as ref
from portbench.yardstick.inputs import image_batches


def port_config(cfg: dict, traffic: dict):
    from repro_torch.models.resnet import ResNetConfig

    return ResNetConfig(name=cfg["name"], blocks=tuple(cfg["blocks"]),
                        widths=tuple(cfg["widths"]),
                        n_classes=cfg["n_classes"], groups=cfg["groups"])


def param_spec(cfg: dict, traffic: dict) -> dict:
    return ref.param_spec(cfg)


def batches(cfg: dict, traffic: dict, seed: int, device) -> list:
    """``workers`` lists of ``batches`` batches of ``batch`` images."""
    return image_batches(seed, traffic["workers"], traffic["batches"],
                         traffic["batch"], traffic["img"], cfg["n_classes"],
                         device)


def samples(batch: dict) -> int:
    return batch["labels"].shape[0]


def port_grad(cfg: dict, traffic: dict):
    """The program's worker compute: (loss, gradient tree) of its
    ``models/resnet.loss_fn`` at a parameter tree."""
    from repro_torch.models import resnet as RN

    pcfg = port_config(cfg, traffic)

    def grad(params: dict, batch: dict):
        names, leaves = _flat(params)
        tracked = [t.detach().requires_grad_(True) for t in leaves]
        loss, _ = RN.loss_fn(_tree(names, tracked), batch, pcfg)
        grads = torch.autograd.grad(loss, tracked)
        return loss.detach(), _tree(names, grads)

    return grad


def ref_loss(cfg: dict, traffic: dict):
    return lambda params, batch: ref.loss(params, batch, cfg)


def meta_batch(cfg: dict, traffic: dict) -> dict:
    b, img = traffic["batch"], traffic["img"]
    return {"images": torch.empty((b, img, img, 3), device="meta"),
            "labels": torch.empty((b,), dtype=torch.int64, device="meta")}


def _flat(tree: dict, path: tuple = ()):
    names, leaves = [], []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            n, v = _flat(tree[k], path + (k,))
            names += n
            leaves += v
        else:
            names.append(path + (k,))
            leaves.append(tree[k])
    return names, leaves


def _tree(names, leaves) -> dict:
    out: dict = {}
    for path, leaf in zip(names, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


meta_loss = ref_loss
