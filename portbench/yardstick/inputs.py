"""Inputs made from the run's seed: weights and images on the device.

Both sides of a run, the program and the plain reference, get what these
functions return for the same seed, so each is made here and nowhere
else.  A seed is any whole number; each use draws from a stream of its
own (``derive``), so the weights do not change when the images do.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of the run seed ``seed``."""
    words = [int(b) for b in tag.encode()]
    state = np.random.SeedSequence([seed % 2**64, *words]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def leaves(tree: dict, path: tuple = ()) -> list:
    """(key path, leaf) pairs, a dict's keys sorted, depth first."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out += leaves(value, path + (key,))
        else:
            out.append((path + (key,), value))
    return out


def build_tree(pairs) -> dict:
    tree: dict = {}
    for path, leaf in pairs:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def make_params(spec: dict, seed: int, device, dtype=torch.float32) -> dict:
    """A parameter tree from ``spec``, whose leaves are ``("normal", shape,
    fan_in)``, ``("ones", shape)`` or ``("zeros", shape)``: one normal
    draw on ``device`` for every normal leaf, each scaled by
    ``1 / sqrt(fan_in)``, in ``dtype``."""
    items = leaves(spec)
    if torch.device(device).type == "meta":
        return build_tree((p, torch.empty(s[1], dtype=dtype, device="meta"))
                          for p, s in items)
    normal = [(p, s) for p, s in items if s[0] == "normal"]
    sizes = [math.prod(s[1]) for _, s in normal]
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    std = torch.repeat_interleave(
        torch.tensor([1.0 / math.sqrt(s[2]) for _, s in normal],
                     dtype=torch.float32, device=device),
        torch.tensor(sizes, device=device))
    flat = (flat * std).to(dtype)
    drawn = dict(zip((p for p, _ in normal),
                     (t.view(s[1]) for t, (_, s) in
                      zip(torch.split(flat, sizes), normal))))
    out = []
    for path, s in items:
        if s[0] == "normal":
            out.append((path, drawn[path]))
        elif s[0] == "ones":
            out.append((path, torch.ones(s[1], dtype=dtype, device=device)))
        elif s[0] == "zeros":
            out.append((path, torch.zeros(s[1], dtype=dtype, device=device)))
        else:
            raise ValueError(f"unknown leaf kind {s[0]!r} at {path}")
    return build_tree(out)


def image_batches(seed: int, workers: int, batches: int, batch: int,
                  img: int, n_classes: int, device) -> list:
    """``workers`` lists of ``batches`` NHWC f32 image batches with int64
    labels, drawn on ``device`` in one call each: normal pixels plus a
    class-dependent mean (a copy of the planted signal of
    ``src/repro_torch/data/synthetic.py``'s ``image_batches``)."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, "images"))
    n = workers * batches * batch
    labels = torch.randint(0, n_classes, (n,), generator=gen, device=device)
    images = torch.randn((n, img, img, 3), generator=gen, device=device)
    images += (labels.float() / n_classes)[:, None, None, None]
    images = images.view(workers, batches, batch, img, img, 3)
    labels = labels.view(workers, batches, batch)
    return [[{"images": images[w, i], "labels": labels[w, i]}
             for i in range(batches)] for w in range(workers)]
