"""Batched LM serving: prefill a prompt batch, then greedy-decode with the
sequence-sharded KV cache, 2-way tensor parallel; torch counterpart of
``examples/serve_lm.py``.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm

runs ``repro_torch.launch.serve`` with the JAX example's arguments
(gemma3-1b SMOKE, ``--mesh 1x2``, 4 prompts of 16 tokens, 12 tokens
generated) on 2 ranks: started here under ``torchrun --nproc-per-node 2``
(one card a rank), or, when ``main`` is called inside a process group of
2 ranks (``torchrun``'s, or one its caller started, e.g. gloo ranks with
``device="cpu"``), in that group.  Arguments given are appended to the
example's, so a later one overrides (``--mesh 1x1`` serves on one rank).
"""
from __future__ import annotations

import sys

from repro_torch.examples import has_ranks, torchrun

ARGV = ["--arch", "gemma3-1b", "--mesh", "1x2", "--batch", "4",
        "--prompt-len", "16", "--tokens", "12"]


def main(argv=None, *, device=None, params=None) -> dict:
    """Serve with ``ARGV + argv``; ``params`` (the init seeded 0 unless
    given) are the global tree.  Inside a group (or for a one-rank
    ``--mesh``) returns ``launch.serve.main``'s dict (the generated ids,
    the read's provenance, the timings); as the launcher of its own
    ranks, an empty dict."""
    from repro_torch.launch import serve

    argv = ARGV + list(argv or [])
    d, m = (int(x) for x in serve.build_argparser().parse_args(argv)
            .mesh.split("x"))
    if d * m > 1 and not has_ranks():
        torchrun(__name__, d * m, list(argv[len(ARGV):]), device)
        return {}
    return serve.main(argv, device=device, params=params)


if __name__ == "__main__":
    main(sys.argv[1:])
