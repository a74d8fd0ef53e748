"""The four recsys shape cells (shared by the four recsys archs; copy of
``repro/configs/recsys_shapes.py``)."""
from repro_torch.configs.registry import ShapeCell


def recsys_cells(has_history: bool) -> tuple:
    return (
        ShapeCell("train_batch", "train", {"batch": 65536}),
        ShapeCell("serve_p99", "serve", {"batch": 512}),
        ShapeCell("serve_bulk", "serve", {"batch": 262144}),
        ShapeCell(
            "retrieval_cand",
            "retrieval",
            # 1M candidates padded to 1048576 = 2048 x 512 devices
            {"batch": 1, "n_candidates": 1048576},
        ),
    )
