"""The four LM shape cells (as in ``repro/configs/lm_shapes.py``)."""
from repro_torch.configs.registry import ShapeCell

FULL_ATTN_SKIP = (
    "long_500k needs sub-quadratic attention; this arch is pure full "
    "attention (every layer holds a 512k KV cache and prefill is O(S^2))"
)


def lm_cells(long_ok: bool) -> tuple:
    return (
        ShapeCell("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
        ShapeCell("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
        ShapeCell("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
        ShapeCell(
            "long_500k",
            "decode_long",
            {"seq_len": 524288, "global_batch": 1},
            skip_reason=None if long_ok else FULL_ATTN_SKIP,
        ),
    )
