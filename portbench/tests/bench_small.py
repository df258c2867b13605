"""Small sizes for the CPU tests: every cell at a few rows and short clips,
the widths as published."""

from __future__ import annotations

SMALL_CONFIG = {"batch_size": 8, "window_t": 64}
SMALL_TRAFFIC = {
    "gan_train": {"train_batches": 3, "val_batches": 1},
    "lift_enhance": {"clips_per_partition": 10, "partitions": 2, "n_cycles": 30,
                     "length_max": 200, "batch": 8, "sample_clips": 4},
    "enhance": {"requests": 6, "clips_per_request": [2, 4], "sample_requests": 3},
}
CELLS = ("v1_arm2wh.train", "v1_arm2wh.lift_enhance", "v2_text_finger1_robust.train",
         "v2_text_finger1_robust.enhance")


def small(cfg, traffic):
    return {**cfg, **SMALL_CONFIG}, {**traffic, **SMALL_TRAFFIC[traffic["generator"]]}
