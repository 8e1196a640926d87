"""Benchmark split definitions for the ASIMoW dataset.

Own copy of vq_vae_transformer_arc_welding_tpu/data/splits.py. The
(experiment, welding_run) validation/test assignment is dataset
metadata fixed by the reference benchmark (dataloader/utils.py:46-68);
reproducing the exact tuples is required for comparable F1.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataSplitId:
    """Selects one welding run of one experiment for val/test
    (reference dataloader/asimow_dataloader.py:15-25)."""
    experiment: int
    welding_run: int

    def __repr__(self):
        return (f"DataSplit(self.experiment={self.experiment}, "
                f"self.welding_run={self.welding_run})")


def get_val_test_ids() -> dict:
    return {
        "test_ids": ((3, 32), (3, 18), (1, 27), (3, 19),
                     (3, 17), (2, 21), (1, 20), (1, 11)),
        "val_ids": ((3, 3), (2, 10), (1, 24), (3, 24),
                    (1, 32), (2, 1), (1, 10), (1, 16)),
    }


def select_random_val_test_ids(rng=None):
    """Random good/bad run picks for ad-hoc splits (parity:
    dataloader/utils.py:100-107)."""
    rng = rng or np.random.default_rng()
    good_examples = [2, 3, 22, 24, 26, 27, 28]
    bad_examples = [16, 5, 7, 8, 9, 10, 11, 13, 14, 15, 20, 21, 23, 30,
                    31, 32]
    good_val_id, good_test_id = rng.choice(good_examples, 2, replace=False)
    bad_val_id, bad_test_id = rng.choice(bad_examples, 2, replace=False)
    return good_val_id, bad_val_id, good_test_id, bad_test_id
