"""Computation strategy (counterpart of ``alan_tpu/split.py``; this slice
ports ``no_checkpoint``, which evaluates every plate in one piece)."""
from __future__ import annotations


class NoCheckpoint:
    def split_args(self, name, sample, inputs_params, extra_log_factors, data,
                   all_platedims):
        return [{
            "sample": sample,
            "inputs_params": inputs_params,
            "extra_log_factors": extra_log_factors,
            "data": data,
            "all_platedims": all_platedims,
        }]


no_checkpoint = NoCheckpoint()
