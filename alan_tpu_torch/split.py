"""Computation strategies: ``no_checkpoint``, ``checkpoint`` and ``Split``
(counterpart of ``alan_tpu/split.py``).

``no_checkpoint`` evaluates every plate in one piece.  ``checkpoint``
evaluates the outermost plate body under ``torch.utils.checkpoint`` and the
plates inside it plainly: its forward keeps nothing for the backward pass,
which recomputes it once (``logpq.logPQ_plate``).  ``Split(platename, split_size)`` evaluates one
plate in chunks of ``split_size`` along it (the last chunk holds the
remainder) and adds the chunks' plate sums, to bound peak memory; the
result is the unsplit one up to the order of the sums.  Where a gradient is
wanted each chunk runs under ``torch.utils.checkpoint`` too: in eager
PyTorch every chunk's saved tensors would otherwise live together until the
backward pass.
"""
from __future__ import annotations

from .dims import dims_of, slice_dim


class NoSplit:
    def split_args(self, name, sample, inputs_params, extra_log_factors, data,
                   all_platedims):
        return [{
            "sample": sample,
            "inputs_params": inputs_params,
            "extra_log_factors": extra_log_factors,
            "data": data,
            "all_platedims": all_platedims,
        }]


class NoCheckpoint(NoSplit):
    pass


no_checkpoint = NoCheckpoint()


class Checkpoint(NoSplit):
    pass


checkpoint = Checkpoint()


class Split:
    """Chunk the computation along one plate.  ``split_size`` is the size of
    each chunk, not the number of chunks, so a model that fits in memory
    keeps fitting when the data grows."""

    def __init__(self, platename: str, split_size: int):
        assert isinstance(platename, str)
        assert isinstance(split_size, int)
        self.platename = platename
        self.split_size = split_size

    def _split_bounds(self, size: int):
        assert size > self.split_size, \
            f"Split size {self.split_size} >= plate size {size}"
        bounds = []
        start = 0
        while start < size:
            stop = min(start + self.split_size, size)
            bounds.append((start, stop))
            start = stop
        return bounds

    def _split_tree(self, tree: dict, bounds):
        results = [dict() for _ in bounds]
        for k, v in tree.items():
            if isinstance(v, dict):
                for r, s in zip(results, self._split_tree(v, bounds)):
                    r[k] = s
            elif v is not None and self.platename in dims_of(v):
                for r, (a, b) in zip(results, bounds):
                    r[k] = slice_dim(v, self.platename, a, b)
            else:
                for r in results:
                    r[k] = v
        return results

    def split_args(self, name, sample, inputs_params, extra_log_factors, data,
                   all_platedims):
        if self.platename != name:
            return NoSplit.split_args(self, name, sample, inputs_params,
                                      extra_log_factors, data, all_platedims)
        bounds = self._split_bounds(all_platedims[self.platename])
        trees = [self._split_tree(t, bounds)
                 for t in (sample, inputs_params, extra_log_factors, data)]
        return [
            {"sample": s, "inputs_params": i, "extra_log_factors": e,
             "data": d, "all_platedims": {**all_platedims, self.platename: b - a}}
            for s, i, e, d, (a, b) in zip(*trees, bounds)
        ]
