"""Problem: the (P, Q, data) triple on one device (counterpart of
``alan_tpu/problem.py``)."""
from __future__ import annotations

from .dims import DT, as_dt, dims_of
from .bound import BoundPlate
from .ir.plate import tensordict2tree
from .ir.checking import check_PQ_plate, check_inputs_params
from .sampler import PermutationSampler
from .sample import Sample
from .utils import resolve_device


class Problem:
    def __init__(self, P: BoundPlate, Q: BoundPlate, data: dict, device="cuda"):
        if not isinstance(P, BoundPlate) or not isinstance(Q, BoundPlate):
            raise Exception(
                "P and Q must be BoundPlates, not e.g. Plates. Convert with "
                "BoundPlate(plate, all_platesizes).")
        self.device = resolve_device(device)
        if P.device != self.device or Q.device != self.device:
            raise ValueError(f"P ({P.device}) and Q ({Q.device}) must be bound "
                             f"to the problem's device {self.device}")
        self.P = P
        self.Q = Q

        if P.all_platesizes != Q.all_platesizes:
            raise Exception(
                f"all_platesizes mismatch between P ({P.all_platesizes}) "
                f"and Q ({Q.all_platesizes})")
        self.all_platedims = dict(P.all_platesizes)

        self._data = {}
        for k, v in data.items():
            v = as_dt(v)
            self._data[k] = DT(v.data.to(self.device), v.dims)
            for d in dims_of(v):
                if d in self.all_platedims and v.dim_size(d) != self.all_platedims[d]:
                    raise Exception(
                        f"data {k} has size {v.dim_size(d)} along plate {d}, "
                        f"expected {self.all_platedims[d]}")

        check_PQ_plate(None, P.plate, Q.plate, self.data)
        check_inputs_params(P, Q)

    @property
    def data(self):
        return tensordict2tree(self.P.plate, dict(self._data))

    def sample(self, K: int, generator, reparam: bool = False,
               sampler=PermutationSampler) -> Sample:
        """Draw K particles per latent from Q with ``generator``."""
        sample, groupvarname2Kdim = self.Q._sample(K, reparam, sampler,
                                                   self.all_platedims, generator)
        return Sample(problem=self, sample=sample,
                      groupvarname2Kdim=groupvarname2Kdim,
                      sampler=sampler, reparam=reparam)

    def inputs_params(self, stateP=None, stateQ=None):
        flat = {**self.P.inputs_params_flat_named(stateP),
                **self.Q.inputs_params_flat_named(stateQ)}
        return tensordict2tree(self.P.plate, flat)
