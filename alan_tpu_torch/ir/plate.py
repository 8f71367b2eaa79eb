"""The program tree: ``Plate`` (counterpart of ``alan_tpu/ir/plate.py``).

A model is a nested tree of Plates whose children are distributions, Groups,
Data markers or sub-Plates.  Every traversal (Q-sampling, logPQ evaluation)
is a Python recursion over this static tree.
"""
from __future__ import annotations

from typing import Optional

from ..dims import dims_of
from ..utils import check_name, list_duplicates, tree_branches
from .dist import Dist, _DistCall, sample_gdt, datagroup
from .group import Group
from .data import Data


class Plate:
    def __init__(self, **kwargs):
        kwargs = {k: (v.finalize(k) if isinstance(v, _DistCall) else v)
                  for k, v in kwargs.items()}

        self.grouped_prog = {}
        self.flat_prog = {}
        for k, v in kwargs.items():
            if isinstance(v, Plate):
                self.grouped_prog[k] = v
                self.flat_prog[k] = v
            else:
                assert isinstance(v, (Group, Dist, Data)), \
                    f"{k} has unsupported type {type(v)}"
                group = v.prog if isinstance(v, Group) else {k: v}
                self.grouped_prog[k] = {}
                for gk, gv in group.items():
                    self.grouped_prog[k][gk] = gv
                    self.flat_prog[gk] = gv

        names = self.all_prog_names()
        for name in names:
            check_name(name)
        dups = list_duplicates(names)
        if dups:
            raise Exception(f"Plate has duplicate names {dups}.")

    def to(self, device):
        """Move the constant tensors of every distribution to ``device``
        (in place)."""
        for v in self.flat_prog.values():
            if isinstance(v, (Plate, Dist)):
                v.to(device)

    def grouped_get(self, d, groupname):
        gv = self.grouped_prog[groupname]
        if isinstance(gv, dict):
            return {k: d.get(k) for k in gv}
        assert isinstance(gv, Plate)
        return d[groupname]

    # -- Q sampling ---------------------------------------------------------
    def sample(self, name: Optional[str], scope: dict, inputs_params: dict,
               active_platedims: list, all_platedims: dict, groupvarname2Kdim: dict,
               sampler, reparam: bool, keygen, dim_sizes: dict):
        if name is not None:
            active_platedims = [*active_platedims, name]

        scope = update_scope(scope, inputs_params)
        sample = {}

        for childname, prog in self.grouped_prog.items():
            if isinstance(prog, dict):
                if not datagroup(prog):
                    childsample = sample_gdt(
                        prog=prog,
                        scope=scope,
                        keygen=keygen,
                        active_platedims=active_platedims,
                        K_dim=groupvarname2Kdim[childname],
                        groupvarname2Kdim=groupvarname2Kdim,
                        dim_sizes=dim_sizes,
                        sampler=sampler,
                        reparam=reparam,
                    )
                    for k, v in childsample.items():
                        sample[k] = v
                        scope[k] = v
            else:
                assert isinstance(prog, Plate)
                platesample = prog.sample(
                    name=childname,
                    scope=scope,
                    inputs_params=inputs_params.get(childname) or {},
                    active_platedims=active_platedims,
                    all_platedims=all_platedims,
                    groupvarname2Kdim=groupvarname2Kdim,
                    sampler=sampler,
                    reparam=reparam,
                    keygen=keygen,
                    dim_sizes=dim_sizes,
                )
                sample[childname] = platesample
                scope[childname] = platesample
        return sample

    # -- name maps ----------------------------------------------------------
    def groupvarname2Kdim(self, K: int):
        """dict groupvarname -> K-dim name (the reserved ``K_<groupvarname>``)."""
        result = {}
        for groupname, v in self.grouped_prog.items():
            if isinstance(v, dict):
                if not datagroup(v):
                    result[groupname] = f"K_{groupname}"
            else:
                assert isinstance(v, Plate)
                result.update(v.groupvarname2Kdim(K))
        return result

    def all_prog_names(self):
        result = []
        for k, v in self.grouped_prog.items():
            result.append(k)
            if isinstance(v, dict):
                if len(v) >= 2:
                    result.extend(v.keys())
            else:
                assert isinstance(v, Plate)
                result.extend(v.all_prog_names())
        return result

    def varname2groupvarname_dist(self):
        result = {}
        for k, v in self.grouped_prog.items():
            if isinstance(v, dict):
                if not datagroup(v):
                    for gk, gv in v.items():
                        assert isinstance(gv, Dist)
                        result[gk] = (k, gv)
            else:
                assert isinstance(v, Plate)
                result.update(v.varname2groupvarname_dist())
        return result

    def varname2groupvarname(self):
        return {vn: g for vn, (g, _) in self.varname2groupvarname_dist().items()}

    def groupvarname2platenames(self):
        return self._groupvarname2platenames([])

    def _groupvarname2platenames(self, active_platenames):
        result = {}
        for name, dgpt in self.grouped_prog.items():
            if isinstance(dgpt, dict):
                result[name] = active_platenames
            else:
                assert isinstance(dgpt, Plate)
                result.update(dgpt._groupvarname2platenames([*active_platenames, name]))
        return result

    def all_platenames(self):
        result = []
        for n, v in self.flat_prog.items():
            if isinstance(v, Plate):
                result = [*result, n, *v.all_platenames()]
        return result


# ---- scope & tree utilities ----------------------------------------------

def update_scope(scope: dict, samples_inputs_params: dict):
    assert isinstance(scope, dict)
    scope = {**scope}
    for k, v in (samples_inputs_params or {}).items():
        if not isinstance(v, dict) and v is not None:
            scope[k] = v
    return scope


def empty_tree(plate: Plate):
    return {n: empty_tree(v) for n, v in plate.flat_prog.items()
            if isinstance(v, Plate)}


def tensordict2tree(plate: Plate, tensor_dict: dict):
    """Sort a flat dict of dimmed tensors into the plate tree, keyed by which
    plate dims each tensor carries."""
    root = empty_tree(plate)
    set_all_platenames = set(plate.all_platenames())

    for name, tensor in tensor_dict.items():
        current = root
        platenames = set_all_platenames.intersection(dims_of(tensor))
        while platenames:
            nxt = platenames.intersection(tree_branches(current).keys())
            assert len(nxt) == 1, f"cannot place {name}: candidate branches {nxt}"
            nxt = next(iter(nxt))
            current = current[nxt]
            platenames.remove(nxt)
        current[name] = tensor
    return root


def flatten_tree(tree: dict) -> dict:
    result = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            result.update(flatten_tree(v))
        else:
            result[k] = v
    return result
