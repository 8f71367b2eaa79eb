"""Static P/Q structure checks that ``BoundPlate`` and ``Problem`` call
(counterpart of ``alan_tpu/ir/checking.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from ..dims import as_dt
from ..utils import tree_values
from .plate import Plate
from .dist import Dist
from .data import Data
from .timeseries import Timeseries


def check_inputs_params(P, Q):
    inputs_params_P = P.inputs_params_flat_named()
    inputs_params_Q = Q.inputs_params_flat_named()
    overlap = set(inputs_params_P).intersection(inputs_params_Q)
    for k in overlap:
        a, b = as_dt(inputs_params_P[k]), as_dt(inputs_params_Q[k])
        same = (a.dims == b.dims and a.data.shape == b.data.shape
                and bool(torch.equal(a.data, b.data)))
        if not same:
            raise Exception(
                f"Input / parameter names must be different in P and Q (or refer "
                f"to the same value); {k} differs between P and Q.  If you used "
                f"OptParam/QEMParam for the same parameter name in both, set an "
                f"explicit name, e.g. OptParam(1., name='a_loc_P').")


def check_support(name: str, distP: Dist, distQ: Dist):
    sP, sQ = distP.family.support, distQ.family.support
    if sP != sQ:
        raise Exception(
            f"Distributions in P and Q for {name} have different support. "
            f"For P: {sP}. While for Q: {sQ}")


def mismatch_names(A, B, prefix="", AnotB_msg="", BnotA_msg=""):
    inAnotB = list(set(A).difference(B))
    inBnotA = list(set(B).difference(A))
    if inAnotB:
        raise Exception(f"{prefix} {inAnotB} {AnotB_msg}.")
    if inBnotA:
        raise Exception(f"{prefix} {inBnotA} {BnotA_msg}.")


def check_PQ_plate(platename: Optional[str], P: Plate, Q: Plate, data: dict):
    """P/Q tree isomorphism, data-name matching and support equality."""
    mismatch_names(
        P.flat_prog.keys(), Q.flat_prog.keys(),
        prefix=f"In plate {platename}, there is a mismatch in the variable names, with",
        AnotB_msg="present in P but not Q",
        BnotA_msg="present in Q but not P")

    data_names_in_Q = [k for k, v in Q.flat_prog.items() if isinstance(v, Data)]
    data_names = tree_values(data).keys()
    mismatch_names(
        data_names_in_Q, data_names,
        prefix=(f"Mismatch between the data dict given to Problem "
                f"({list(data_names)}) and the variables marked Data() in Q "
                f"({data_names_in_Q}); issue in plate {platename}, with"),
        AnotB_msg="given as Data() in Q but missing from the data dict",
        BnotA_msg="present in the data dict but not marked Data() in Q")

    for name, dgpt_P in P.flat_prog.items():
        if isinstance(dgpt_P, Dist):
            distQ = Q.flat_prog[name]
            if not isinstance(distQ, (Dist, Data)):
                raise Exception(f"{name} in P is a Dist, so {name} in Q should be "
                                f"a Data/Dist, but is {type(distQ)}.")
            if isinstance(distQ, Dist):
                check_support(name, dgpt_P, distQ)
        elif isinstance(dgpt_P, Timeseries):
            tdQ = Q.flat_prog[name]
            if not isinstance(tdQ, (Dist, Timeseries, Data)):
                raise Exception(f"{name} in P is a Timeseries, so {name} in Q should "
                                f"be a Timeseries or Dist, but is {type(tdQ)}.")
            if not isinstance(tdQ, Data):
                distQ = tdQ.trans if isinstance(tdQ, Timeseries) else tdQ
                check_support(name, dgpt_P.trans, distQ)
        elif isinstance(dgpt_P, Plate):
            plateQ = Q.flat_prog[name]
            if not isinstance(plateQ, Plate):
                raise Exception(f"{name} in P is a Plate, so {name} in Q should "
                                f"also be a Plate, but is {type(plateQ)}.")
            check_PQ_plate(name, dgpt_P, plateQ, data[name])
        elif isinstance(dgpt_P, Data):
            raise Exception(f"{name} in P is Data; Data can only appear in Q.")
        else:
            raise Exception(f"{name} has unrecognised type {type(dgpt_P)}")


def check_timeseries(top_plate: Plate):
    """Timeseries inits must live (and be grouped consistently) in the
    immediate parent plate."""
    assert isinstance(top_plate, Plate)
    for v in top_plate.grouped_prog.values():
        if isinstance(v, Plate):
            _check_timeseries_inner(v, top_plate)


def _check_timeseries_inner(current_plate: Plate, upper_plate: Plate):
    upper_v2g = upper_plate.varname2groupvarname()
    for k, v in current_plate.grouped_prog.items():
        if isinstance(v, dict):
            init_groupnames = []
            for gk, gv in v.items():
                if isinstance(gv, Timeseries):
                    if gv.init not in upper_plate.flat_prog:
                        raise Exception(
                            f"Timeseries must have an initializer in the immediate "
                            f"parent plate; the initializer for {gk} ({gv.init}) "
                            f"isn't in the parent plate.")
                    init_groupnames.append(upper_v2g[gv.init])
            if any(g != init_groupnames[0] for g in init_groupnames[1:]):
                raise Exception(
                    f"Initializers for grouped timeseries on group {k} must "
                    f"be grouped the same way as the timeseries themselves.")
        else:
            assert isinstance(v, Plate)
            _check_timeseries_inner(v, current_plate)
