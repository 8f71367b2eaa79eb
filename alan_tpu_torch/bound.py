"""BoundPlate: binds a Plate to plate sizes, inputs (covariates), the
learnable-parameter state and a device (counterpart of
``alan_tpu/bound.py``).

The parameter state (opt params, QEM conventional params, QEM moment
averages) is an explicit tree of dicts of ``DT`` (``state()``/
``set_state()``), so a training step is a function ``state -> state``.
"""
from __future__ import annotations

import torch

from .dims import DT, as_dt, dims_of, dt
from .ir.plate import Plate, tensordict2tree, flatten_tree
from .ir.param import QEMParam, identity
from .ir.checking import check_timeseries
from .sampler import PermutationSampler
from .moments import moments_func2name
from .conversions import conversion_dict
from .utils import KeyGen, check_name, resolve_device, seeded_generator


def named(data, *dims: str) -> DT:
    """A dimmed tensor whose leading axes are the given plate names."""
    return dt(data, *dims)


def expand_named(x, names, all_platesizes: dict, device) -> DT:
    """Broadcast a parameter init over its plates, on ``device``."""
    x = as_dt(x)
    for d in x.dims:
        if d not in all_platesizes:
            raise Exception(f"{d} is on a parameter but not in all_platesizes")
    extra = [n for n in names if n not in x.dims]
    for n in extra:
        if n not in all_platesizes:
            raise Exception(f"{n} is a plate dimension, but is not in all_platesizes")
    sizes = tuple(all_platesizes[n] for n in extra)
    data = x.data.to(device=device, dtype=torch.float32)
    data = torch.broadcast_to(data, sizes + tuple(data.shape)).contiguous()
    return DT(data, tuple(extra) + x.dims)


class BoundPlate:
    """``extra_opt_params``: named tensors learned by gradient (VI, RWS)
    beside the ``OptParam``s of the program, used by name in it."""

    def __init__(self, plate: Plate, all_platesizes: dict | None,
                 inputs=None, extra_opt_params=None, device="cuda"):
        assert isinstance(plate, Plate)
        self.device = resolve_device(device)
        self.plate = plate
        plate.to(self.device)

        all_platesizes = dict(all_platesizes or {})
        for platename in plate.all_platenames():
            if platename not in all_platesizes:
                raise Exception(
                    f"Every plate must have a size in all_platesizes; {platename} doesn't")
        self.all_platesizes = all_platesizes

        inputs = {k: as_dt(v) for k, v in (inputs or {}).items()}
        inputs = {k: DT(v.data.to(self.device), v.dims) for k, v in inputs.items()}
        extra_opt_params = {
            k: DT(as_dt(v).data.to(device=self.device, dtype=torch.float32),
                  as_dt(v).dims)
            for k, v in (extra_opt_params or {}).items()}
        for k, v in {**inputs, **extra_opt_params}.items():
            for name in dims_of(v):
                if name not in all_platesizes:
                    raise Exception(
                        f"Dim {name} on input/extra_opt_param {k} not in all_platesizes")
                if v.dim_size(name) != all_platesizes[name]:
                    raise Exception(
                        f"Size mismatch for {k} along {name}: all_platesizes says "
                        f"{all_platesizes[name]}, tensor has {v.dim_size(name)}")

        check_timeseries(plate)

        # inputs and extra opt params must be used at plate depths
        # consistent with their dims
        groupvarname2platenames = plate.groupvarname2platenames()
        varname2groupvarname_dist = plate.varname2groupvarname_dist()
        ie = {**inputs, **extra_opt_params}
        for varname, (groupvarname, dist) in varname2groupvarname_dist.items():
            for argname in dist.all_args:
                if argname in ie:
                    dist_platenames = groupvarname2platenames[groupvarname]
                    arg_platenames = dims_of(ie[argname])
                    if not set(arg_platenames).issubset(dist_platenames):
                        raise Exception(
                            f"{argname} is used on {varname} (plates {dist_platenames}) "
                            f"but has plates {list(arg_platenames)}")

        # ---- parameter state: opt params (each with its transformation),
        # QEM conventional params and QEM moment averages -----------------
        opt_params = dict(extra_opt_params)
        self.opt_paramname2trans = {p: identity for p in opt_params}

        self.qem_list_varname = []
        self.qem_list_conversion = []
        self.qem_list_rmkeys = []
        self.qem_flat_list_rmkeys = []
        qem_means = {}
        qem_params = {}
        self.qem_varname_distargname2paramname = {}
        self.qem_rmkey2meanname = {}

        for varname, (groupvarname, dist) in varname2groupvarname_dist.items():
            platenames = groupvarname2platenames[groupvarname]
            if not dist.qem_dist:
                for paramname, (distargname, param) in dist.opt_qem_params.items():
                    if paramname in opt_params:
                        raise Exception(
                            f"OptParam name clash: {paramname} already exists")
                    opt_params[paramname] = expand_named(
                        param.init, platenames, all_platesizes, self.device)
                    self.opt_paramname2trans[paramname] = param.trans
                continue
            self.qem_list_varname.append(varname)
            conversion = conversion_dict[dist.family]
            self.qem_list_conversion.append(conversion)

            rmkeys = [((varname,), mom) for mom in conversion.sufficient_stats]
            self.qem_flat_list_rmkeys.extend(rmkeys)
            self.qem_list_rmkeys.append(rmkeys)

            init_conv_dict = {}
            for paramname, (distargname, param) in dist.opt_qem_params.items():
                assert isinstance(param, QEMParam)
                expanded = expand_named(param.init, platenames, all_platesizes,
                                        self.device)
                qem_params[paramname] = expanded
                init_conv_dict[distargname] = expanded
                self.qem_varname_distargname2paramname[(varname, distargname)] = paramname
            init_means = conversion.conv2mean(**init_conv_dict)

            for rmkey, init_mean in zip(rmkeys, init_means):
                meanname = f"{varname}_{moments_func2name[rmkey[1]]}"
                self.qem_rmkey2meanname[rmkey] = meanname
                qem_means[meanname] = as_dt(init_mean)

        self._inputs = inputs
        self._state = {"opt": opt_params, "qem_params": qem_params,
                       "qem_means": qem_means}

        input_param_names = list(self.inputs_params_flat_named().keys())
        for name in input_param_names:
            check_name(name)
        if len(input_param_names) != len(set(input_param_names)):
            raise Exception(
                "BoundPlate has overlapping names in inputs/opt_params/qem_params")
        overlap = set(input_param_names).intersection(plate.all_prog_names())
        if overlap:
            raise Exception(f"Program names overlap with input/param names: {overlap}")

        # check that every dependency resolves, by sampling once
        self.sample(generator=seeded_generator(0, self.device))

    # ---- functional state ------------------------------------------------
    def state(self):
        return self._state

    def set_state(self, state):
        self._state = state

    def inputs(self):
        return dict(self._inputs)

    def opt_params(self, state=None):
        """The opt params with their transformations applied (``exp`` of a
        log-scale, say): the values the program reads."""
        state = state if state is not None else self._state
        return {k: DT(self.opt_paramname2trans[k](v.data), v.dims)
                for k, v in state["opt"].items()}

    def qem_params(self, state=None):
        state = state if state is not None else self._state
        return dict(state["qem_params"])

    def inputs_params_flat_named(self, state=None):
        return {**self.inputs(), **self.opt_params(state), **self.qem_params(state)}

    def inputs_params(self, state=None):
        return tensordict2tree(self.plate, self.inputs_params_flat_named(state))

    # ---- QEM update ------------------------------------------------------
    def _updated_qem_state(self, lr, sample, computation_strategy, state=None,
                           moments=None):
        """EMA the posterior moments and re-derive the conventional params;
        returns a new state.  ``moments`` may carry the precomputed moments
        for ``qem_flat_list_rmkeys`` (the fused QEM step reads P's and Q's
        moments and the ELBO off one backward pass)."""
        state = state if state is not None else self._state
        new_means = dict(state["qem_means"])
        rmkey_list = self.qem_flat_list_rmkeys
        if rmkey_list:
            new_moment_list = moments if moments is not None else \
                sample._moments_uniform_input(
                    rmkey_list, computation_strategy=computation_strategy)
            assert len(new_moment_list) == len(rmkey_list)
            for rmkey, new_moment in zip(rmkey_list, new_moment_list):
                meanname = self.qem_rmkey2meanname[rmkey]
                prev = new_means[meanname]
                upd = (1.0 - lr) * prev + lr * new_moment
                new_means[meanname] = upd.with_dims_front(prev.dims)

        new_params = dict(state["qem_params"])
        for varname, conversion, rmkeys in zip(
                self.qem_list_varname, self.qem_list_conversion, self.qem_list_rmkeys):
            means = [new_means[self.qem_rmkey2meanname[rmkey]] for rmkey in rmkeys]
            for distargname, new_param in conversion.mean2conv(*means).items():
                paramname = self.qem_varname_distargname2paramname[(varname, distargname)]
                old = new_params[paramname]
                assert set(dims_of(new_param)) == set(dims_of(old))
                new_params[paramname] = new_param.with_dims_front(old.dims)

        return {"opt": dict(state["opt"]), "qem_params": new_params,
                "qem_means": new_means}

    def _update_qem_params(self, lr, sample, computation_strategy):
        """``_updated_qem_state`` written into this BoundPlate's state."""
        self._state = self._updated_qem_state(lr, sample, computation_strategy)

    # ---- sampling --------------------------------------------------------
    def _sample(self, K: int, reparam: bool, sampler, all_platedims: dict,
                generator, state=None, noise=None):
        """K particles per latent.  ``noise`` (a tree shaped like the draw)
        replaces the generator's standard noise of reparameterised draws;
        the generator still draws the parents' permutations (it may be None
        where Q permutes none)."""
        assert isinstance(K, int)
        groupvarname2Kdim = self.plate.groupvarname2Kdim(K)
        dim_sizes = {**all_platedims, **{kd: K for kd in groupvarname2Kdim.values()}}
        sample = self.plate.sample(
            name=None,
            scope={},
            inputs_params=self.inputs_params(state),
            active_platedims=[],
            all_platedims=all_platedims,
            groupvarname2Kdim=groupvarname2Kdim,
            sampler=sampler,
            reparam=reparam,
            keygen=KeyGen(generator),
            dim_sizes=dim_sizes,
            noise=noise,
        )
        return sample, groupvarname2Kdim

    def sample(self, generator=None):
        """One draw from the prior: a flat dict of dimmed tensors whose dims
        are plates."""
        if generator is None:
            generator = seeded_generator(0, self.device)
        all_platedims = dict(self.all_platesizes)
        tree, _ = self._sample(1, False, PermutationSampler, all_platedims, generator)
        platenames = set(all_platedims)
        out = {}
        for k, v in flatten_tree(tree).items():
            Kdims = [d for d in dims_of(v) if d not in platenames]
            o = v.order(*Kdims)
            data = o.data
            for _ in Kdims:
                data = data.squeeze(len(o.dims))
            out[k] = DT(data, o.dims)
        return out

    def groupvarname2platenames(self):
        return self.plate.groupvarname2platenames()

    def varname2groupvarname(self):
        return self.plate.varname2groupvarname()
