#!/usr/bin/env python3
"""Where two chunkings of covid's K = 300 point part, on one NVIDIA card.

    python3 scripts/torch_split_k300_probe.py

The covid K sweep's K = 300 point (``chip_smoke.py``'s ``covid_k300_split``:
16 regions x 20 training days, the recipe's counts), one QEM step from Q's
initial state on one particle tree under Split("nRs", 2) and under
Split("nRs", 1): for each leaf of Q's new state the largest difference
between the two, with both values there and the leaf's median magnitude;
and the marginal weights of that tree under both, their largest
difference, the variable and region where it lies, and that variable's ESS
there.  One JSON line per result; the card's name and power limit first.
"""
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from alan_tpu_torch import Split, train  # noqa: E402
from alan_tpu_torch.experiments import covid_recipe  # noqa: E402
from alan_tpu_torch.models import covid  # noqa: E402
from alan_tpu_torch.sample import Sample  # noqa: E402
from alan_tpu_torch.sampler import PermutationSampler  # noqa: E402


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    (nRs, nDs), K = chip_smoke.K300_SHAPE, chip_smoke.K300
    ps, cov, data, _ = covid_recipe.recipe(nRs, nDs)
    problem = covid.generate_problem(ps, data, cov, "qem", device="cuda")
    state0 = (problem.P.state(), problem.Q.state())
    tree, gv2K = problem.Q._sample(K, False, PermutationSampler, problem.all_platedims,
                                   torch.Generator(device="cuda").manual_seed(6),
                                   state=state0[1])
    new, weights, ess = {}, {}, {}
    for name, cs in (("split_nRs_2", Split("nRs", 2)), ("split_nRs_1", Split("nRs", 1))):
        step, _ = train.qem(problem, K, lr=chip_smoke.LR_QEM, computation_strategy=cs)
        new[name] = step(state0, sample=tree)[0]
        m = Sample(problem, tree, gv2K, PermutationSampler, False,
                   states=state0).marginals(computation_strategy=cs)
        weights[name], ess[name] = m.weights, m.ess()
        torch.cuda.empty_cache()

    a, b = new["split_nRs_1"][1]["qem_params"], new["split_nRs_2"][1]["qem_params"]
    leaves = []
    for k, v in b.items():
        x, y = a[k].with_dims_front(list(v.dims)).data, v.data
        d = (x - y).abs().flatten()
        i = int(d.argmax())
        leaves.append({"leaf": k, "max_abs_diff": d[i].item(),
                       "split_nRs_1": x.flatten()[i].item(), "split_nRs_2": y.flatten()[i].item(),
                       "median_abs": y.abs().median().item()})
    leaves.sort(key=lambda r: -r["max_abs_diff"])
    print(json.dumps({"state_leaves": leaves}), flush=True)

    wa, wb = weights["split_nRs_1"], weights["split_nRs_2"]
    worst = None
    for k, v in wb.items():
        d = (wa[k].with_dims_front(list(v.dims)).data - v.data).abs()
        if worst is None or d.max().item() > worst[0]:
            worst = (d.max().item(), k, v.dims, d)
    diff, k, dims, d = worst
    where = [int(i) for i in torch.nonzero(d == diff)[0]]
    at = dict(zip(dims, where))
    e = ess["split_nRs_2"][k] if k in ess["split_nRs_2"] else None
    e_there = None
    if e is not None:
        e_there = e.data[tuple(at[n] for n in e.dims)].item() if e.dims else e.data.item()
    print(json.dumps({"weights_max_abs_diff": diff, "variable": str(sorted(k) if isinstance(k, frozenset) else k),
                      "at": at, "ess_there": e_there,
                      "ess_min": min(v.data.min().item() for v in ess["split_nRs_2"].values())}),
          flush=True)


if __name__ == "__main__":
    main()
