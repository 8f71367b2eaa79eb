"""Declarative experiment-grid schemas (the port's copy of
``examples/gridspec.py``; the same schema, emitting the port's runner).

A grid spec is a YAML or JSON file:

.. code-block:: yaml

    defaults:                 # applied to every job (any runner flag)
      iters: 250
      predll_N: 100
    jobs:
      - model: movielens
        methods: [qem, vi, rws]       # axis
        Ks_lrs: {30: [0.1, 0.01]}     # axis: K -> lrs
        seeds: [0, 1]                 # axis
        split: {plate: plate_1, size: 150}
        platform: cpu                 # -> --device cpu
        out_dir: results

Axes (``methods`` x ``Ks_lrs`` x ``seeds``) expand to one runner invocation
each; scalar fields pass through as runner flags, ``platform`` as the
port's ``--device`` (``gpu`` names ``cuda``).  ``devices`` (a count of
virtual host devices, an XLA flag) has no torch counterpart and is
refused.  Consumers:

* ``python -m alan_tpu_torch.gridspec spec.yaml -o cmds.txt`` writes one
  ``python -m alan_tpu_torch.runner ...`` line per job, the input of
  ``alan-grid`` (``python -m alan_tpu_torch.run_grid`` builds and runs it),
  or prints them;
* ``python -m alan_tpu_torch.runner --grid spec.yaml`` runs the expanded
  jobs one after another in its own process.
"""
from __future__ import annotations

import json
import os
import shlex
import sys

_AXES = ("methods", "Ks_lrs", "seeds")
_KNOWN = {"model", "method", "K", "lr", "iters", "runs", "seed", "predll_N",
          "predll_every", "Q_param_type", "split", "mesh", "shard",
          "shard_all_k", "devices", "platform", "data_dir", "fuse_iters",
          "out", "out_dir"} | set(_AXES)
#: fields of the schema the port refuses, with the reason
_REFUSED = {"devices": "a count of virtual host devices is an XLA flag with no "
                       "torch counterpart; run a plan under torchrun instead"}
RUNNER = "-m alan_tpu_torch.runner"


def _refuse(fields, where):
    for k in fields:
        if k in _REFUSED:
            raise ValueError(f"{where}: the field {k!r} is not supported by the "
                             f"port: {_REFUSED[k]}")


def _check_fields(fields, where):
    _refuse(fields, where)
    unknown = set(fields) - _KNOWN
    if unknown:
        raise ValueError(f"{where}: unknown {'job' if where.endswith('job') else 'default'} "
                         f"fields {sorted(unknown)}")


def load_spec(path: str) -> dict:
    with open(path) as fh:
        text = fh.read()
    if path.endswith(".json"):
        spec = json.loads(text)
    else:
        import yaml
        spec = yaml.safe_load(text)
    if not isinstance(spec, dict) or "jobs" not in spec:
        raise ValueError(f"{path}: grid spec must be a mapping with a "
                         f"'jobs' list")
    for job in spec["jobs"]:
        _check_fields(job, f"{path}: job")
        if "model" not in job:
            raise ValueError(f"{path}: every job needs a 'model'")
    _check_fields(spec.get("defaults", {}), f"{path}: defaults")
    return spec


def _flag(name: str) -> str:
    return "--" + name.replace("_", "-")


def _device(platform) -> str:
    return "cuda" if str(platform) == "gpu" else str(platform)


def expand(spec: dict) -> list[list[str]]:
    """Expand a spec into runner argv lists (without the leading
    ``python -m alan_tpu_torch.runner``)."""
    defaults = spec.get("defaults", {})
    _refuse(defaults, "spec defaults")
    out = []
    for job in spec["jobs"]:
        _refuse(job, "spec job")
        cfg = {**defaults, **job}
        # an axis form shadows its scalar counterpart: a scalar left in cfg
        # would be re-emitted in the passthrough loop below, and argparse
        # last-wins would silently override every axis value
        methods = cfg.pop("methods", None)
        if methods is not None:
            cfg.pop("method", None)
        else:
            methods = [cfg.pop("method", "qem")]
        ks_lrs = cfg.pop("Ks_lrs", None)
        if ks_lrs is not None:
            cfg.pop("K", None)
            cfg.pop("lr", None)
        else:
            ks_lrs = {cfg.pop("K", 30): [cfg.pop("lr", None)]}
        seeds = cfg.pop("seeds", None)
        if seeds is not None:
            cfg.pop("seed", None)
        else:
            seeds = [cfg.pop("seed", 0)]
        out_dir = cfg.pop("out_dir", None)
        explicit_out = cfg.pop("out", None)

        for method in methods:
            for K, lrs in ks_lrs.items():
                for lr in (lrs if isinstance(lrs, (list, tuple)) else [lrs]):
                    for seed in seeds:
                        argv = ["--model", str(cfg["model"]),
                                "--method", str(method),
                                "--K", str(K), "--seed", str(seed)]
                        if lr is not None:
                            argv += ["--lr", str(lr)]
                        for k, v in cfg.items():
                            if k == "model" or v is None:
                                continue
                            if k == "split":
                                argv += ["--split", str(v["plate"]),
                                         str(v["size"])]
                            elif k == "fuse_iters":
                                if v:
                                    argv += ["--fuse-iters"]
                            elif k == "platform":
                                argv += ["--device", _device(v)]
                            else:
                                argv += [_flag(k), str(v)]
                        if explicit_out is not None:
                            argv += ["--out", explicit_out]
                        elif out_dir is not None:
                            name = f"{cfg['model']}_{method}_K{K}"
                            if lr is not None:
                                name += f"_lr{lr}"
                            if len(seeds) > 1:
                                name += f"_s{seed}"
                            argv += ["--out",
                                     os.path.join(out_dir, name + ".json")]
                        out.append(argv)
    return out


def command_lines(spec: dict, runner: str = RUNNER, python: str = "python") -> list[str]:
    """One shell command per expanded job (alan-grid input format)."""
    return [" ".join([shlex.quote(python), runner] + [shlex.quote(a) for a in argv])
            for argv in expand(spec)]


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("spec", help="YAML or JSON grid spec")
    ap.add_argument("-o", "--out", default=None,
                    help="write command lines here (default: stdout)")
    args = ap.parse_args(argv)
    lines = command_lines(load_spec(args.spec))
    text = "\n".join(lines) + "\n"
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
        print(f"{len(lines)} jobs -> {args.out}", file=sys.stderr)
    else:
        sys.stdout.write(text)


if __name__ == "__main__":
    main()
