"""Run an experiment grid under the native executor (the port's counterpart
of ``examples/run_grid.sh``):

    python -m alan_tpu_torch.run_grid SPEC|CMDFILE [-j N] [-t S] [-s STATUS]

``SPEC`` is a YAML or JSON grid spec (``gridspec``'s schema), expanded into
one ``python -m alan_tpu_torch.runner ...`` line a job; any other file is
taken as a command file as it stands (one shell command a line, ``#``
comments).  The command file goes beside the status file (``STATUS`` with
``.cmds`` appended).  Then this process becomes ``alan-grid``, built from
the repository's ``csrc/gridrunner.cpp`` at first use (``_build``), which
runs the jobs from the repository's root, ``N`` at a time, each under a
timeout of ``S`` seconds, and appends each job's state to ``STATUS``; a job
already marked ok there is skipped when the grid is run again.
"""
from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def command_file(spec_or_cmds: str, status: str) -> str:
    """The command file of ``spec_or_cmds``: a spec expanded to
    ``status + ".cmds"`` (the interpreter of this process starting each
    job), or the command file itself."""
    from . import gridspec
    if not spec_or_cmds.endswith((".yaml", ".yml", ".json")):
        return spec_or_cmds
    lines = gridspec.command_lines(gridspec.load_spec(spec_or_cmds), python=sys.executable)
    path = status + ".cmds"
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("spec", nargs="?", default=os.path.join(REPO, "examples", "grids",
                                                             "canonical.yaml"),
                    help="a YAML/JSON grid spec or a command file (default: "
                         "examples/grids/canonical.yaml)")
    ap.add_argument("-j", type=int, default=2, help="jobs at a time (default 2)")
    ap.add_argument("-t", type=int, default=7200,
                    help="seconds before a job is killed (default 7200)")
    ap.add_argument("-s", default=os.path.join(REPO, "results", "job_status.tsv"),
                    help="the status file (default results/job_status.tsv)")
    args = ap.parse_args(argv)
    from . import _build
    status = os.path.abspath(args.s)
    os.makedirs(os.path.dirname(status), exist_ok=True)
    cmds = os.path.abspath(command_file(os.path.abspath(args.spec), status))
    exe = _build.start_grid_runner().wait()
    os.chdir(REPO)
    sys.stdout.flush()
    sys.stderr.flush()
    os.execv(exe, [exe, "-j", str(args.j), "-t", str(args.t), "-s", status, cmds])


if __name__ == "__main__":
    main()
