"""Cluster job generation: Slurm scripts for a GPU and multi-config runs.

Port of ``nmma_tpu/cluster.py`` (the reference's
``nmma/em/cluster_handling.py``): one process per job owns one GPU, so the
generated sbatch script asks for ``--gres=gpu:1`` and runs the port's
analysis CLI directly (no mpiexec). ``multi_config_analysis`` runs a yaml
of analysis configurations (reference :116-164) as subprocesses of the
port's ``lightcurve-analysis``, serially or from a thread pool.
"""

from __future__ import annotations

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ANALYSIS_MODULE = "nmma_tpu_torch.cli.lightcurve_analysis"
# the directory holding this package, for subprocesses started elsewhere
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLURM_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={job_name}
#SBATCH --output={outdir}/{job_name}_%a.out
#SBATCH --error={outdir}/{job_name}_%a.err
#SBATCH --time={walltime}
#SBATCH --nodes=1
#SBATCH --ntasks-per-node=1
#SBATCH --cpus-per-task={cpus}
#SBATCH --gres=gpu:1
{array_directive}
{extra_lines}
{command}
"""


def slurm_analysis_script(args_string, outdir="outdir", job_name="nmma_tpu",
                          walltime="01:00:00", cpus=4, n_array=None,
                          extra_lines=(), script_name=None,
                          executable=f"python -m {ANALYSIS_MODULE}"):
    """Write an sbatch script for a (possibly arrayed) analysis job on one
    GPU; returns its path. $MODEL/$TT/$DATA wildcards in ``args_string``
    survive verbatim, as the reference's template variables
    (cluster_handling.py:27-110)."""
    os.makedirs(outdir, exist_ok=True)
    array_directive = f"#SBATCH --array=0-{n_array - 1}\n" if n_array else ""
    script = SLURM_TEMPLATE.format(
        job_name=job_name, outdir=outdir, walltime=walltime, cpus=cpus,
        array_directive=array_directive,
        extra_lines="\n".join(extra_lines),
        command=f"{executable} {args_string}")
    path = script_name or os.path.join(outdir, f"{job_name}.sbatch")
    with open(path, "w") as f:
        f.write(script)
    return path


def multi_config_analysis(config_path, parallel=False, max_workers=4,
                          dry_run=False):
    """Run a yaml of analysis configurations, {run_label: {flag: value}}.

    Each run becomes the port's ``lightcurve-analysis`` argv (``--label``
    from the run's key unless given); ``dry_run`` returns the
    ``(label, argv)`` pairs, else each runs as a subprocess and the
    ``(label, returncode)`` pairs return.
    """
    import yaml
    with open(config_path) as f:
        runs = yaml.safe_load(f)

    commands = []
    for label, flags in runs.items():
        argv = []
        for key, value in (flags or {}).items():
            flag = "--" + str(key).replace("_", "-")
            if isinstance(value, bool):
                if value:
                    argv.append(flag)
            else:
                argv.extend([flag, str(value)])
        if "--label" not in argv:
            argv.extend(["--label", str(label)])
        commands.append((label, argv))

    if dry_run:
        return commands

    path = os.environ.get("PYTHONPATH")
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([_ROOT] + ([path] if path else []))}

    def run_one(item):
        label, argv = item
        r = subprocess.run([sys.executable, "-m", ANALYSIS_MODULE, *argv],
                           capture_output=True, text=True, env=env)
        if r.returncode != 0:
            tail = (r.stderr or r.stdout or "").strip()[-2000:]
            print(f"[{label}] FAILED (rc={r.returncode}):\n{tail}",
                  flush=True)
        return label, r.returncode

    if parallel:
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            return list(pool.map(run_one, commands))
    return [run_one(c) for c in commands]
