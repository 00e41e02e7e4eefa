"""What a run loads: the harness's import path with the program's modules
that a run imports loads neither JAX nor the JAX package, and the plain
reference with the count files loads nothing of the program either. Module
names are compared by their whole top-level name, since the program's
name begins with the JAX package's."""

import json
import subprocess
import sys

from portbench.spec import ROOT

LOAD = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_modules(imports):
    out = subprocess.run(
        [sys.executable, "-c", LOAD.format(root=ROOT, imports=imports)],
        capture_output=True, text=True, check=True, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_path_loads_no_jax():
    names = top_level_modules(
        "import portbench.run, portbench.control\n"
        "import portbench.programs.em, portbench.programs.em_svd\n"
        "import nmma_tpu_torch.analysis, nmma_tpu_torch.inference\n"
        "import nmma_tpu_torch.models, nmma_tpu_torch.parallel.mesh\n"
        "import portbench.reference.trpi2018, portbench.reference.me2017\n"
        "import portbench.reference.bu2019lm\n"
        "import portbench.counts.trpi2018, portbench.counts.me2017\n"
        "import portbench.counts.bu2019lm")
    assert "nmma_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "nmma_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = top_level_modules(
        "import portbench.reference.trpi2018, portbench.reference.me2017\n"
        "import portbench.reference.bu2019lm, portbench.check\n"
        "import portbench.counts.trpi2018, portbench.counts.me2017\n"
        "import portbench.counts.bu2019lm")
    assert not names & {"jax", "jaxlib", "flax", "nmma_tpu",
                        "nmma_tpu_torch"}
