"""The PyTorch port stands alone: importing all of ``nmma_tpu_torch`` and
the port's scripts (scripts/torch_*.py) loads no JAX and nothing of the JAX
package, and its entry points refuse to fall back to the CPU when no CUDA
device is present and none was asked for."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib
import pkgutil
import sys

import nmma_tpu_torch

names = [m.name for m in pkgutil.walk_packages(nmma_tpu_torch.__path__,
                                                "nmma_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import glob
import importlib.util
scripts = sorted(glob.glob("scripts/torch_*.py"))
for path in scripts:
    spec = importlib.util.spec_from_file_location(
        "port_script_" + path.split("/")[-1][:-3], path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
top = {n.split(".")[0] for n in sys.modules}
bad = sorted(t for t in top if t.startswith("jax") or t in ("flax", "nmma_tpu"))
print("imported", len(names), "modules and", len(scripts),
      "scripts; forbidden:", bad)
new = {"nmma_tpu_torch.inference.mcmc", "nmma_tpu_torch.models.spectral",
       "nmma_tpu_torch.models.supernova", "nmma_tpu_torch.models.shock_cooling",
       "nmma_tpu_torch.likelihood.bolometric", "nmma_tpu_torch.em_detectors",
       "nmma_tpu_torch.post_processing.parity"}
if bad or len(names) < 15 or not new <= set(names) or not scripts:
    raise SystemExit(1)

import torch
from nmma_tpu_torch.analysis import EMAnalysis, EMAnalysisConfig
from nmma_tpu_torch.cli import lightcurve_analysis
from nmma_tpu_torch.inference import EnsembleMCMC, NestedSampler
from nmma_tpu_torch.likelihood import PhotometryData
from nmma_tpu_torch.models import DetectorLightCurveModel

ENTRY_POINTS = {
    "EMAnalysis": lambda: EMAnalysis(EMAnalysisConfig()),
    "NestedSampler": lambda: NestedSampler(lambda u: u[:, 0], 2),
    "DetectorLightCurveModel": lambda: DetectorLightCurveModel(
        "nonexistent-model-is-never-reached", ["g"]),
    "PhotometryData.from_dict": lambda: PhotometryData.from_dict(
        {"g": {"time": [1.0], "mag": [20.0], "mag_error": [0.1]}}),
    "cli.lightcurve_analysis.main": lambda: lightcurve_analysis.main(
        ["--model", "Me2017", "--skip-sampling"]),
    "EnsembleMCMC": lambda: EnsembleMCMC(lambda u: u[:, 0], 2),
    "cli.lightcurve_analysis.lbol_main": lambda: lightcurve_analysis.lbol_main(
        ["--model", "Arnett"]),
}
if not torch.cuda.is_available():
    for name, make in ENTRY_POINTS.items():
        try:
            make()
        except RuntimeError as err:
            if "device='cpu'" not in str(err):
                raise
            print(name, "without a device raised:", err)
        else:
            raise SystemExit(f"{name} ran without a device")
"""


def test_port_imports_no_jax_and_needs_a_device():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "forbidden: []" in proc.stdout
