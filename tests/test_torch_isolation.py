"""The PyTorch port stands alone: importing all of ``nmma_tpu_torch`` and
the port's scripts (scripts/torch_*.py) loads no JAX, no flax and nothing of
the JAX package (nor matplotlib or pandas, which the card's machine lacks),
and its entry points refuse to fall back to the CPU when no CUDA device is
present and none was asked for."""

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
# flax, msgpack, matplotlib and pandas are absent on the card's machine,
# and h5py may be
bad = sorted(t for t in top if t.startswith("jax")
             or t in ("flax", "nmma_tpu", "msgpack", "h5py", "matplotlib",
                      "pandas"))
print("imported", len(names), "modules and", len(scripts),
      "scripts; forbidden:", bad)
new = {"nmma_tpu_torch.inference.mcmc", "nmma_tpu_torch.models.spectral",
       "nmma_tpu_torch.models.supernova", "nmma_tpu_torch.models.shock_cooling",
       "nmma_tpu_torch.likelihood.bolometric", "nmma_tpu_torch.em_detectors",
       "nmma_tpu_torch.post_processing.parity",
       "nmma_tpu_torch.gw", "nmma_tpu_torch.gw.waveforms",
       "nmma_tpu_torch.gw.detectors", "nmma_tpu_torch.gw.phenomd",
       "nmma_tpu_torch.gw.likelihood", "nmma_tpu_torch.gw.relative_binning",
       "nmma_tpu_torch.gw.roq", "nmma_tpu_torch.gw.multibanding",
       "nmma_tpu_torch.gw.fiducial", "nmma_tpu_torch.gw.strain",
       "nmma_tpu_torch.gw.gwf", "nmma_tpu_torch.gw.fetch",
       "nmma_tpu_torch.joint", "nmma_tpu_torch.joint.likelihood",
       "nmma_tpu_torch.conversion", "nmma_tpu_torch.io.ligolw",
       "nmma_tpu_torch.cli.joint_main",
       "nmma_tpu_torch.eos", "nmma_tpu_torch.eos.eos",
       "nmma_tpu_torch.eos.tov", "nmma_tpu_torch.eos.generation",
       "nmma_tpu_torch.eos.cse", "nmma_tpu_torch.eos.likelihood",
       "nmma_tpu_torch.population", "nmma_tpu_torch.population.likelihood",
       "nmma_tpu_torch.injections",
       "nmma_tpu_torch.io.fits", "nmma_tpu_torch.io.radiative",
       "nmma_tpu_torch.io.msgpack", "nmma_tpu_torch.models.fiesta",
       "nmma_tpu_torch.eos.baryonic",
       "nmma_tpu_torch.post_processing.kde",
       "nmma_tpu_torch.post_processing.hubble",
       "nmma_tpu_torch.post_processing.ns_characteristics",
       "nmma_tpu_torch.post_processing.marginalisation",
       "nmma_tpu_torch.post_processing.resampling",
       "nmma_tpu_torch.post_processing.maximum_mass",
       "nmma_tpu_torch.training", "nmma_tpu_torch.training.svd",
       "nmma_tpu_torch.training.grids", "nmma_tpu_torch.training.gp",
       "nmma_tpu_torch.training.gp_compact", "nmma_tpu_torch.cli.tools",
       "nmma_tpu_torch.mlmodel", "nmma_tpu_torch.mlmodel.flows",
       "nmma_tpu_torch.mlmodel.embedding", "nmma_tpu_torch.mlmodel.inference",
       "nmma_tpu_torch.mlmodel.vicreg", "nmma_tpu_torch.mlmodel.pretrained",
       "nmma_tpu_torch.mlmodel.convert", "nmma_tpu_torch.eos.emulator",
       "nmma_tpu_torch.eos.lec", "nmma_tpu_torch.strategies",
       "nmma_tpu_torch.native", "nmma_tpu_torch.cluster",
       "nmma_tpu_torch.registry", "nmma_tpu_torch.plotting",
       "nmma_tpu_torch.plotting_utils",
       "nmma_tpu_torch.post_processing.plotting_routines",
       "nmma_tpu_torch.api", "nmma_tpu_torch.api.app",
       "nmma_tpu_torch.skyportal", "nmma_tpu_torch.parallel",
       "nmma_tpu_torch.parallel.mesh"}
if bad or len(names) < 15 or not new <= set(names) or not scripts:
    raise SystemExit(1)

import torch
from nmma_tpu_torch.analysis import EMAnalysis, EMAnalysisConfig
from nmma_tpu_torch import eos, injections, registry
from nmma_tpu_torch.api import AnalysisService, run_nmma_model
from nmma_tpu_torch.cli import joint_main, lightcurve_analysis, tools
from nmma_tpu_torch.eos import emulator, lec
from nmma_tpu_torch import mlmodel, parallel, training
from nmma_tpu_torch.inference import EnsembleMCMC, NestedSampler
from nmma_tpu_torch.likelihood import PhotometryData
from nmma_tpu_torch.models import DetectorLightCurveModel
from nmma_tpu_torch.models import fiesta, svd
from nmma_tpu_torch.post_processing import (GWEMResampler,
                                            MaximumMassResampler,
                                            marginalisation)

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
    "cli.joint_main.nmma_generation": lambda: joint_main.nmma_generation(
        ["--prior-file", "never-read.prior"]),
    "cli.joint_main.nmma_analysis": lambda: joint_main.nmma_analysis(
        ["--data-dump", "never-read.pickle"]),
    "eos.construct_families": lambda: eos.construct_families([]),
    "eos.construct_family": lambda: eos.construct_family(None),
    "eos.cse_eos_family": lambda: eos.cse_eos_family(None),
    "eos.tabulate_weighted_eos": lambda: eos.tabulate_weighted_eos(
        None, None, "never-written"),
    "fiesta.ingest_fiesta_directory": lambda: fiesta.ingest_fiesta_directory(
        "never-read", "never-named"),
    "fiesta.fiesta_from_numpy": lambda: fiesta.fiesta_from_numpy(dict(
        name="x", kind="flux", parameter_names=("a",),
        parameter_distributions={}, times=[1.0, 2.0], x_min=[0.0],
        x_max=[1.0], kernels=([[1.0]],), biases=([0.0],), y_min=[0.0],
        y_max=[1.0], nus=[1e14, 1e15])),
    "post_processing.marginalisation.main": lambda: marginalisation.main(
        ["--eos-data", "never-read"]),
    "post_processing.GWEMResampler": lambda: GWEMResampler(None, None, None),
    "post_processing.MaximumMassResampler": lambda: MaximumMassResampler(
        None, None, None),
    "cli.tools.create_svdmodel": lambda: tools.create_svdmodel(
        ["--model", "Bu2019lm", "--data-path", "never-read"]),
    "cli.tools.svdmodel_benchmark": lambda: tools.svdmodel_benchmark(
        ["--model", "Bu2019lm", "--data-path", "never-read"]),
    "training.train_svd_model": lambda: training.train_svd_model(
        [], []),
    "training.fit_gp_coefficients": lambda: training.fit_gp_coefficients(
        None, None),
    "training.fit_compact_gp": lambda: training.fit_compact_gp(None, None),
    "training.load_gp_surrogate": lambda: training.load_gp_surrogate(
        "never-read"),
    "mlmodel.train_flow_posterior": lambda: mlmodel.train_flow_posterior(
        None, None, []),
    "mlmodel.pretrain_similarity_embedding":
        lambda: mlmodel.pretrain_similarity_embedding(None),
    "mlmodel.SimilarityEmbedding.load": lambda: mlmodel.SimilarityEmbedding
        .load("never-read"),
    "eos.emulator.TOVEmulator": lambda: emulator.TOVEmulator(
        ["S0"], *[[0.0]] * 9),
    "eos.emulator.train_tov_emulator": lambda: emulator.train_tov_emulator(
        None),
    "eos.lec.LECEmulatorSet.load": lambda: lec.LECEmulatorSet.from_numpy(),
    "cli.tools.lightcurve_generation": lambda: tools.lightcurve_generation(
        ["--model", "never-named", "--injection", "never-read"]),
    "cli.tools.create_injection": lambda: tools.create_injection(
        ["--prior-file", "never-read.prior"]),
    "cli.tools.gwem_resampling": lambda: tools.gwem_resampling(
        ["--GWsamples", "never-read", "--EMsamples", "never-read",
         "--EOS-data", "never-read"]),
    "cli.tools.injection_slurm_setup": lambda: tools.injection_slurm_setup(
        ["--prior-file", "never-read.prior", "--analysis-file",
         "never-read.sh"]),
    "injections.create_light_curve_data": lambda:
        injections.create_light_curve_data({}, "never-named", ["ztfg"],
                                            ztf_sampling=True),
    "registry.load_registered_model": lambda: registry.load_registered_model(
        "never-named"),
    "registry.load_reference_registry_model":
        lambda: registry.load_reference_registry_model("never-named"),
    "models.svd.ingest_nmma_svd_model": lambda: svd.ingest_nmma_svd_model(
        "never-read", "never-named"),
    "api.AnalysisService": lambda: AnalysisService(port=0),
    "api.run_nmma_model": lambda: run_nmma_model({"model": "Me2017"}),
    "parallel.make_mesh": lambda: parallel.make_mesh(),
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
