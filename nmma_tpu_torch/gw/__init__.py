"""The GW messenger of the port: waveforms, detectors, likelihoods and data.

PyTorch counterpart of ``nmma_tpu/gw/``; every likelihood takes ``[B]``
parameter tensors and returns ``[B]`` log-likelihood ratios.
"""

from .detectors import Detector, get_detector
from .fetch import (event_strain_catalog, fetch_event_strain,
                    interferometers_from_gwosc)
from .gwf import gwf_channels, read_gwf, write_gwf
from .likelihood import GWTransientLikelihood, InterferometerData
from .phenomd import imrphenomd, imrphenomd_nrtidalv2
from .relative_binning import RelativeBinningGWLikelihood
from .roq import ROQBasis, ROQGWLikelihood, build_roq_bases
from .waveforms import taylorf2_tidal

#: selectable frequency-domain waveform families (reference counterpart:
#: lalsimulation approximant names passed through bilby waveform_arguments,
#: nmma/gw/gw_likelihood.py:164-207)
WAVEFORM_MODELS = {
    "TaylorF2": taylorf2_tidal,
    "IMRPhenomD": imrphenomd,
    "IMRPhenomD_NRTidalv2": imrphenomd_nrtidalv2,
}


def get_waveform(name):
    try:
        return WAVEFORM_MODELS[name]
    except KeyError:
        raise ValueError(f"unknown waveform '{name}'; available: "
                         f"{sorted(WAVEFORM_MODELS)}") from None


__all__ = ["Detector", "get_detector", "GWTransientLikelihood",
           "RelativeBinningGWLikelihood", "InterferometerData",
           "taylorf2_tidal", "imrphenomd", "imrphenomd_nrtidalv2",
           "ROQBasis", "ROQGWLikelihood", "build_roq_bases",
           "WAVEFORM_MODELS", "get_waveform", "event_strain_catalog",
           "fetch_event_strain", "interferometers_from_gwosc",
           "gwf_channels", "read_gwf", "write_gwf"]
