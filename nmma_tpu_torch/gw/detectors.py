"""Interferometer geometry: antenna patterns and geocentric time delays.

PyTorch counterpart of ``nmma_tpu/gw/detectors.py`` (the bilby/LAL detector
layer of the reference GW likelihood). Each site is (latitude, longitude,
x-arm azimuth, y-arm azimuth), the LAL detector-table parametrisation; the
response tensor d = (x (x) x - y (y) y)/2 and the vertex are computed once
in float64 numpy, and the per-sample antenna pattern is a 3x3 contraction
over a ``[B]`` batch of sky positions.

Azimuths are counter-clockwise from East. The site table is the JAX
package's, number for number.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

EARTH_RADIUS = 6378137.0   # WGS-84 equatorial [m]
C_SI = 299792458.0


def _site_vectors(lat_deg, lon_deg, x_az_deg, y_az_deg):
    lat, lon = np.radians(lat_deg), np.radians(lon_deg)
    # local unit vectors in the Earth-fixed frame
    e_east = np.array([-np.sin(lon), np.cos(lon), 0.0])
    e_north = np.array([-np.sin(lat) * np.cos(lon),
                        -np.sin(lat) * np.sin(lon), np.cos(lat)])
    e_up = np.array([np.cos(lat) * np.cos(lon),
                     np.cos(lat) * np.sin(lon), np.sin(lat)])

    def arm(az_deg):
        az = np.radians(az_deg)
        return np.cos(az) * e_east + np.sin(az) * e_north

    vertex = EARTH_RADIUS * e_up
    return vertex, arm(x_az_deg), arm(y_az_deg)


@functools.lru_cache(maxsize=None)
def site_tensors(names, device):
    """The response tensors ``[I, 3, 3]`` and vertices ``[I, 3]`` of the
    named detectors, f32 on ``device``."""
    sites = [get_detector(n) for n in names]
    return (torch.as_tensor(np.stack([d.response for d in sites]),
                            dtype=torch.float32, device=device),
            torch.as_tensor(np.stack([d.vertex for d in sites]),
                            dtype=torch.float32, device=device))


def wave_frame(ra, dec, psi, gmst):
    """The wave-frame basis vectors (u, v), Earth-fixed, ``[B, 3]`` each."""
    gha = gmst - ra      # Greenwich hour angle
    cos_psi, sin_psi = torch.cos(psi), torch.sin(psi)
    cos_gha, sin_gha = torch.cos(gha), torch.sin(gha)
    cos_dec, sin_dec = torch.cos(dec), torch.sin(dec)
    u = torch.stack([
        -cos_psi * sin_gha - sin_psi * cos_gha * sin_dec,
        -cos_psi * cos_gha + sin_psi * sin_gha * sin_dec,
        sin_psi * cos_dec,
    ], dim=-1)
    v = torch.stack([
        sin_psi * sin_gha - cos_psi * cos_gha * sin_dec,
        sin_psi * cos_gha + cos_psi * sin_gha * sin_dec,
        cos_psi * cos_dec,
    ], dim=-1)
    return u, v


def source_direction(ra, dec, gmst):
    """The unit vector to the source, Earth-fixed, ``[B, 3]``."""
    gha = gmst - ra
    return torch.stack([
        torch.cos(dec) * torch.cos(gha),
        -torch.cos(dec) * torch.sin(gha),
        torch.sin(dec),
    ], dim=-1)


def antenna_patterns(responses, u, v):
    """(F_plus, F_cross) ``[B, I]`` of the ``[I, 3, 3]`` detector tensors
    for the wave-frame vectors ``[B, 3]``."""
    def quad(a, b):
        return torch.einsum("bi,kij,bj->bk", a, responses, b)

    return quad(u, u) - quad(v, v), quad(u, v) + quad(v, u)


def time_delays(vertices, n):
    """Arrival-time delays detector - geocentre [s], ``[B, I]``: the
    propagation direction is -n, so the delay is -(vertex . n)/c."""
    return -(n @ vertices.T) / C_SI


@dataclass(frozen=True)
class Detector:
    name: str
    vertex: np.ndarray        # Earth-fixed [m]
    response: np.ndarray      # 3x3 detector tensor

    def antenna_pattern(self, ra, dec, psi, gmst):
        """(F_plus, F_cross) ``[B]`` for ``[B]`` source directions and
        polarisations at Greenwich mean sidereal time ``gmst``."""
        responses, _ = site_tensors((self.name,), ra.device)
        f_plus, f_cross = antenna_patterns(
            responses, *wave_frame(ra, dec, psi, gmst))
        return f_plus[:, 0], f_cross[:, 0]

    def time_delay_from_geocenter(self, ra, dec, gmst):
        """Arrival-time delay detector - geocentre [s], ``[B]``."""
        _, vertices = site_tensors((self.name,), ra.device)
        return time_delays(vertices, source_direction(ra, dec, gmst))[:, 0]


def _make(name, lat, lon, x_az, y_az):
    vertex, xarm, yarm = _site_vectors(lat, lon, x_az, y_az)
    response = 0.5 * (np.outer(xarm, xarm) - np.outer(yarm, yarm))
    return Detector(name=name, vertex=vertex, response=response)


# site parameters (lat, lon, x/y-arm azimuth CCW from East) following the
# public LAL detector tables
_DETECTORS = {
    "H1": _make("H1", 46.4551, -119.4077, 324.0006 - 270.0, 324.0006),
    "L1": _make("L1", 30.5629, -90.7742, 252.2835 - 270.0 + 360.0 - 360.0,
                252.2835),
    "V1": _make("V1", 43.6314, 10.5045, 19.4326, 19.4326 + 90.0),
    "K1": _make("K1", 36.4113, 137.3061, 29.60, 119.60),
    # Einstein Telescope (triangular; ET1 arm pair) at the Virgo site
    "ET1": _make("ET1", 43.6314, 10.5045, 19.4326, 19.4326 + 60.0),
    "ET2": _make("ET2", 43.6314, 10.5045, 19.4326 + 120.0, 19.4326 + 180.0),
    "ET3": _make("ET3", 43.6314, 10.5045, 19.4326 + 240.0, 19.4326 + 300.0),
    # Cosmic Explorer (placed at the Hanford site)
    "CE": _make("CE", 46.4551, -119.4077, 324.0006 - 270.0, 324.0006),
}


def get_detector(name: str) -> Detector:
    if name not in _DETECTORS:
        raise KeyError(f"Unknown detector {name!r}; known: "
                       f"{sorted(_DETECTORS)}")
    return _DETECTORS[name]


# the constants of the JAX package's GMST as its compiled graph uses them:
# XLA folds (x / 86400) * rate into x * (rate / 86400) and (h * pi) / 12
# into h * (pi / 12), each folded constant rounded to f32
_GMST_RATE = float(np.float32(24.06570982441908) / np.float32(86400.0))
_GMST_OFFSET = float(np.float32(18.697374558))
_GMST_RAD_PER_HOUR = float(np.float32(np.float32(math.pi) / np.float32(12.0)))


def gmst_from_gps(gps_time):
    """Greenwich mean sidereal time [rad] from f32 GPS seconds.

    Linear sidereal rate anchored at the J2000 epoch, in f32 as in the JAX
    package. At GPS ~1.2e9 s an f32 ulp of the hour count is 0.0156 h
    (4.1e-3 rad), so the result depends on the exact operations; these are
    those of the JAX package's jitted graph, where the hour count is one
    fused multiply-add of the seconds since J2000. The FMA is emulated
    exactly: the product of two f32 numbers is exact in f64, and the sum is
    rounded to f32 once."""
    # GPS epoch 1980-01-06; J2000 epoch = GPS 630763213
    seconds = gps_time - 630763213.0
    gmst_hours = (seconds.double() * _GMST_RATE + _GMST_OFFSET).float()
    return torch.remainder(gmst_hours, 24.0) * _GMST_RAD_PER_HOUR
