"""The plain reference of the EM likelihood that every configuration shares.

Plain PyTorch and NumPy, written for the benchmark and frozen here: the
prior transform, the redshift of a luminosity distance (Planck18, float64),
the filters' frequencies and band quadrature, the Pei (1992) SMC host
extinction, the detector-frame assembly (redshift stretch, timeshift,
distance modulus, extinction), the interpolation onto the observation epochs
and the photometric likelihood with its upper limits and its -1e30 sentinel.
It imports nothing of the program under test and takes nothing it made: the
photometry file and the configuration are read here again.

Every function takes the working ``dtype`` (float32 for the comparison,
bfloat16 for the control), so the same code computes both.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

SENTINEL = -1e30

# physical constants (CODATA 2018, astropy's M_sun and pc)
C_SI = 299_792_458.0
C_CGS = C_SI * 100.0
H_CGS = 6.626_070_15e-34 * 1e7
KB_CGS = 1.380_649e-23 * 1e7
E_SI = 1.602_176_634e-19
EV_PER_H = E_SI / 6.626_070_15e-34
SIGMA_SB = 5.670_374_419e-8 * 1e3
MSUN_CGS = 1.988_409_870_698_051e30 * 1e3
PC_CGS = 3.085_677_581_491_367e18
MPC_CGS = PC_CGS * 1e6
SECONDS_A_DAY = 86_400.0
LN10 = math.log(10.0)
AB_ZP_CGS = -48.60
AB_ZP_MJY = 16.40
ABS_MAG_DIST2 = (10.0 * PC_CGS) ** 2

# effective wavelengths [Angstrom] of the benchmark's filters (sncosmo's
# bandpass registry) and the radio / X-ray frequencies [Hz]
WAVELENGTH_AA = {
    "sdssu": 3561.8, "ztfg": 4746.48, "ztfr": 6366.38, "ztfi": 7829.03,
    "ps1::z": 8679.47, "ps1::y": 9633.26, "2massj": 12350.0,
    "2massh": 16620.0, "2massks": 21590.0,
}
FREQUENCY_HZ = {"radio-6GHz": 6e9, "X-ray-1keV": 1e3 * EV_PER_H}
# band edges [Angstrom] (SVO filter service); flat top, linear ramps
BAND_AA = {
    "ztfg": (4087.0, 5522.0), "ztfr": (5600.0, 7317.0),
    "ztfi": (7027.0, 8883.0), "sdssu": (3048.0, 4028.0),
    "ps1::z": (8028.0, 9346.0), "ps1::y": (9100.0, 10838.0),
    "2massj": (10620.0, 14500.0), "2massh": (14787.0, 18231.0),
    "2massks": (19543.0, 23552.0),
}
BAND_NODES = 9
BAND_RAMP = 0.12


def frequency(name):
    if name in FREQUENCY_HZ:
        return FREQUENCY_HZ[name]
    return C_SI / (WAVELENGTH_AA[name] * 1e-10)


def band_quadrature(filters):
    """(nu_nodes [F, K], weights [F, K]) in float64: nodes log-spaced in
    wavelength across each band, weights the trapezoid transmission; a
    filter without band edges is one node at its frequency."""
    nodes = np.zeros((len(filters), BAND_NODES))
    weights = np.zeros_like(nodes)
    for i, name in enumerate(filters):
        if name not in BAND_AA:
            nodes[i] = frequency(name)
            weights[i, 0] = 1.0
            continue
        lo, hi = BAND_AA[name]
        lam = np.geomspace(lo, hi, BAND_NODES)
        ramp = BAND_RAMP * (hi - lo)
        trans = np.minimum(np.clip((lam - lo) / ramp, 0.0, 1.0),
                           np.clip((hi - lam) / ramp, 0.0, 1.0))
        nodes[i] = C_SI / (lam * 1e-10)
        weights[i] = trans / trans.sum()
    return nodes, weights


# -- priors --------------------------------------------------------------

_UNIFORM = re.compile(r"Uniform\(\s*minimum\s*=\s*([-+0-9.eE]+)\s*,\s*"
                      r"maximum\s*=\s*([-+0-9.eE]+)\s*\)")


def parse_prior(lines):
    """[(name, (minimum, maximum)) for the sampled ones], {name: value} for
    the fixed ones, in the order of the prior text."""
    sampled, fixed = [], {}
    for line in lines:
        line = line.split("#")[0].strip()
        if not line:
            continue
        name, rhs = (s.strip() for s in line.split("=", 1))
        match = _UNIFORM.fullmatch(rhs)
        if match:
            sampled.append((name, (float(match.group(1)),
                                   float(match.group(2)))))
        else:
            fixed[name] = float(rhs)
    return sampled, fixed


def transform(u, sampled, fixed, dtype):
    """Unit-cube rows [B, ndim] -> {name: [B]}: minimum + u (max - min)."""
    u = u.to(dtype)
    params = {name: lo + u[:, i] * (hi - lo)
              for i, (name, (lo, hi)) in enumerate(sampled)}
    for name, value in fixed.items():
        params[name] = torch.full(u.shape[:1], value, dtype=dtype,
                                  device=u.device)
    return params


# -- cosmology ------------------------------------------------------------

def redshift_at_distance(d_mpc):
    """z of a luminosity distance [Mpc] (numpy float64) in flat Planck18
    with one massive neutrino of 0.06 eV (astropy's Planck18 and its
    neutrino fitting formula), by inverting d_L(z) on a fine grid."""
    h0, om0, tcmb, neff = 67.66, 0.30966, 2.7255, 3.046
    m_nu = np.array([0.06])
    h0_cgs = h0 * 1e5 / MPC_CGS
    rho_crit = 3.0 * h0_cgs ** 2 / (8.0 * np.pi * 6.674_30e-11 * 1e3)
    og0 = (4.0 * SIGMA_SB / C_CGS) * tcmb ** 4 / C_CGS ** 2 / rho_crit
    y0 = m_nu / (8.617333262e-5 * 0.7137658555036082 * tcmb)

    def nu_rel(z):
        y = y0[None, :] / (1.0 + z[:, None])
        mass = np.power(1.0 + np.power(0.3173 * y, 1.83), 1.0 / 1.83)
        return 0.22710731766023898 * (neff / 3.0) * (mass.sum(-1) + 2.0)

    onu0 = og0 * nu_rel(np.zeros(1))[0]
    ode0 = 1.0 - om0 - og0 - onu0
    z = np.concatenate([[0.0], np.geomspace(1e-8, 4.0, 200_001)])
    inv_e = 1.0 / np.sqrt(om0 * (1 + z) ** 3 + ode0
                          + og0 * (1 + nu_rel(z)) * (1 + z) ** 4)
    dc = np.concatenate([[0.0], np.cumsum(0.5 * (inv_e[1:] + inv_e[:-1])
                                          * np.diff(z))])
    d_l = (1.0 + z) * dc * (C_SI / 1e3 / h0)
    return np.interp(np.asarray(d_mpc, dtype=np.float64), d_l, z)


# -- photometry -----------------------------------------------------------

def read_photometry(path, trigger, tmin, tmax, filters, dtype, device):
    """The .dat file (``mjd filter mag mag_error`` rows) cut to
    [tmin, tmax] days after the trigger, as dense [F, N] (times, mags,
    sigmas, valid) tensors in the order of ``filters``, each of which has
    to hold data."""
    rows = {f: [] for f in filters}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 4 or parts[1] not in rows:
                continue
            t = float(parts[0]) - trigger
            if tmin <= t <= tmax:
                rows[parts[1]].append((t, float(parts[2]), float(parts[3])))
    empty = [f for f in filters if not rows[f]]
    if empty:
        raise ValueError(f"no photometry in {empty}")
    n_max = max(len(r) for r in rows.values())
    arr = np.zeros((3, len(filters), n_max))
    arr[2] = np.inf
    valid = np.zeros((len(filters), n_max), dtype=bool)
    for i, f in enumerate(filters):
        vals = np.asarray(rows[f]).T
        arr[:, i, :vals.shape[1]] = vals
        valid[i, :vals.shape[1]] = True
    t, m, s = (torch.as_tensor(a, dtype=dtype, device=device) for a in arr)
    return t, m, s, torch.as_tensor(valid, device=device)


# -- extinction -----------------------------------------------------------

_P92_ABAV = 1.3219866307098898
_P92 = ((185.0, 0.042, 90.0, 2.0), (27.0, 0.08, 5.5, 4.0),
        (0.005, 0.22, -1.95, 2.0), (0.010, 9.7, -1.95, 2.0),
        (0.012, 18.0, -1.80, 2.0), (0.030, 25.0, 0.0, 2.0))


def p92_smc_band_mags(nu_nodes, weights, ebv, z):
    """Band-averaged Pei (1992) SMC host extinction [mag], [B, F], at the
    host-frame frequencies of the [F, K] quadrature (R_V = 2.93; the law is
    1 outside 1e-3..1e3 per micron and above 2e16 Hz)."""
    nu_host = nu_nodes[None] * (1.0 + z[:, None, None])
    lo_nu, hi_nu = 1e-3 * 1e4 * C_CGS, min(2e16, 1e3 * 1e4 * C_CGS)
    inside = (nu_host >= lo_nu) & (nu_host <= hi_nu)
    lam = C_CGS / torch.where(inside, nu_host, lo_nu) * 1e4
    a_lam = sum(a * _P92_ABAV / ((lam / l) ** n + (lam / l) ** (-n) + b)
                for a, l, b, n in _P92)
    fac = torch.pow(10.0, -0.4 * a_lam * (2.93 * ebv[:, None, None]))
    fac = torch.where(inside, fac, 1.0)
    eff = (weights[None] * fac).sum(-1)
    return -2.5 * torch.log10(torch.clamp(eff, min=1e-30))


# -- the detector frame and the likelihood --------------------------------

class Photometry:
    """The data, the model grid and the settings one configuration fixes,
    in ``dtype`` on ``device``."""

    def __init__(self, cfg, dtype, device):
        self.cfg, self.dtype, self.device = cfg, dtype, device
        # the program sorts the filters of the data it reads
        self.filters = sorted(cfg["filters"])
        grid = cfg["model_grid"]
        self.sample_times = torch.as_tensor(np.geomspace(
            grid["tmin"], grid["tmax"], grid["n_tsteps"]), dtype=dtype,
            device=device)
        self.sampled, self.fixed = parse_prior(cfg["prior"])
        self.error_budget = float(cfg["error_budget"])
        nodes, weights = band_quadrature(self.filters)
        self.nu_0 = torch.as_tensor([frequency(f) for f in self.filters],
                                    dtype=dtype, device=device)
        self.nu_nodes = torch.as_tensor(nodes, dtype=dtype, device=device)
        self.nu_weights = torch.as_tensor(weights, dtype=dtype,
                                          device=device)

    def load(self, data_path):
        """Read the photometry that the likelihood compares with."""
        data = self.cfg["data"]
        tmax = data.get("data_tmax")
        self.t_obs, self.mags, self.sigmas, self.valid = read_photometry(
            data_path, data["trigger_mjd"], data.get("data_tmin", 0.0),
            math.inf if tmax is None else tmax, self.filters, self.dtype,
            self.device)

    def parameters(self, u):
        return self.complete(transform(u, self.sampled, self.fixed,
                                       self.dtype))

    def complete(self, p):
        """Defaults of the detector frame and the redshift of the
        distance."""
        like = next(iter(p.values()))
        p.setdefault("luminosity_distance", torch.full_like(like, 1e-5))
        p.setdefault("timeshift", torch.zeros_like(like))
        p.setdefault("Ebv", torch.zeros_like(like))
        z = redshift_at_distance(p["luminosity_distance"].float().cpu()
                                 .numpy())
        p["redshift"] = torch.as_tensor(z, dtype=self.dtype,
                                        device=self.device)
        return p

    def detector(self, p, mags_fn, banded=False):
        """(observer times [B, T], apparent mags [B, F, T])."""
        z = p["redshift"]
        t = self.sample_times
        extra = {}
        if banded:
            extra = dict(nu_nodes=self.nu_nodes[None]
                         * (1.0 + z)[:, None, None],
                         nu_weights=self.nu_weights)
        mags = mags_fn(p, t, self.nu_0[None] * (1.0 + z)[:, None], **extra)
        t_det = t[None] * (1.0 + z)[:, None] + p["timeshift"][:, None]
        ext = p92_smc_band_mags(self.nu_nodes, self.nu_weights, p["Ebv"], z)
        dist_mod = 5.0 * (5.0 + torch.log10(p["luminosity_distance"]))
        app = (mags + ext[:, :, None] + dist_mod[:, None, None]
               - 2.5 * torch.log10(1.0 + z)[:, None, None])
        enough = torch.isfinite(app).sum(-1, keepdim=True) >= 2
        return t_det, torch.where(enough, app, math.inf)

    def at_epochs(self, t_det, app):
        """Model mags at the observation epochs, [B, F, N]: linear
        interpolation between the two grid nodes around each epoch (a
        non-finite node read as 0), inf outside the span of a row's finite
        nodes or where a row has fewer than two."""
        b, n_t = t_det.shape
        n_f, n_obs = self.t_obs.shape
        tq = self.t_obs.reshape(1, -1).expand(b, -1).contiguous()
        j = torch.clamp(torch.searchsorted(t_det.contiguous(), tq,
                                           right=True) - 1, 0, n_t - 2)
        x0, x1 = t_det.gather(1, j), t_det.gather(1, j + 1)
        frac = torch.clamp((tq - x0) / torch.clamp(x1 - x0, min=1e-30),
                           0.0, 1.0).reshape(b, n_f, n_obs)
        y = torch.where(torch.isfinite(app), app, 0.0)
        jj = j.reshape(b, n_f, n_obs)
        est = (1.0 - frac) * y.gather(2, jj) + frac * y.gather(2, jj + 1)
        fin = torch.isfinite(app)
        idx = torch.arange(n_t, device=app.device)
        first = torch.where(fin, idx, n_t).amin(-1)
        last = torch.where(fin, idx, -1).amax(-1)
        x_first = t_det.gather(1, first.clamp(max=n_t - 1))[:, :, None]
        x_last = t_det.gather(1, last.clamp(min=0))[:, :, None]
        ok = ((self.t_obs[None] >= x_first) & (self.t_obs[None] <= x_last)
              & (fin.sum(-1) >= 2)[:, :, None])
        return torch.where(ok, est, math.inf)

    def log_likelihood(self, est):
        """[B] log-likelihoods of model mags at the epochs [B, F, N]:
        Gaussian terms of the detections with sigma^2 = error^2 +
        budget^2, log-survival terms of the upper limits with the budget
        as scale; -1e30 where a band has no finite model value."""
        det = self.valid & torch.isfinite(self.sigmas)
        lim = self.valid & ~torch.isfinite(self.sigmas)
        budget = self.error_budget
        sigma = torch.sqrt(torch.where(det, self.sigmas, 0.0) ** 2
                           + budget ** 2)
        est_safe = torch.where(torch.isfinite(est), est, 1e30)
        r = (self.mags - est_safe) / sigma
        gauss = -0.5 * r * r - 0.5 * math.log(2.0 * math.pi) \
            - torch.log(sigma)
        # log_ndtr has no bfloat16 kernel: the control rounds its float32
        surv = torch.special.log_ndtr(
            (-(self.mags - est_safe) / budget).float()).to(est.dtype)
        logl = (torch.where(det, gauss, 0.0).sum((1, 2))
                + torch.where(lim, surv, 0.0).sum((1, 2)))
        used = self.valid.any(1)
        fine = (torch.isfinite(est) & self.valid).any(2) | ~used
        logl = torch.where(fine.all(1), logl, SENTINEL)
        return torch.where(torch.isnan(logl), SENTINEL,
                           torch.clamp(logl, min=SENTINEL))


def injection_light_curve(photometry, detector, injection):
    """(observer times [T], apparent mags [F, T]) of the injection, float64
    numpy, through a reference's ``detector(params)``."""
    ph = photometry
    u = torch.zeros((1, len(ph.sampled)), dtype=ph.dtype, device=ph.device)
    p = transform(u, ph.sampled, ph.fixed, ph.dtype)
    for name, value in injection.items():
        p[name] = torch.full((1,), value, dtype=ph.dtype, device=ph.device)
    p = ph.complete(p)
    t_det, app = detector(p)
    return t_det[0].double().cpu().numpy(), app[0].double().cpu().numpy()
