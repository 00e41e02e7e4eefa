"""IMRPhenomD and IMRPhenomD_NRTidalv2 frequency-domain waveforms, batch-first.

PyTorch counterpart of ``nmma_tpu/gw/phenomd.py`` (the reference's default
BNS/BBH waveform family, lalsimulation's IMRPhenomD_NRTidalv2 called through
bilby, ``nmma/gw/gw_likelihood.py:3-4,164-207``): closed-form functions of
the frequency grid with the phenomenological coefficients of the published
tables (Husa et al. and Khan et al., PRD 93, 044006/044007 (2016); Berti,
Cardoso & Will (2006) ringdown fit; NRTidalv2, Dietrich et al., PRD 100,
044003 (2019); the Yagi & Yunes (2013) quadrupole-Love relation).

Shapes: the per-sample quantities ("pieces") are ``[B, 1]`` columns, the
dimensionless frequency ``Mf`` is ``[B, F]``. Where the JAX package takes
``jax.grad`` of a closed form at one point per sample (the C1 joins of the
phase, the amplitude's slopes at the joins, the time alignment at the
amplitude peak), this module evaluates the derivative written out by hand,
``_d*`` below; the tests hold each to ``jax.grad``.

Conventions match ``waveforms.taylorf2_tidal``: ``h+ = A (1+cos^2 i)/2
e^{-i Psi}``, ``hx = A cos i e^{-i(Psi + pi/2)}``, nonprecessing, (2,2) only.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .waveforms import MPC_M, MSUN_S, _EULER_GAMMA, column, polarize

_PI = 3.141592653589793


# ---------------------------------------------------------------------------
# coefficient fits: lambda = L[0] + L[1] eta
#   + xi   (L[2] + L[3] eta + L[4]  eta^2)
#   + xi^2 (L[5] + L[6] eta + L[7]  eta^2)
#   + xi^3 (L[8] + L[9] eta + L[10] eta^2),  xi = chiPN - 1
# (Khan et al. 2016, Table V)
# ---------------------------------------------------------------------------

_COEFFS = {
    # --- inspiral amplitude rho_i f^{(6+i)/3} ---
    "rho1": (3931.8979897196696, -17395.758706812805,
             3132.375545898835, 343965.86092361377, -1.2162565819981997e6,
             -70698.00600428853, 1.383907177859705e6, -3.9662761890979446e6,
             -60017.52423652596, 803515.1181825735, -2.091710365941658e6),
    "rho2": (-40105.47653771657, 112253.0169706701,
             23561.696065836168, -3.476180699403351e6, 1.137593670849482e7,
             754313.1127166454, -1.308476044625268e7, 3.6444584853928134e7,
             596226.612472288, -7.4277901143564405e6, 1.8928977514040343e7),
    "rho3": (83208.35471266537, -191237.7264145924,
             -210916.2454782992, 8.71797508352568e6, -2.6914942420669552e7,
             -1.9889806527362722e6, 3.0888029960154563e7,
             -8.390870279256162e7,
             -1.4535031953446497e6, 1.7063528990822166e7,
             -4.2748659731120914e7),
    # --- intermediate amplitude collocation value v2 ---
    "v2": (0.8149838730507785, 2.5747553517454658,
           1.1610198035496786, -2.3627771785551537, 6.771038707057573,
           0.7570782938606834, -2.7256896890432474, 7.1140380397149965,
           0.1766934149293479, -0.7978690983168183, 2.1162391502005153),
    # --- merger-ringdown amplitude ---
    "gamma1": (0.006927402739328343, 0.03020474290328911,
               0.006308024337706171, -0.12074130661131138,
               0.26271598905781324,
               0.0034151773647198794, -0.10779338611188374,
               0.27098966966891747,
               0.0007374185938559283, -0.02749621038376281,
               0.0733150789135702),
    "gamma2": (1.010344404799477, 0.0008993122007234548,
               0.283949116804459, -4.049752962958005, 13.207828172665366,
               0.10396278486805426, -7.025059158961947, 24.784892370130475,
               0.03093202475605892, -2.6924023896851663, 9.609374464684983),
    "gamma3": (1.3081615607036106, -0.005537729694807678,
               -0.06782917938621007, -0.6689834970767117, 3.403147966134083,
               -0.05296577374411866, -0.9923793203111362, 4.820681208409587,
               -0.006134139870393713, -0.38429253308696365,
               1.7561754421985984),
    # --- inspiral phase sigma_i ---
    "sigma1": (2096.551999295543, 1463.7493168261553,
               1312.5493286098522, 18307.330017082117, -43534.1440746107,
               -833.2889543511114, 32047.31997183187, -108609.45037520859,
               452.25136398112204, 8353.439546391714, -44531.3250037322),
    "sigma2": (-10114.056472621156, -44631.01109458185,
               -6541.308761668722, -266959.23419307504, 686328.3229317984,
               3405.6372187679685, -437507.7208209015, 1.6318171307344697e6,
               -7462.648563007646, -114585.25177153319, 674402.4689098676),
    "sigma3": (22933.658273436497, 230960.00814979506,
               14961.083974183695, 1.1940181342318142e6,
               -3.1042239693052764e6,
               -3038.166617199259, 1.8720322849093592e6,
               -7.309145012085539e6,
               42738.22871475411, 467502.018616601, -3.064853498512499e6),
    "sigma4": (-14621.71522218357, -377812.8579387104,
               -9608.682631509726, -1.7108925257214056e6,
               4.332924601416521e6,
               -22366.683262266528, -2.5019716386377467e6,
               1.0274495902259542e7,
               -85360.30079034246, -570025.3441737515, 4.396844346849777e6),
    # --- intermediate phase beta_i ---
    "beta1": (97.89747327985583, -42.659730877489224,
              153.48421037904913, -1417.0620760768954, 2752.8614143665027,
              138.7406469558649, -1433.6585075135881, 2857.7418952430758,
              41.025109467376126, -423.680737974639, 850.3594335657173),
    "beta2": (-3.282701958759534, -9.051384468245866,
              -12.415449742258042, 55.4716447709787, -106.05109938966335,
              -11.953044553690658, 76.80704618365418, -155.33172948098394,
              -3.4129261592393263, 25.572377569952536, -54.408036707740465),
    "beta3": (-2.5156429818799565e-5, 1.9750256942201327e-5,
              -1.8370671469295915e-5, 2.1886317041311973e-5,
              8.250240316860033e-5,
              7.157371250566708e-6, -5.5780000112270685e-5,
              1.9142082884072178e-4,
              5.447166261464217e-6, -3.220610095021982e-5,
              7.974016714984341e-5),
    # --- merger-ringdown phase alpha_i ---
    "alpha1": (43.31514709695348, 638.6332679188081,
               -32.85768747216059, 2415.8938269370315, -5766.875169379177,
               -61.85459307173841, 2953.967762459948, -8986.29057591497,
               -21.571435779762044, 981.2158224673428, -3239.5664895930286),
    "alpha2": (-0.07020209449091723, -0.16269798450687084,
               -0.1872514685185499, 1.138313650449945, -2.8334196304430046,
               -0.17137955686840617, 1.7197549338119527, -4.539717148261272,
               -0.049983437357548705, 0.6062072055948309,
               -1.682769616644546),
    "alpha3": (9.5988072383479, -397.05438595557433,
               16.202126189517813, -1574.8286986717037, 3600.3410843831093,
               27.092429659075467, -1786.482357315139, 5152.919378666511,
               11.175710130033895, -577.7999423177481, 1808.730762932043),
    "alpha4": (-0.02989487384493607, 1.4022106448583738,
               -0.07356049468633846, 0.8337006542278661, 0.2240008282397391,
               -0.055202870001177226, 0.5667186343606578,
               0.7186931973380503,
               -0.015507437354325743, 0.15750322779277187,
               0.21076815715176228),
    "alpha5": (0.9974408278363099, -0.007884449714907203,
               -0.059046901195591035, 1.3958712396764088, -4.516631601676276,
               -0.05585343136869692, 1.7516580039343603, -5.990208965347804,
               -0.017945336522161195, 0.5965097794825992,
               -2.0608879367971804),
}

# boundary frequencies of the phenom phase pieces (Khan et al. 2016 §IV)
_PHI_INS_JOIN = 0.018
_AMP_INS_JOIN = 0.014


_FIT_NAMES = list(_COEFFS)


@functools.lru_cache(maxsize=None)
def _fit_table(device):
    """The fit coefficients as an f32 ``[11, 16]`` table on ``device``
    (row k holds L[k] of every fit)."""
    return torch.as_tensor(np.array([_COEFFS[n] for n in _FIT_NAMES]).T,
                           dtype=torch.float32, device=device)


def _fits(eta, xi):
    """Every fit of the table at once: ``{name: [B, 1]}``. Each column is
    the one-fit formula, in f32 with the same operations, so the values
    are those of evaluating the fits one by one."""
    L = _fit_table(eta.device)
    eta2 = eta * eta
    out = (L[0] + L[1] * eta
           + xi * (L[2] + L[3] * eta + L[4] * eta2)
           + xi * xi * (L[5] + L[6] * eta + L[7] * eta2)
           + xi * xi * xi * (L[8] + L[9] * eta + L[10] * eta2))
    return dict(zip(_FIT_NAMES, out.split(1, dim=-1)))


def _chi_pn(seta, eta, chi1, chi2):
    chi_s = 0.5 * (chi1 + chi2)
    chi_a = 0.5 * (chi1 - chi2)
    return chi_s * (1.0 - eta * 76.0 / 113.0) + seta * chi_a


def final_spin(eta, chi1, chi2):
    """Dimensionless remnant spin (Husa et al. 2016 eq. 3.6, m1 >= m2)."""
    seta = torch.sqrt(torch.clamp(1.0 - 4.0 * eta, min=0.0))
    m1 = 0.5 * (1.0 + seta)
    m2 = 0.5 * (1.0 - seta)
    s = m1 * m1 * chi1 + m2 * m2 * chi2
    eta2, eta3 = eta * eta, eta**3
    s2, s3 = s * s, s**3
    return eta * (3.4641016151377544 - 4.399247300629289 * eta
                  + 9.397292189321194 * eta2 - 13.180949901606242 * eta3
                  + s * ((1.0 / eta - 0.0850917821418767
                          - 5.837029316602263 * eta)
                         + (0.1014665242971878
                            - 2.0967746996832157 * eta) * s
                         + (-1.3546806617824356
                            + 4.108962025369336 * eta) * s2
                         + (-0.8676969352555539
                            + 2.064046835273906 * eta) * s3))


def radiated_energy(eta, chi1, chi2):
    """Radiated-energy fraction (Husa et al. 2016 eq. 3.7/3.8)."""
    seta = torch.sqrt(torch.clamp(1.0 - 4.0 * eta, min=0.0))
    m1 = 0.5 * (1.0 + seta)
    m2 = 0.5 * (1.0 - seta)
    m1s, m2s = m1 * m1, m2 * m2
    s = (m1s * chi1 + m2s * chi2) / (m1s + m2s)
    eta2, eta3 = eta * eta, eta**3
    return (eta * (0.055974469826360077 + 0.5809510763115132 * eta
                   - 0.9606726679372312 * eta2 + 3.352411249771192 * eta3)
            * (1.0 + (-0.0030302335878845507 - 2.0066110851351073 * eta
                      + 7.7050567802399215 * eta2) * s)) / \
        (1.0 + (-0.6714403054720589 - 1.4756929437702908 * eta
                + 7.304676214885011 * eta2) * s)


def qnm_ringdown(af):
    """(M f_ring, M f_damp) of the l=m=2, n=0 Kerr QNM (Berti, Cardoso &
    Will 2006 fit; remnant mass 1)."""
    one_m_a = torch.clamp(1.0 - af, min=1e-4)
    omega = 1.5251 - 1.1568 * torch.pow(one_m_a, 0.1292)
    quality = 0.7000 + 1.4187 * torch.pow(one_m_a, -0.4990)
    f_ring = omega / (2.0 * _PI)
    f_damp = f_ring / (2.0 * quality)
    return f_ring, f_damp


# ---------------------------------------------------------------------------
# TaylorF2 aligned-spin point-particle phasing (the PhenomD inspiral base):
# Psi = 3/(128 eta v^5) sum_i phi_i v^i, log terms split
# ---------------------------------------------------------------------------

def _tf2_phasing(eta, seta, chi1, chi2):
    eta2, eta3 = eta * eta, eta**3
    chi_s = 0.5 * (chi1 + chi2)
    chi_a = 0.5 * (chi1 - chi2)
    chi_s2, chi_a2 = chi_s * chi_s, chi_a * chi_a
    pi2 = _PI * _PI
    log4 = float(np.log(np.float32(4.0)))

    phi = {}
    phi[0] = 1.0
    phi[2] = 3715.0 / 756.0 + 55.0 / 9.0 * eta
    phi[3] = (-16.0 * _PI
              + (113.0 / 3.0 - 76.0 / 3.0 * eta) * chi_s
              + 113.0 / 3.0 * seta * chi_a)
    phi[4] = (15293365.0 / 508032.0 + 27145.0 / 504.0 * eta
              + 3085.0 / 72.0 * eta2
              + (-405.0 / 8.0 + 200.0 * eta) * chi_a2
              - 405.0 / 4.0 * seta * chi_a * chi_s
              + (-405.0 / 8.0 + 5.0 / 2.0 * eta) * chi_s2)
    # v^5 coefficient multiplies (1 + 3 log v)
    phi[5] = (38645.0 / 756.0 * _PI - 65.0 / 9.0 * _PI * eta
              + seta * (-732985.0 / 2268.0 - 140.0 / 9.0 * eta) * chi_a
              + (-732985.0 / 2268.0 + 24260.0 / 81.0 * eta
                 + 340.0 / 9.0 * eta2) * chi_s)
    # constant piece of the -6848/63*ln(64 v^3) log term: -6848/21*ln 4
    phi[6] = (11583231236531.0 / 4694215680.0 - 6848.0 / 21.0 * _EULER_GAMMA
              - 640.0 / 3.0 * pi2 - 6848.0 / 21.0 * log4
              + eta * (-15737765635.0 / 3048192.0 + 2255.0 / 12.0 * pi2)
              + 76055.0 / 1728.0 * eta2 - 127825.0 / 1296.0 * eta3
              + _PI * (2270.0 / 3.0 * seta * chi_a
                       + (2270.0 / 3.0 - 520.0 * eta) * chi_s)
              + (75515.0 / 288.0 - 263245.0 / 252.0 * eta
                 - 480.0 * eta2) * chi_a2
              + (75515.0 / 144.0 - 8225.0 / 18.0 * eta) * seta
              * chi_a * chi_s
              + (75515.0 / 288.0 - 232415.0 / 504.0 * eta
                 + 1255.0 / 9.0 * eta2) * chi_s2)
    phi["6log"] = -6848.0 / 63.0   # multiplies 3 log v
    phi[7] = (77096675.0 / 254016.0 * _PI + 378515.0 / 1512.0 * _PI * eta
              - 74045.0 / 756.0 * _PI * eta2
              + seta * (-25150083775.0 / 3048192.0
                        + 26804935.0 / 6048.0 * eta
                        - 1985.0 / 48.0 * eta2) * chi_a
              + (-25150083775.0 / 3048192.0
                 + 10566655595.0 / 762048.0 * eta
                 - 1042165.0 / 3024.0 * eta2
                 + 5345.0 / 36.0 * eta3) * chi_s)
    return phi


def _tf2_psi(Mf, eta, phi):
    """3/(128 eta v^5) sum phi_i v^i with v = (pi Mf)^{1/3}."""
    v = torch.pow(_PI * Mf, 1.0 / 3.0)
    logv = torch.log(v)
    v2, v3, v4, v5 = v * v, v**3, v**4, v**5
    v6, v7 = v**6, v**7
    series = (phi[0]
              + phi[2] * v2 + phi[3] * v3 + phi[4] * v4
              + phi[5] * (1.0 + 3.0 * logv) * v5
              + (phi[6] + 3.0 * phi["6log"] * logv) * v6
              + phi[7] * v7)
    return 3.0 / (128.0 * eta * v5) * series


def _dtf2_psi(Mf, eta, phi):
    """d/dMf of ``_tf2_psi``: 3/(128 eta) d/dv [v^-5 series] * v / (3 Mf)."""
    v = torch.pow(_PI * Mf, 1.0 / 3.0)
    logv = torch.log(v)
    d_dv = (-5.0 * phi[0] / v**6 - 3.0 * phi[2] / v**4
            - 2.0 * phi[3] / v**3 - phi[4] / (v * v)
            + 3.0 * phi[5] / v + phi[6]
            + 3.0 * phi["6log"] * (logv + 1.0) + 2.0 * phi[7] * v)
    return 3.0 / (128.0 * eta) * d_dv * v / (3.0 * Mf)


# ---------------------------------------------------------------------------
# phase pieces (dimensionless Mf; 1/eta prefactor included) and their
# derivatives
# ---------------------------------------------------------------------------

def _phi_inspiral(Mf, eta, phi_pn, sig):
    s1, s2, s3, s4 = sig
    pseudo = (s1 * Mf + 0.75 * s2 * torch.pow(Mf, 4.0 / 3.0)
              + 0.6 * s3 * torch.pow(Mf, 5.0 / 3.0) + 0.5 * s4 * Mf * Mf)
    return _tf2_psi(Mf, eta, phi_pn) + pseudo / eta


def _dphi_inspiral(Mf, eta, phi_pn, sig):
    s1, s2, s3, s4 = sig
    dpseudo = (s1 + s2 * torch.pow(Mf, 1.0 / 3.0)
               + s3 * torch.pow(Mf, 2.0 / 3.0) + s4 * Mf)
    return _dtf2_psi(Mf, eta, phi_pn) + dpseudo / eta


def _phi_intermediate(Mf, eta, bet):
    b1, b2, b3 = bet
    return (b1 * Mf + b2 * torch.log(Mf) - b3 / (3.0 * Mf**3)) / eta


def _dphi_intermediate(Mf, eta, bet):
    b1, b2, b3 = bet
    return (b1 + b2 / Mf + b3 / Mf**4) / eta


def _phi_mergerringdown(Mf, eta, alp, f_rd, f_damp):
    a1, a2, a3, a4, a5 = alp
    return (a1 * Mf - a2 / Mf + 4.0 / 3.0 * a3 * torch.pow(Mf, 0.75)
            + a4 * torch.arctan((Mf - a5 * f_rd) / f_damp)) / eta


def _dphi_mergerringdown(Mf, eta, alp, f_rd, f_damp):
    a1, a2, a3, a4, a5 = alp
    z = (Mf - a5 * f_rd) / f_damp
    return (a1 + a2 / (Mf * Mf) + a3 * torch.pow(Mf, -0.25)
            + a4 / (f_damp * (1.0 + z * z))) / eta


# ---------------------------------------------------------------------------
# amplitude pieces (relative to the leading-order SPA amplitude; the
# inspiral Ansatz -> 1 as f -> 0) and their derivatives
# ---------------------------------------------------------------------------

def _amp_pn_prefactors(eta, seta, chi1, chi2):
    """PN re-expansion of the Fourier amplitude (Khan et al. 2016 eq. 30)."""
    eta2, eta3 = eta * eta, eta**3
    chi12, chi22 = chi1 * chi1, chi2 * chi2
    seta_p1 = 1.0 + seta
    pi23 = float(np.power(np.float32(_PI), np.float32(2.0 / 3.0)))
    pi43 = float(np.power(np.float32(_PI), np.float32(4.0 / 3.0)))
    pi53 = float(np.power(np.float32(_PI), np.float32(5.0 / 3.0)))
    a23 = (-969.0 + 1804.0 * eta) * pi23 / 672.0
    a1 = ((chi1 * (81.0 * seta_p1 - 114.0 * eta)
           + chi2 * (81.0 - 81.0 * seta - 114.0 * eta)) * _PI) / 24.0
    a43 = ((-27312085.0 - 10287648.0 * chi22 - 10287648.0 * chi12 * seta_p1
            + 10287648.0 * chi22 * seta
            + 24.0 * (-1975055.0 + 857304.0 * chi12 - 994896.0 * chi1 * chi2
                      + 857304.0 * chi22) * eta
            + 35371056.0 * eta2) * pi43) / 8.128512e6
    a53 = (pi53 * (chi2 * (-285197.0 * (-1.0 + seta)
                           + 4.0 * (-91902.0 + 1579.0 * seta) * eta
                           - 35632.0 * eta2)
                   + chi1 * (285197.0 * seta_p1
                             - 4.0 * (91902.0 + 1579.0 * seta) * eta
                             - 35632.0 * eta2)
                   + 42840.0 * (-1.0 + 4.0 * eta) * _PI)) / 32256.0
    a2 = ((-336.0 * (-3248849057.0 + 2943675504.0 * chi12
                     - 3339284256.0 * chi1 * chi2
                     + 2943675504.0 * chi22) * eta2
           - 324322727232.0 * eta3
           - 7.0 * (-177520268561.0 + 107414046432.0 * chi22
                    + 107414046432.0 * chi12 * seta_p1
                    - 107414046432.0 * chi22 * seta
                    + 11087290368.0 * (chi1 + chi2 + chi1 * seta
                                       - chi2 * seta) * _PI)
           + 12.0 * eta * (-545384828789.0
                           - 176491177632.0 * chi1 * chi2
                           + 202603761360.0 * chi22
                           - 77271297456.0 * chi22 * seta
                           + 77616.0 * chi12 * (2610335.0
                                                + 995766.0 * seta)
                           + 5841690624.0 * (chi1 + chi2) * _PI
                           + 21384760320.0 * _PI * _PI))
          * _PI * _PI) / 6.0085960704e13
    return a23, a1, a43, a53, a2


def _amp_inspiral(Mf, pn_pref, rho):
    a23, a1, a43, a53, a2 = pn_pref
    r1, r2, r3 = rho
    f13 = torch.pow(Mf, 1.0 / 3.0)
    f23 = f13 * f13
    f43 = f23 * f23
    f53 = f43 * f13
    f73 = f53 * f23
    f83 = f73 * f13
    return (1.0 + a23 * f23 + a1 * Mf + a43 * f43 + a53 * f53
            + a2 * Mf * Mf + r1 * f73 + r2 * f83 + r3 * Mf**3)


def _damp_inspiral(Mf, pn_pref, rho):
    a23, a1, a43, a53, a2 = pn_pref
    r1, r2, r3 = rho
    f13 = torch.pow(Mf, 1.0 / 3.0)
    f23 = f13 * f13
    f43 = f23 * f23
    f53 = f43 * f13
    return (2.0 / 3.0 * a23 / f13 + a1 + 4.0 / 3.0 * a43 * f13
            + 5.0 / 3.0 * a53 * f23 + 2.0 * a2 * Mf
            + 7.0 / 3.0 * r1 * f43 + 8.0 / 3.0 * r2 * f53
            + 3.0 * r3 * Mf * Mf)


def _amp_mergerringdown(Mf, gam, f_rd, f_damp):
    g1, g2, g3 = gam
    fd = g3 * f_damp
    return (g1 * fd / ((Mf - f_rd)**2 + fd * fd)
            * torch.exp(-g2 * (Mf - f_rd) / fd))


def _damp_mergerringdown(Mf, gam, f_rd, f_damp):
    g1, g2, g3 = gam
    fd = g3 * f_damp
    x = Mf - f_rd
    return _amp_mergerringdown(Mf, gam, f_rd, f_damp) * (
        -2.0 * x / (x * x + fd * fd) - g2 / fd)


def _amp_peak_frequency(gam, f_rd, f_damp):
    g1, g2, g3 = gam
    inside = torch.clamp(1.0 - g2 * g2, min=0.0)
    shifted = f_rd + f_damp * (torch.sqrt(inside) - 1.0) * g3 / g2
    capped = f_rd - f_damp * g3 / g2
    return torch.abs(torch.where(g2 <= 1.0, shifted, capped))


def _phenomd_pieces(m1, m2, chi1, chi2):
    """Per-sample quantities shared by phase and amplitude (``[B, 1]``)."""
    total = m1 + m2
    eta = torch.clamp(m1 * m2 / total**2, 1e-6, 0.25)
    seta = torch.sqrt(torch.clamp(1.0 - 4.0 * eta, min=0.0))
    xi = _chi_pn(seta, eta, chi1, chi2) - 1.0

    af = final_spin(eta, chi1, chi2)
    erad = radiated_energy(eta, chi1, chi2)
    f_ring, f_dampq = qnm_ringdown(af)
    f_rd = f_ring / (1.0 - erad)
    f_damp = f_dampq / (1.0 - erad)

    fit = _fits(eta, xi)
    sig = tuple(fit[f"sigma{i}"] for i in (1, 2, 3, 4))
    bet = tuple(fit[f"beta{i}"] for i in (1, 2, 3))
    alp = tuple(fit[f"alpha{i}"] for i in (1, 2, 3, 4, 5))
    rho = tuple(fit[f"rho{i}"] for i in (1, 2, 3))
    gam = tuple(fit[f"gamma{i}"] for i in (1, 2, 3))
    v2c = fit["v2"]
    phi_pn = _tf2_phasing(eta, seta, chi1, chi2)
    pn_pref = _amp_pn_prefactors(eta, seta, chi1, chi2)
    return dict(eta=eta, seta=seta, f_rd=f_rd, f_damp=f_damp, sig=sig,
                bet=bet, alp=alp, rho=rho, gam=gam, v2c=v2c,
                phi_pn=phi_pn, pn_pref=pn_pref)


def _phase_joins(pieces):
    """C1 connection constants: (c1_int, c2_int, c1_mrd, c2_mrd) such that
    the intermediate piece plus c1_int + c2_int f and the merger-ringdown
    piece plus c1_mrd + c2_mrd f match value and slope at the joins."""
    eta, f_rd, f_damp = pieces["eta"], pieces["f_rd"], pieces["f_damp"]
    bet, alp = pieces["bet"], pieces["alp"]
    f1 = torch.full_like(eta, _PHI_INS_JOIN)
    f2 = 0.5 * f_rd
    c2_int = (_dphi_inspiral(f1, eta, pieces["phi_pn"], pieces["sig"])
              - _dphi_intermediate(f1, eta, bet))
    c1_int = (_phi_inspiral(f1, eta, pieces["phi_pn"], pieces["sig"])
              - _phi_intermediate(f1, eta, bet) - c2_int * f1)
    c2_mrd = (_dphi_intermediate(f2, eta, bet) + c2_int) - \
        _dphi_mergerringdown(f2, eta, alp, f_rd, f_damp)
    c1_mrd = (_phi_intermediate(f2, eta, bet) + c1_int + c2_int * f2
              - _phi_mergerringdown(f2, eta, alp, f_rd, f_damp)
              - c2_mrd * f2)
    return c1_int, c2_int, c1_mrd, c2_mrd


def phenomd_phase(Mf, pieces):
    """Full C(1) IMRPhenomD phase on ``Mf`` (no alignment), and the slope
    of the merger-ringdown piece (with its join) at ``f_peak``-style points:
    returns (phase, dphi_mr_full) where ``dphi_mr_full(f)`` is a function of
    a ``[B, 1]`` frequency."""
    eta, f_rd, f_damp = pieces["eta"], pieces["f_rd"], pieces["f_damp"]
    f1 = _PHI_INS_JOIN
    f2 = 0.5 * f_rd
    c1_int, c2_int, c1_mrd, c2_mrd = _phase_joins(pieces)

    ins = _phi_inspiral(torch.clamp(Mf, max=f1), eta, pieces["phi_pn"],
                        pieces["sig"])
    mid = _phi_intermediate(Mf, eta, pieces["bet"]) + c1_int + c2_int * Mf
    late = (_phi_mergerringdown(torch.clamp(Mf, min=f1), eta, pieces["alp"],
                                f_rd, f_damp)
            + c1_mrd + c2_mrd * torch.clamp(Mf, min=f1))
    phase = torch.where(Mf < f1, ins, torch.where(Mf < f2, mid, late))

    def dphi_mr_full(f):
        return _dphi_mergerringdown(f, eta, pieces["alp"], f_rd,
                                    f_damp) + c2_mrd

    return phase, dphi_mr_full


def _amplitude_intermediate_coefficients(pieces):
    """The intermediate amplitude's quartic: value and slope at f1 and f3,
    value v2 at f2 = (f1 + f3)/2, one 5x5 solve per sample -> ``[B, 5]``."""
    f_rd, f_damp = pieces["f_rd"], pieces["f_damp"]
    gam, rho, pn_pref = pieces["gam"], pieces["rho"], pieces["pn_pref"]
    f1 = torch.full_like(f_rd, _AMP_INS_JOIN)
    f3 = _amp_peak_frequency(gam, f_rd, f_damp)
    f2 = 0.5 * (f1 + f3)
    v1, d1 = _amp_inspiral(f1, pn_pref, rho), _damp_inspiral(f1, pn_pref, rho)
    v3 = _amp_mergerringdown(f3, gam, f_rd, f_damp)
    d3 = _damp_mergerringdown(f3, gam, f_rd, f_damp)
    v2 = pieces["v2c"]

    def value_row(f):
        return torch.cat([torch.ones_like(f), f, f**2, f**3, f**4], dim=-1)

    def slope_row(f):
        return torch.cat([torch.zeros_like(f), torch.ones_like(f), 2 * f,
                          3 * f**2, 4 * f**3], dim=-1)

    mat = torch.stack([value_row(f1), value_row(f2), value_row(f3),
                       slope_row(f1), slope_row(f3)], dim=-2)   # [B, 5, 5]
    rhs = torch.cat([v1, v2, v3, d1, d3], dim=-1)               # [B, 5]
    return torch.linalg.solve(mat, rhs), f3


def phenomd_amplitude_ansatz(Mf, pieces):
    """Dimensionless amplitude relative to the leading-order SPA scaling."""
    f_rd, f_damp = pieces["f_rd"], pieces["f_damp"]
    gam, rho = pieces["gam"], pieces["rho"]
    f1 = _AMP_INS_JOIN
    delta, f3 = _amplitude_intermediate_coefficients(pieces)
    d = [delta[:, i:i + 1] for i in range(5)]
    amp_int = d[0] + d[1] * Mf + d[2] * Mf**2 + d[3] * Mf**3 + d[4] * Mf**4
    ins = _amp_inspiral(torch.clamp(Mf, max=f1), pieces["pn_pref"], rho)
    late = _amp_mergerringdown(torch.clamp(Mf, min=f1), gam, f_rd, f_damp)
    return torch.where(Mf < f1, ins, torch.where(Mf < f3, amp_int, late))


# ---------------------------------------------------------------------------
# NRTidalv2 (Dietrich et al. 2019)
# ---------------------------------------------------------------------------

# Pade coefficients of the tidal phase (eq. 20)
_NRT_N1 = -12.615214237993088
_NRT_N32 = 19.0537346970349
_NRT_N2 = -21.166863146081035
_NRT_N52 = 90.55082156324926
_NRT_N3 = -60.25357801943598
_NRT_D1 = -15.111207827736678
_NRT_D32 = 22.195327350624694
_NRT_D2 = 8.064109635305156
_C_NEWT = 39.0 / 16.0


def _kappa2t(m1, m2, lam1, lam2):
    total = m1 + m2
    x1 = m1 / total
    x2 = m2 / total
    return 3.0 / 13.0 * ((1.0 + 12.0 * x2 / x1) * x1**5 * lam1
                         + (1.0 + 12.0 * x1 / x2) * x2**5 * lam2)


def nrtidalv2_phase(x, m1, m2, lam1, lam2):
    """Tidal phase psi_T(x), x = (pi M f)^{2/3} (Dietrich+19 eq. 20)."""
    total = m1 + m2
    x1 = m1 / total
    x2 = m2 / total
    kappa = _kappa2t(m1, m2, lam1, lam2)
    x32 = x * torch.sqrt(x)
    x52 = x * x32
    num = (1.0 + _NRT_N1 * x + _NRT_N32 * x32 + _NRT_N2 * x * x
           + _NRT_N52 * x52 + _NRT_N3 * x**3)
    den = 1.0 + _NRT_D1 * x + _NRT_D32 * x32 + _NRT_D2 * x * x
    return -kappa * _C_NEWT / (x1 * x2) * x52 * num / den


def nrtidalv2_amplitude(x, m1, m2, lam1, lam2):
    """Fractional tidal amplitude correction (Dietrich+19 eq. 24) relative
    to the leading-order SPA amplitude."""
    kappa = _kappa2t(m1, m2, lam1, lam2)
    poly = ((1.0 + 449.0 / 108.0 * x + 22672.0 / 9.0 * torch.pow(x, 2.89))
            / (1.0 + 13477.8 * x**4))
    return -9.0 * kappa * x**5 * poly


def nrtidal_merger_frequency(m1, m2, lam1, lam2):
    """Dimensionless merger frequency M f_merger (Dietrich+19 fit)."""
    q = torch.maximum(m1, m2) / torch.minimum(m1, m2)
    kappa = _kappa2t(m1, m2, lam1, lam2)
    kappa2 = kappa * kappa
    num = 1.0 + 3.354e-2 * kappa + 4.315e-5 * kappa2
    den = 1.0 + 7.542e-2 * kappa + 2.236e-4 * kappa2
    q_factor = 0.3586 / torch.sqrt(q)
    return q_factor * num / den / (2.0 * _PI)


def yagi_yunes_quadparam(lam):
    """Spin-induced quadrupole from the quadrupole-Love relation (Yagi &
    Yunes 2013); 1 (Kerr) at lambda = 0."""
    x = torch.log(torch.clamp(lam, min=1.0))
    ln_q = (0.194 + 0.0936 * x + 0.0474 * x * x
            - 4.21e-3 * x**3 + 1.23e-4 * x**4)
    return torch.where(lam > 0.0, torch.exp(ln_q), 1.0)


def _quadrupole_phase(Mf, m1, m2, chi1, chi2, lam1, lam2, eta):
    """EOS-dependent spin-quadrupole phase: the 2PN self-spin terms with
    dquadmon = quadparam - 1."""
    total = m1 + m2
    x1, x2 = m1 / total, m2 / total
    dq1 = yagi_yunes_quadparam(lam1) - 1.0
    dq2 = yagi_yunes_quadparam(lam2) - 1.0
    v = torch.pow(_PI * Mf, 1.0 / 3.0)
    coeff4 = (-50.0 * dq1 * chi1 * chi1 * x1 * x1
              - 50.0 * dq2 * chi2 * chi2 * x2 * x2)
    return 3.0 / (128.0 * eta * v**5) * coeff4 * v**4


def planck_taper(f, f1, f2):
    """Smooth 1 -> 0 taper on [f1, f2] (McKechan et al. 2010)."""
    eps = 1e-30
    z = (f2 - f1) / torch.clamp(f1 - f, max=-eps) + \
        (f2 - f1) / torch.clamp(f2 - f, min=eps)
    window = 1.0 / (1.0 + torch.exp(torch.clamp(z, -60.0, 60.0)))
    return torch.where(f <= f1, 1.0, torch.where(f >= f2, 0.0, window))


# ---------------------------------------------------------------------------
# public waveform interface (matches waveforms.taylorf2_tidal)
# ---------------------------------------------------------------------------

def _common(f, params):
    m1 = column(params, "mass_1", None, f)
    m2 = column(params, "mass_2", None, f)
    chi1 = column(params, "chi_1", 0.0, f)
    chi2 = column(params, "chi_2", 0.0, f)
    d_l = column(params, "luminosity_distance", None, f) * MPC_M
    iota = column(params, "theta_jn", 0.0, f)
    phase_c = column(params, "phase", 0.0, f)
    return m1, m2, chi1, chi2, d_l, iota, phase_c


def _leading_amp(f, m1, m2, d_l):
    total = m1 + m2
    eta = m1 * m2 / total**2
    mc = total * torch.pow(eta, 3.0 / 5.0)
    return (math.sqrt(5.0 / 24.0) * math.pow(_PI, -2.0 / 3.0)
            * torch.pow(mc * MSUN_S, 5.0 / 6.0)
            * torch.pow(torch.clamp(f, min=1e-3), -7.0 / 6.0)
            * 299792458.0 / d_l)


def _aligned_phase(f, params, m_sec, Mf, pieces):
    """PhenomD phase with the merger (amplitude peak) moved near t = 0: the
    linear term with the merger-ringdown slope at the peak removed."""
    phase, dphi_mr_full = phenomd_phase(Mf, pieces)
    f_peak = _amp_peak_frequency(pieces["gam"], pieces["f_rd"],
                                 pieces["f_damp"])
    t0 = dphi_mr_full(f_peak)
    mf_ref = m_sec * column(params, "reference_frequency", 20.0, f)
    return phase - t0 * (Mf - mf_ref)


def imrphenomd(frequencies, params):
    """(h_plus, h_cross) ``[B, F]`` for the aligned-spin IMRPhenomD BBH
    model."""
    f = torch.as_tensor(frequencies, dtype=torch.float32)
    m1, m2, chi1, chi2, d_l, iota, phase_c = _common(f, params)
    m_sec = (m1 + m2) * MSUN_S
    Mf = torch.clamp(m_sec * f, min=1e-9)

    pieces = _phenomd_pieces(m1, m2, chi1, chi2)
    phase = _aligned_phase(f, params, m_sec, Mf, pieces)
    ansatz = phenomd_amplitude_ansatz(Mf, pieces)

    t_off = column(params, "geocent_time_offset", 0.0, f)
    psi = 2.0 * _PI * f * t_off - phase_c - _PI / 4.0 + phase
    amp = _leading_amp(f, m1, m2, d_l) * ansatz
    # cut the template beyond the calibration range (LAL: f_max ~ 0.3/M)
    amp = torch.where((f > 0.0) & (Mf < 0.3), amp, 0.0)
    return polarize(amp, psi, iota)


def imrphenomd_nrtidalv2(frequencies, params):
    """(h_plus, h_cross) ``[B, F]`` for IMRPhenomD_NRTidalv2 (aligned-spin
    BNS)."""
    f = torch.as_tensor(frequencies, dtype=torch.float32)
    m1, m2, chi1, chi2, d_l, iota, phase_c = _common(f, params)
    lam1 = column(params, "lambda_1", 0.0, f)
    lam2 = column(params, "lambda_2", 0.0, f)
    m_sec = (m1 + m2) * MSUN_S
    Mf = torch.clamp(m_sec * f, min=1e-9)
    total = m1 + m2
    eta = torch.clamp(m1 * m2 / total**2, 1e-6, 0.25)

    pieces = _phenomd_pieces(m1, m2, chi1, chi2)
    phase = _aligned_phase(f, params, m_sec, Mf, pieces)
    ansatz = phenomd_amplitude_ansatz(Mf, pieces)

    x = torch.pow(_PI * Mf, 2.0 / 3.0)
    phase_t = nrtidalv2_phase(x, m1, m2, lam1, lam2)
    phase_qm = _quadrupole_phase(Mf, m1, m2, chi1, chi2, lam1, lam2, eta)
    amp_t = nrtidalv2_amplitude(x, m1, m2, lam1, lam2)

    t_off = column(params, "geocent_time_offset", 0.0, f)
    psi = (2.0 * _PI * f * t_off - phase_c - _PI / 4.0 + phase + phase_t
           + phase_qm)

    mf_merger = nrtidal_merger_frequency(m1, m2, lam1, lam2)
    taper = planck_taper(Mf, mf_merger, 1.2 * mf_merger)
    amp = _leading_amp(f, m1, m2, d_l) * (ansatz + amp_t) * taper
    amp = torch.where(f > 0.0, amp, 0.0)
    return polarize(amp, psi, iota)
