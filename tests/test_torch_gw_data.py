"""The port's GW data modules against the JAX package on the CPU.

``strain.py``, ``gwf.py``, ``io/ligolw.py`` and ``fetch.py`` are numpy and
standard-library code in both packages: the same inputs must give the same
arrays exactly, files written by either package must read the same in the
other, and xml injections must be equal key for key. ``fetch.py`` runs
against a localhost server, as tests/test_gwosc_fetch.py does.
``find_fiducial`` draws from a ``torch.Generator`` where the JAX package
draws from ``jax.random``, so it is held to what it finds: its marginalised
logL within 30% of the injection's (tests/test_gw_data.py:183-210's gate,
here 2.5% of it) and the chirp mass within 0.5 Msun.
"""

import json
import threading
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

import h5py
import numpy as np
import pytest
import torch

import nmma_tpu.gw.gwf as j_gwf
import nmma_tpu.gw.strain as j_strain
import nmma_tpu.injections as j_inj
import nmma_tpu_torch.gw.fetch as t_fetch
import nmma_tpu_torch.gw.gwf as t_gwf
import nmma_tpu_torch.gw.strain as t_strain
import nmma_tpu_torch.injections as t_inj

FS = 1024.0
T0 = 1000000000.0


def white(duration, seed, sigma=1e-23):
    return np.random.default_rng(seed).normal(0.0, sigma, int(duration * FS))


def test_psd_window_and_fft_are_the_jax_package():
    data = white(256.0, 1)
    for method in ("median", "mean"):
        for a, b in zip(
                t_strain.welch_psd(t_strain.StrainSeries(data, T0, FS), 4.0,
                                   method=method),
                j_strain.welch_psd(j_strain.StrainSeries(data, T0, FS), 4.0,
                                   method=method)):
            np.testing.assert_array_equal(a, b)
    for alpha in (0.0, 0.1, 0.5, 1.0):
        np.testing.assert_array_equal(t_strain.tukey_window(1000, alpha),
                                      j_strain.tukey_window(1000, alpha))
    assert t_strain.median_bias(7) == j_strain.median_bias(7)
    for a, b in zip(
            t_strain.fft_analysis_segment(t_strain.StrainSeries(data, T0,
                                                                FS)),
            j_strain.fft_analysis_segment(j_strain.StrainSeries(data, T0,
                                                                FS))):
        np.testing.assert_array_equal(a, b)


def test_interferometer_from_data_is_the_jax_package():
    data = white(72.0, 2)
    kw = dict(duration=8.0, post_trigger=2.0, f_min=20.0, f_max=500.0)
    a = t_strain.interferometer_from_data(
        "H1", t_strain.StrainSeries(data, T0, FS), T0 + 68.0, **kw)
    b = j_strain.interferometer_from_data(
        "H1", j_strain.StrainSeries(data, T0, FS), T0 + 68.0, **kw)
    assert type(a).__module__ == "nmma_tpu_torch.gw.likelihood"
    for field in ("frequencies", "strain", "psd"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert a.duration == b.duration and a.name == b.name


def test_strain_readers_are_the_jax_package(tmp_path):
    data = white(4.0, 3)
    p = tmp_path / "strain.hdf5"
    with h5py.File(p, "w") as f:
        ds = f.create_dataset("strain/Strain", data=data)
        ds.attrs["Xspacing"] = 1.0 / FS
        f.create_dataset("meta/GPSstart", data=T0)
    p2 = tmp_path / "strain.txt"
    times = T0 + np.arange(1024) / FS
    np.savetxt(p2, np.column_stack([times, data[:1024]]))
    p3 = tmp_path / "single.txt"
    with open(p3, "w") as f:
        f.write(f"# GPS start: {T0}\n# sample rate (Hz) = {FS}\n")
        np.savetxt(f, data[:512])
    p4 = tmp_path / "strain.npz"
    np.savez(p4, strain=data, t0=T0, sample_rate=FS)
    for path in (p, p2, p3, p4):
        a = t_strain.read_strain_file(str(path))
        b = j_strain.read_strain_file(str(path))
        np.testing.assert_array_equal(a.data, b.data)
        assert (a.t0, a.sample_rate) == (b.t0, b.sample_rate)
    cropped = t_strain.read_strain_file(str(p)).crop(T0 + 1.0, T0 + 3.0)
    assert cropped.duration == 2.0 and cropped.t0 == T0 + 1.0


def test_calibration_draws_are_the_jax_package():
    env = np.column_stack([np.geomspace(10, 2048, 20), np.ones(20),
                           np.zeros(20), 0.9 * np.ones(20),
                           -0.1 * np.ones(20), 1.1 * np.ones(20),
                           0.1 * np.ones(20)])
    freqs = np.linspace(20.0, 512.0, 300)
    np.testing.assert_array_equal(
        t_strain.calibration_draws_from_envelope(env, freqs, 5, seed=4),
        j_strain.calibration_draws_from_envelope(env, freqs, 5, seed=4))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_gwf_files_read_the_same_in_both_packages(tmp_path, writer):
    """A frame file written by either package reads in both, bit for
    bit, through read_gwf and read_strain_file."""
    rng = np.random.default_rng(5)
    chans = {"H1:STRAIN": 1e-21 * rng.normal(size=8192),
             "H1:AUX": rng.normal(size=8192)}
    path = str(tmp_path / f"H-H1_{writer}-1187008882-2.gwf")
    if writer == "port":
        t_gwf.write_gwf(path, {k: t_strain.StrainSeries(v, 1187008882.43,
                                                        4096.0)
                               for k, v in chans.items()})
    else:
        j_gwf.write_gwf(path, {k: j_strain.StrainSeries(v, 1187008882.43,
                                                        4096.0)
                               for k, v in chans.items()}, compress="raw")
    assert t_gwf.gwf_channels(path) == j_gwf.gwf_channels(path)
    for name, want in chans.items():
        for reader in (t_gwf.read_gwf, j_gwf.read_gwf):
            got = reader(path, name)
            np.testing.assert_array_equal(got.data, want)
            assert got.t0 == pytest.approx(1187008882.43, abs=1e-6)
            assert got.sample_rate == 4096.0
    a = t_strain.read_strain_file(path, channel="H1:STRAIN")
    b = j_strain.read_strain_file(path, channel="H1:STRAIN")
    np.testing.assert_array_equal(a.data, b.data)


_COLS = ["simulation_id", "mass1", "mass2", "spin1x", "spin1y", "spin1z",
         "spin2x", "spin2y", "spin2z", "inclination", "coa_phase",
         "distance", "longitude", "latitude", "polarization",
         "geocent_end_time", "geocent_end_time_ns"]


def write_ligolw(path, rows):
    """A sim_inspiral table written with the standard library, as
    tests/test_ligolw.py:14-42 does."""
    import gzip
    cols = "\n".join(
        f'      <Column Name="sim_inspiral:{c}" Type="ilwd:char"/>'
        if c == "simulation_id" else
        f'      <Column Name="sim_inspiral:{c}" Type="real_8"/>'
        for c in _COLS)
    body = ",\n      ".join(
        ",".join(f'"sim_inspiral:simulation_id:{int(v)}"' if i == 0
                 else repr(float(v)) for i, v in enumerate(row))
        for row in rows)
    text = f"""<?xml version='1.0' encoding='utf-8'?>
<!DOCTYPE LIGO_LW SYSTEM "http://ldas-sw.ligo.caltech.edu/doc/ligolwAPI/html/ligolw_dtd.txt">
<LIGO_LW>
  <Table Name="sim_inspiral:table">
{cols}
      <Stream Name="sim_inspiral:table" Type="Local" Delimiter=",">
      {body}
      </Stream>
  </Table>
</LIGO_LW>
"""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as fh:
        fh.write(text)


@pytest.mark.parametrize("suffix", [".xml", ".xml.gz"])
def test_xml_injections_are_the_jax_package(tmp_path, suffix):
    """Aligned, precessing and unsorted-mass rows: equal key for key."""
    path = str(tmp_path / f"inj{suffix}")
    write_ligolw(path, [
        [0, 1.2, 1.6, 0, 0, 0.04, 0, 0, -0.02, 0.4, 1.0, 120.0, 1.1, -0.5,
         0.3, 1187008882, 400000000],
        [1, 1.5, 1.3, 0.3, 0.1, 0.2, -0.1, 0.2, 0.1, 0.5, 0.7, 40.0, 3.4,
         -0.4, 1.5, 0, 0],
    ])
    got = t_inj.read_injection_file(path)
    want = j_inj.read_injection_file(path)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    entry = t_inj.read_injection_entry(path, 1)
    assert entry == j_inj.read_injection_entry(path, 1)
    assert entry["mass_1"] == 1.5 and entry["geocent_time"] == 0.0


GPS_START = 1187008867
RATE = 4096
DURATION = 32


@pytest.fixture()
def gwosc_server(tmp_path):
    """A localhost server with the GWOSC event API's json and two
    GWOSC-layout HDF5 files (tests/test_gwosc_fetch.py's fixture)."""
    root = tmp_path / "gwosc_root"
    api_dir = root / "eventapi" / "json" / "event" / "GW170817"
    files = root / "files"
    api_dir.mkdir(parents=True)
    files.mkdir(parents=True)
    data = {}
    for k, det in enumerate(("H1", "L1")):
        data[det] = 1e-21 * np.random.default_rng(k).normal(
            size=DURATION * RATE)
        with h5py.File(files / f"{det}-{GPS_START}-{DURATION}.hdf5",
                       "w") as f:
            ds = f.create_dataset("strain/Strain", data=data[det])
            ds.attrs["Xspacing"] = 1.0 / RATE
            ds.attrs["Xstart"] = float(GPS_START)
            f.create_dataset("meta/GPSstart", data=GPS_START)
    server = ThreadingHTTPServer(
        ("127.0.0.1", 0),
        lambda *a, **kw: SimpleHTTPRequestHandler(*a, directory=str(root),
                                                  **kw))
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def entry(det, dur, rate):
        return {"detector": det, "GPSstart": GPS_START, "duration": dur,
                "sampling_rate": rate, "format": "hdf5",
                "url": f"{base}/files/{det}-{GPS_START}-{DURATION}.hdf5"}

    payload = {"events": {
        "GW170817-v2": {"strain": [entry("H1", DURATION, RATE)]},
        "GW170817-v3": {"strain": [
            entry(det, dur, rate) for det in ("H1", "L1")
            for dur, rate in ((DURATION, RATE), (4096, 16384))]}}}
    (api_dir / "index.html").write_text(json.dumps(payload))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield base, data
    finally:
        server.shutdown()
        thread.join(timeout=5)
    assert not thread.is_alive()


def test_gwosc_fetch_offline(gwosc_server, tmp_path):
    import os
    base, data = gwosc_server
    strain = t_fetch.event_strain_catalog("GW170817", base_url=base)
    assert len(strain) == 4 and {e["detector"] for e in strain} == \
        {"H1", "L1"}
    v2 = t_fetch.event_strain_catalog("GW170817", base_url=base, version=2)
    assert len(v2) == 1
    with pytest.raises(ValueError, match="no version"):
        t_fetch.event_strain_catalog("GW170817", base_url=base, version=9)
    cache = str(tmp_path / "cache")
    series = t_fetch.fetch_event_strain(
        "GW170817", ["H1", "L1"], duration=DURATION, sample_rate=RATE,
        cache_dir=cache, base_url=base)
    for det in ("H1", "L1"):
        np.testing.assert_array_equal(series[det].data, data[det])
        assert series[det].t0 == GPS_START
    cached = next((tmp_path / "cache").glob("H1-*.hdf5"))
    mtime = os.path.getmtime(cached)
    t_fetch.fetch_event_strain("GW170817", ["H1"], cache_dir=cache,
                               base_url=base)
    assert os.path.getmtime(cached) == mtime
    ifos = t_fetch.interferometers_from_gwosc(
        ["H1", "L1"], "GW170817", GPS_START + 26.0, duration=4.0,
        post_trigger=2.0, f_min=20.0, f_max=512.0, cache_dir=cache,
        base_url=base)
    assert [i.name for i in ifos] == ["H1", "L1"]
    assert type(ifos[0]).__module__ == "nmma_tpu_torch.gw.likelihood"


def test_truncated_download_is_refused(monkeypatch):
    """The length-checked download refuses a body shorter than its
    content-length."""
    import io
    import urllib.request

    class Short(io.BytesIO):
        headers = {"content-length": "10"}

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(urllib.request, "urlopen",
                        lambda url, timeout=None: Short(b"12345"))
    with pytest.raises(OSError, match="incomplete download"):
        t_fetch._get("http://127.0.0.1:1/x")


BBH = dict(mass_1=36.0, mass_2=29.0, chi_1=0.1, chi_2=-0.05,
           luminosity_distance=800.0, theta_jn=0.5, phase=1.2,
           ra=1.3, dec=-0.5, psi=0.7, geocent_time=0.0)


def test_find_fiducial_finds_the_peak():
    """tests/test_gw_data.py's search setup on white noise with an
    IMRPhenomD BBH, in the port alone: judged by what it finds."""
    from nmma_tpu_torch.gw import GWTransientLikelihood, imrphenomd
    from nmma_tpu_torch.gw.fiducial import find_fiducial
    from nmma_tpu_torch.gw.likelihood import as_batch, project_signal
    from nmma_tpu_torch.gw import get_detector
    from nmma_tpu_torch.priors import parse_prior_dict

    duration, trigger = 8.0, T0 + 68.0
    ifos = []
    for k, name in enumerate(("H1", "L1")):
        series = t_strain.StrainSeries(white(72.0, 10 + k, 4e-23), T0, FS)
        n = int(duration * FS)
        freqs = np.fft.rfftfreq(n, d=1.0 / FS)
        h = project_signal(get_detector(name), imrphenomd,
                           torch.as_tensor(freqs[1:], dtype=torch.float32),
                           as_batch(BBH, "cpu"), trigger)[0].numpy()
        h_full = np.zeros(len(freqs), dtype=np.complex128)
        h_full[1:] = h
        h_full *= np.exp(-2j * np.pi * freqs * (duration - 2.0))
        i0 = int(round((trigger + 2.0 - duration - T0) * FS))
        series.data[i0:i0 + n] += np.fft.irfft(h_full * FS, n=n)
        ifos.append(t_strain.interferometer_from_data(
            name, series, trigger, duration=duration, post_trigger=2.0,
            f_min=20.0, f_max=500.0))
    priors = parse_prior_dict(
        "mass_1 = Uniform(minimum=30., maximum=42.)\n"
        "mass_2 = Uniform(minimum=24., maximum=34.)\n"
        "luminosity_distance = Uniform(minimum=300., maximum=1500.)\n")
    fixed = {k: BBH[k] for k in ("ra", "dec", "psi", "theta_jn", "chi_1",
                                 "chi_2")}
    fid, logl = find_fiducial(ifos, priors, imrphenomd, trigger, n_rounds=3,
                              batch=128, seed=2, fixed=fixed, device="cpu")
    ref = GWTransientLikelihood(ifos, waveform=imrphenomd,
                                trigger_time=trigger,
                                phase_marginalization=True,
                                time_marginalization=True, device="cpu")
    l_true = float(ref(as_batch(BBH, "cpu"))[0])
    assert logl > l_true - 0.025 * abs(l_true), (logl, l_true)

    def mchirp(m1, m2):
        return (m1 * m2) ** 0.6 / (m1 + m2) ** 0.2

    assert abs(mchirp(fid["mass_1"], fid["mass_2"])
               - mchirp(BBH["mass_1"], BBH["mass_2"])) < 0.5
    assert abs(fid["geocent_time"]) < 2e-3
