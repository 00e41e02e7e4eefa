"""The port's analysis service (``nmma_tpu_torch.api``) and SkyPortal
bridge (``nmma_tpu_torch.skyportal``) against the JAX package's, on the
CPU.

* The service on port 0 with ``device="cpu"`` answers a Me2017 request at
  the JAX package's test payload (tests/test_services.py:38-91; photometry
  from the port's injection at the same seed, the nested run capped at
  ``max_iter``) with the keys of the JAX package's response to the same
  payload, its evidence within 3 combined standard errors of the JAX
  package's, its quantiles and best fit within a quarter of the JAX
  posterior's p5-p95 width, and the posterior's draws in its ``analysis``
  block; a model off the whitelist answers 400; a callback to a loopback
  server arrives exactly once, with the response.
* The bridge, through the ``invoke`` hook, passes the JAX package's argv
  (with ``--device`` only when one is given), writes its prior file byte
  for byte and its data file line for line (the magnitudes within an ulp:
  pandas' fast float parser there); an absent prior returns ``status:
  failure``; run for real on the CPU it writes the posterior, result and
  figure files.
"""

import base64
import csv
import io
import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

import nmma_tpu.api.app as j_app
import nmma_tpu.skyportal as j_sky
import nmma_tpu_torch.skyportal as t_sky
from nmma_tpu_torch.api import AnalysisService
from nmma_tpu_torch.injections import create_light_curve_data

torch.set_num_threads(1)

TRUTH = dict(log10_mej=-1.4, log10_vej=-1.1, beta=3.0, log10_kappa_r=0.7,
             luminosity_distance=40.0, timeshift=0.0)
PRIOR = ("log10_mej = Uniform(minimum=-3., maximum=-0.5)\n"
         "log10_vej = -1.1\nbeta = 3.0\nlog10_kappa_r = 0.7\n"
         "luminosity_distance = 40.0\ntimeshift = 0.0\n")


@pytest.fixture(scope="module")
def payload(tmp_path_factory):
    data = create_light_curve_data(TRUTH, "Me2017", ["ztfg", "ztfr"], seed=2,
                                   sample_times=np.geomspace(0.4, 8.0, 10),
                                   device="cpu")
    return {
        "model": "Me2017", "prior": PRIOR,
        "photometry": {f: {k: np.asarray(v).tolist() for k, v in sub.items()}
                       for f, sub in data.items()},
        "nlive": 64, "walks": 8, "dlogz": 1.0, "max_iter": 40,
        "outdir": str(tmp_path_factory.mktemp("api")),
    }


class _Sink(BaseHTTPRequestHandler):
    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        self.server.received.append(json.loads(body))
        self.send_response(200)
        self.end_headers()

    def log_message(self, *args):
        pass


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/analysis",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def test_service_answers_as_the_jax_package(payload):
    sink = ThreadingHTTPServer(("127.0.0.1", 0), _Sink)
    sink.received = []
    threading.Thread(target=sink.serve_forever, daemon=True).start()
    service = AnalysisService(port=0, device="cpu").start()
    try:
        assert service.device == torch.device("cpu")
        out = _post(service.port, dict(
            payload, callback_url=f"http://127.0.0.1:"
            f"{sink.server_address[1]}/hook"))
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(service.port, dict(payload, model="NotAModel"))
        assert err.value.code == 400
    finally:
        service.stop()
        sink.shutdown()
        sink.server_close()
    want = j_app.run_nmma_model(payload)
    assert sorted(out) == sorted(want) + ["webhook_status"]
    assert out["status"] == "success" and out["webhook_status"] == 200
    assert np.isfinite(out["log_evidence"])
    assert sorted(out["posterior_quantiles"]) == \
        sorted(want["posterior_quantiles"])
    assert "log10_mej" in out["posterior_quantiles"]
    assert sorted(out["bestfit"]) == sorted(want["bestfit"])
    # the values: the evidence within 3 combined standard errors; each
    # quantile and the best fit within a quarter of the JAX response's
    # p5-p95 width (exactly equal for the pinned parameters, of width 0);
    # the best fit within that width of the injection
    assert abs(out["log_evidence"] - want["log_evidence"]) <= 3.0 * np.hypot(
        out["log_evidence_err"], want["log_evidence_err"])
    for name, q in want["posterior_quantiles"].items():
        width = q["p95"] - q["p5"]
        for key in ("p5", "p50", "p95"):
            assert abs(out["posterior_quantiles"][name][key] - q[key]) \
                <= 0.25 * width, (name, key)
        assert abs(out["bestfit"][name] - want["bestfit"][name]) \
            <= 0.25 * width, name
        assert abs(out["bestfit"][name] - np.float32(TRUTH[name])) <= width
    assert sorted(out["analysis"]) == sorted(want["analysis"])
    # the callback came once, carrying the analysis
    assert len(sink.received) == 1
    assert sink.received[0]["log_evidence"] == out["log_evidence"]
    draws = np.load(io.BytesIO(base64.b64decode(
        out["analysis"]["inference_data"]["data"])))
    assert len(draws["log10_mej"]) > 50
    res = json.loads(base64.b64decode(out["analysis"]["results"]["data"]))
    assert res["log_evidence"] == out["log_evidence"]


def _skyportal_inputs(root):
    """A SkyPortal photometry csv (mjd, filter, mag, magerr), a redshift
    csv and a Me2017 prior file, written with the standard library."""
    mjd = 58000.0 + np.linspace(0.6, 6.0, 10)
    with open(root / "phot.csv", "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["mjd", "filter", "mag", "magerr"])
        for f in ("ztfg", "ztfr"):
            for t in mjd:
                w.writerow([repr(float(t)), f,
                            repr(float(19.0 + 0.5 * (t - 58000.0))),
                            0.1])
    with open(root / "z.csv", "w", newline="") as fh:
        fh.write("redshift\n0.01\n")
    (root / "Me2017.prior").write_text(
        "log10_mej = Uniform(minimum=-3., maximum=-0.5)\n"
        "log10_vej = Uniform(minimum=-2., maximum=-0.5)\n"
        "beta = 3.0\nlog10_kappa_r = 0.7\n"
        "luminosity_distance = Uniform(minimum=10., maximum=100.)\n"
        "timeshift = 0.0\n")
    return {"photometry": str(root / "phot.csv"),
            "redshift": str(root / "z.csv"),
            "prior": str(root / "Me2017.prior"),
            "analysis_parameters": {"nlive": 32, "fix_z": True}}


def test_bridge_argv_and_files_match_jax(tmp_path):
    sky = _skyportal_inputs(tmp_path)
    calls = {}

    def hook(side):
        def invoke(argv):
            calls[side] = argv
        return invoke

    want = j_sky.run_from_skyportal_inputs(sky, outdir=tmp_path / "jax",
                                           invoke=hook("jax"))
    got = t_sky.run_from_skyportal_inputs(sky, outdir=tmp_path / "port",
                                          invoke=hook("port"))
    assert got["status"] == want["status"] == "success", got["message"]
    assert sorted(got) == sorted(want)
    assert [a.replace(str(tmp_path / "port"), "OUT") for a in calls["port"]] \
        == [a.replace(str(tmp_path / "jax"), "OUT") for a in calls["jax"]]
    assert "--plot" in calls["port"] and "--device" not in calls["port"]
    assert (tmp_path / "port" / "Me2017.prior").read_bytes() == \
        (tmp_path / "jax" / "Me2017.prior").read_bytes()
    # the data files: the same times and filters; the magnitudes are the
    # csv's digits read back, by numpy here and by pandas' fast float
    # parser there, which may round the last bit the other way
    rows = [[line.split() for line in (tmp_path / side / "data.dat")
             .read_text().splitlines()] for side in ("port", "jax")]
    assert [r[:2] for r in rows[0]] == [r[:2] for r in rows[1]]
    np.testing.assert_allclose(
        [[float(v) for v in r[2:]] for r in rows[0]],
        [[float(v) for v in r[2:]] for r in rows[1]], rtol=1e-15, atol=0)
    assert "luminosity_distance = 4" in \
        (tmp_path / "port" / "Me2017.prior").read_text()

    t_sky.run_from_skyportal_inputs(sky, outdir=tmp_path / "dev",
                                    invoke=hook("dev"), device="cpu")
    assert calls["dev"][-2:] == ["--device", "cpu"]
    assert calls["dev"][:-2] == [a.replace(str(tmp_path / "port"),
                                           str(tmp_path / "dev"))
                                 for a in calls["port"]]

    bad = t_sky.run_from_skyportal_inputs(
        {**sky, "prior": str(tmp_path / "absent.prior")},
        outdir=tmp_path / "bad", invoke=hook("bad"))
    assert bad["status"] == "failure" and "not found" in bad["message"]
    assert "bad" not in calls


def test_bridge_runs_the_port_cli_on_the_cpu(tmp_path):
    """The bridge's own invoke (the port's CLI main) with device='cpu' on
    Me2017 photometry from 0.5 d after the event: the trigger is the first
    epoch, so the prior's timeshift reaches back to it; a finite evidence
    off the -1e30 sentinel, and the posterior, result, best-fit and figure
    files it points at."""
    data = create_light_curve_data(TRUTH, "Me2017", ["ztfg", "ztfr"], seed=5,
                                   sample_times=np.geomspace(0.5, 5.0, 8),
                                   device="cpu")
    sky = _skyportal_inputs(tmp_path)
    with open(tmp_path / "phot.csv", "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["mjd", "filter", "mag", "magerr"])
        for f, sub in data.items():
            for row in zip(sub["time"], sub["mag"], sub["mag_error"]):
                w.writerow([repr(58000.0 + float(row[0]))] + [f] +
                           [repr(float(v)) for v in row[1:]])
    (tmp_path / "Me2017.prior").write_text(
        "log10_mej = Uniform(minimum=-3., maximum=-0.5)\n"
        "log10_vej = -1.1\nbeta = 3.0\nlog10_kappa_r = 0.7\n"
        "luminosity_distance = 40.0\n"
        "timeshift = Uniform(minimum=-1., maximum=0.)\n")
    sky["analysis_parameters"] = {"nlive": 32, "n_tsteps": 40}
    out = t_sky.run_from_skyportal_inputs(sky, outdir=tmp_path / "run",
                                          device="cpu")
    assert out["status"] == "success", out["message"]
    assert -1e29 < out["log_bayes_factor"] < 0.0
    for key in ("posterior_file", "json_result_file", "plot_file"):
        assert out[key] and (tmp_path / "run" / out[key]).exists(), key
    assert (tmp_path / "run" / "Me2017_obj_bestfit.json").exists()
    assert (tmp_path / "run" / "Me2017_obj_result.npz").exists()
