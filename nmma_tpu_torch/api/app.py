"""Analysis web service: POST photometry -> posterior summary.

Port of ``nmma_tpu/api/app.py`` (the reference's tornado service,
``api/app.py:49-369``, ``run_nmma_model`` with an ALLOWED_MODELS whitelist)
on the stdlib HTTP server. Each request builds its own ``EMAnalysis`` on the
service's device (the CUDA card unless the caller passes one; the service
raises without one) and runs a nested-sampling analysis there. Payload:

    {"model": "Me2017", "prior": "<.prior text>",
     "photometry": {filt: {"time": [...], "mag": [...],
                           "mag_error": [...]}},
     "trigger_time": <mjd>, "nlive": 128, ...}

Response: log-evidence, best-fit parameters, posterior quantiles, and the
``analysis`` block (the posterior draws as a base64 npz, the summary as
base64 json, and the figures of ``return_plots``, which need matplotlib).
With a ``callback_url`` the response is POSTed there once.

    python -m nmma_tpu_torch.api.app --port 4000 [--device cpu]
"""

from __future__ import annotations

import base64
import io
import json
import os
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .. import resolve_device

ALLOWED_MODELS = ("Me2017", "HoNa2020", "Piro2021", "TrPi2018",
                  "blackbody_fixedT", "PL_BB_fixedT", "synchrotron_powerlaw")


def run_nmma_model(payload: dict, device=None) -> dict:
    """One analysis of ``payload`` on ``device``; returns the response."""
    model_name = payload.get("model", "Me2017")
    if model_name not in ALLOWED_MODELS:
        raise ValueError(f"model {model_name!r} not in {ALLOWED_MODELS}")
    device = resolve_device(device)

    from ..analysis import EMAnalysis, EMAnalysisConfig
    from ..inference import NestedSamplerConfig
    from ..priors import parse_prior_dict

    data = {f: {k: np.asarray(v, dtype=float) for k, v in sub.items()}
            for f, sub in payload["photometry"].items()}
    priors = parse_prior_dict(payload["prior"])
    nlive = int(payload.get("nlive", 256))
    cfg = EMAnalysisConfig(
        model=model_name,
        trigger_time=float(payload.get("trigger_time", 0.0)),
        data_tmax=float(payload.get("data_tmax", np.inf)),
        tmin=float(payload.get("tmin", 0.01)),
        tmax=float(payload.get("tmax", 14.0)),
        error_budget=float(payload.get("error_budget", 1.0)),
        outdir=payload.get("outdir", "outdir_api"),
        label=payload.get("label", "api"),
        sampler=NestedSamplerConfig(
            nlive=nlive, n_delete=max(nlive // 8, 1),
            walks=int(payload.get("walks", 16)),
            dlogz=float(payload.get("dlogz", 0.5)),
            max_iter=int(payload.get("max_iter", 2000))),
    )
    analysis = EMAnalysis(cfg, data=data, priors=priors, device=device)
    result = analysis.run(verbose=False, checkpoint=False)
    post = analysis.posterior_samples(result)
    quantiles = {
        k: dict(zip(("p5", "p50", "p95"),
                    np.percentile(v, [5, 50, 95]).tolist()))
        for k, v in post.items() if np.ndim(v) == 1 and k != "log_likelihood"
    }
    response = {
        "status": "success",
        "message": f"Good results with log evidence={result.logz:.2f}",
        "log_evidence": result.logz,
        "log_evidence_err": result.logz_err,
        "n_likelihood_evaluations": result.ncall,
        "bestfit": analysis.bestfit_parameters(result),
        "posterior_quantiles": quantiles,
    }
    # the reference service's 'analysis' block (nmma/api/app.py:256-266:
    # arviz InferenceData netcdf, png plots and joblib results, all
    # base64): here the posterior container is a base64 npz of the complete
    # per-parameter draw arrays, and the results blob base64 json
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in post.items()
                     if np.ndim(v) == 1})
    analysis_results = {
        "inference_data": {
            "format": "npz",
            "data": base64.b64encode(buf.getvalue()).decode("ascii")},
        "results": {
            "format": "json",
            "data": base64.b64encode(json.dumps({
                "log_evidence": result.logz,
                "log_evidence_err": result.logz_err,
                "ncall": result.ncall,
                "bestfit": response["bestfit"],
                "quantiles": quantiles}).encode()).decode("ascii")},
        "plots": [],
    }
    if payload.get("return_plots"):
        from ..plotting import corner_plot, lightcurve_fit_plot
        os.makedirs(cfg.outdir, exist_ok=True)
        lc_path = lightcurve_fit_plot(analysis)
        corner_path = os.path.join(cfg.outdir, f"{cfg.label}_corner.png")
        corner_plot(post, save_path=corner_path)
        plots = {}
        for name, path in (("lightcurves", lc_path), ("corner", corner_path)):
            with open(path, "rb") as fh:
                b64 = base64.b64encode(fh.read()).decode("ascii")
            plots[name] = b64
            analysis_results["plots"].append(
                {"format": "png", "name": name, "data": b64})
        response["plots"] = plots
    response["analysis"] = analysis_results
    # the reference's webhook (upload_analysis_results): POST the response
    # to the payload's callback URL when one is given
    if payload.get("callback_url") and \
            payload.get("callback_method", "POST").upper() == "POST":
        response.update(post_webhook(payload["callback_url"], response))
    return response


def post_webhook(url: str, response: dict, timeout=30):
    """POST the analysis result to a callback URL once (reference webhook
    semantics, nmma/api/app.py). Errors are returned, not raised, so the
    analysis result is never lost to a dead callback."""
    body = json.dumps(response).encode()
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return {"webhook_status": resp.status}
    except Exception as exc:  # noqa: BLE001
        return {"webhook_status": "error", "webhook_error": str(exc)}


class _Handler(BaseHTTPRequestHandler):
    def do_POST(self):
        if self.path.rstrip("/") not in ("", "/analysis", "/analyze"):
            self.send_error(404)
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length))
            # run_nmma_model posts the webhook itself (once) when the
            # payload carries a callback_url; the handler must not post
            # again
            response = run_nmma_model(payload, device=self.server.device)
            body = json.dumps(response).encode()
            self.send_response(200)
        except Exception as exc:  # noqa: BLE001 — surface errors to client
            body = json.dumps({"status": "error",
                               "message": str(exc)}).encode()
            self.send_response(400)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # quiet
        pass


class AnalysisService:
    """Embeddable threaded HTTP service whose analyses run on ``device``
    (the CUDA card unless the caller passes one; raises without one)."""

    def __init__(self, host="127.0.0.1", port=4000, device=None):
        self.device = resolve_device(device)
        self.server = ThreadingHTTPServer((host, port), _Handler)
        self.server.device = self.device
        self.port = self.server.server_address[1]
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


def main(cli_args=None):
    import argparse
    parser = argparse.ArgumentParser("nmma_tpu_torch analysis service")
    parser.add_argument("--port", type=int, default=4000)
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA "
                             "card; 'cpu' runs on the CPU)")
    args = parser.parse_args(cli_args)
    service = AnalysisService(port=args.port, device=args.device)
    print(f"serving on :{service.port} ({service.device})")
    service.server.serve_forever()


if __name__ == "__main__":
    main()
