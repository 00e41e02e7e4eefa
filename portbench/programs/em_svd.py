"""The program of an EM configuration on an SVD surrogate: the surrogate
file that the configuration's ``surrogate`` names is registered through the
port's public registration under the configuration's model name, and the
analysis is then built as ``em.py`` builds it."""

from __future__ import annotations

import os

from portbench.programs import em


def build(spec, data_path, prior_path, out_dir, seed, device, root):
    from nmma_tpu_torch.models import SVDModelData, make_svd_source_model

    cfg = spec.config
    make_svd_source_model(cfg["model"], SVDModelData.load(
        os.path.join(root, cfg["surrogate"]["file"]), device=device))
    return em.build(spec, data_path, prior_path, out_dir, seed, device, root)
