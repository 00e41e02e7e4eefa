"""The port's likelihood-free-inference modules (``nmma_tpu_torch.mlmodel``)
against the JAX package's, on the CPU, with the JAX package's flax weights
carried across by ``mlmodel/convert.py``. Tolerances:

* flow ``log_prob``, the embedding and both context modes of the
  conditional net at their initial weights: rtol 1e-4 (f32; untrained
  flows scale by up to e^3 a transform, so log-probabilities reach 1e8 and
  only relative agreement means anything);
* flow ``sample`` from the same base noise: atol 1e-3;
* ``train_flow_posterior`` (context vectors, 2 transforms), 10 epochs
  from the JAX package's initial weights with the same minibatch stream:
  the trained log-probabilities within rtol 1e-3;
* ``vicreg_loss``'s four terms: rtol 1e-5; ``augment_lightcurves``: bit
  for bit; three pre-training steps from the same weights and views: the
  losses within rtol 1e-4 and the representation within atol 1e-3;
* the pretrained architecture on a seeded state dict under the reference's
  key names: rtol 1e-4 on light-curve-like inputs, 5e-4 on extreme ones
  (the bounds of tests/test_mlmodel_pretrained.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from nmma_tpu.mlmodel import vicreg as j_vicreg
from nmma_tpu.mlmodel.embedding import LightCurveEmbedding as JaxEmbedding
from nmma_tpu.mlmodel.flows import MaskedAutoregressiveFlow as JaxFlow
from nmma_tpu.mlmodel.inference import _ConditionalFlowNet as JaxNet
from nmma_tpu.mlmodel.inference import train_flow_posterior as j_train
from nmma_tpu.mlmodel.pretrained import similarity_embedding_apply
from nmma_tpu_torch.mlmodel import convert
from nmma_tpu_torch.mlmodel import vicreg as t_vicreg
from nmma_tpu_torch.mlmodel.flows import made_masks
from nmma_tpu_torch.mlmodel.inference import train_flow_posterior as t_train
from nmma_tpu_torch.mlmodel.pretrained import (SimilarityEmbedding,
                                               seeded_state_dict)

torch.set_num_threads(1)

DIM, CTX, N_F, N_T = 3, 5, 4, 24


def host(tree):
    return jax.tree_util.tree_map(np.asarray, unfreeze(tree))


def lightcurves(rng, n):
    lc = rng.normal(20.0, 1.0, (n, N_F, N_T)).astype(np.float32)
    lc[0, 1, 3:6] = np.nan              # missing epochs
    lc[1, 2, -2:] = np.inf
    return lc


def test_made_masks_are_the_jax_packages():
    from nmma_tpu.mlmodel.flows import _made_masks
    for dim, hidden in ((1, 8), (3, 16), (6, 90)):
        for got, want in zip(made_masks(dim, hidden),
                             _made_masks(dim, hidden)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("context", [False, True])
def test_flow_log_prob_and_sample_match_jax(context):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, DIM)).astype(np.float32)
    c = rng.normal(size=(16, CTX)).astype(np.float32) if context else None
    flow = JaxFlow(dim=DIM, n_transforms=3, hidden=16)
    variables = flow.init(jax.random.PRNGKey(1), x, c,
                          method=JaxFlow.log_prob)
    port = convert.flow_from_flax(host(variables), DIM, 3, 16,
                                  CTX if context else None)
    perm_rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        port.perms.numpy(),
        np.stack([perm_rng.permutation(DIM) for _ in range(3)]))
    ct = torch.tensor(c) if context else None
    want = np.asarray(flow.apply(variables, x, c, method=JaxFlow.log_prob))
    got = port.log_prob(torch.tensor(x), ct).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)

    key = jax.random.PRNGKey(3)
    c0 = c[0] if context else None
    want = np.asarray(flow.apply(variables, key, 16, c0,
                                 method=JaxFlow.sample))
    z = np.asarray(jax.random.normal(key, (16, DIM)))
    got = port.sample(16, torch.tensor(c0) if context else None,
                      z=torch.tensor(z)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_embedding_matches_jax():
    lc = lightcurves(np.random.default_rng(1), 6)
    emb = JaxEmbedding(embed_dim=20)
    variables = jax.jit(emb.init)(jax.random.PRNGKey(0), lc)
    port = convert.embedding_from_flax(host(variables), N_F)
    want = np.asarray(jax.jit(emb.apply)(variables, lc))
    got = port(torch.tensor(lc)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("raw_context", [False, True])
def test_conditional_net_matches_jax(raw_context):
    rng = np.random.default_rng(2)
    theta = rng.normal(size=(6, DIM)).astype(np.float32)
    inp = (rng.normal(size=(6, CTX)).astype(np.float32) if raw_context
           else lightcurves(rng, 6))
    net = JaxNet(dim=DIM, n_transforms=2, hidden=16, raw_context=raw_context)
    if raw_context:
        variables = net.init(jax.random.PRNGKey(2), theta, inp,
                             method=JaxNet.log_prob)
    else:
        # the net's tree from its parts: the ConvNet initialised under jit
        # (flax's eager init compiles op by op), the flow on its output
        emb = JaxEmbedding(embed_dim=20)
        emb_vars = jax.jit(emb.init)(jax.random.PRNGKey(2), inp)
        flow = JaxFlow(dim=DIM, n_transforms=2, hidden=16)
        flow_vars = flow.init(jax.random.PRNGKey(3), theta,
                              jax.jit(emb.apply)(emb_vars, inp),
                              method=JaxFlow.log_prob)
        variables = {"params": {"embedding": emb_vars["params"],
                                "flow": flow_vars["params"]}}
    port = convert.conditional_flow_from_flax(host(variables), DIM,
                                              inp.shape[1], n_transforms=2,
                                              hidden=16,
                                              raw_context=raw_context)
    want = np.asarray(jax.jit(lambda v, t, x: net.apply(
        v, t, x, method=JaxNet.log_prob))(variables, theta, inp))
    got = port.log_prob(torch.tensor(theta),
                        torch.tensor(inp)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_flow_training_matches_jax():
    rng = np.random.default_rng(3)
    n = 64
    theta = rng.normal(size=(n, DIM)).astype(np.float32)
    # context vectors that carry theta, so training has something to learn
    ctx = (theta @ rng.normal(size=(DIM, CTX))
           + 0.1 * rng.normal(size=(n, CTX))).astype(np.float32)
    names = ["a", "b", "c"]
    kw = dict(n_transforms=2, hidden=16, n_epochs=10, batch_size=16, seed=0,
              verbose=False, raw_context=True)
    want = j_train(theta, ctx, names, **kw)
    # the JAX package's initial weights: its key split, its init call
    mean, std = theta.mean(0), theta.std(0) + 1e-8
    z = jnp.asarray((theta - mean) / std)
    _, init_key = jax.random.split(jax.random.PRNGKey(0))
    net = JaxNet(dim=DIM, n_transforms=2, hidden=16, raw_context=True)
    start = net.init(init_key, z[:2], jnp.asarray(ctx[:2]),
                     method=JaxNet.log_prob)
    got = t_train(theta, ctx, names, device="cpu",
                  init_net=convert.conditional_flow_from_flax(
                      host(start), DIM, CTX, n_transforms=2, hidden=16,
                      raw_context=True), **kw)
    a = np.asarray(net.apply(want.params, z, ctx, method=JaxNet.log_prob))
    b = got.net.log_prob(torch.tensor(np.asarray(z)),
                         torch.tensor(ctx)).detach().numpy()
    a0 = np.asarray(net.apply(start, z, ctx, method=JaxNet.log_prob))
    assert np.abs(a - a0).max() > 1e-2        # the 10 epochs did train
    np.testing.assert_allclose(b, a, rtol=1e-3)
    np.testing.assert_allclose(got.theta_mean, want.theta_mean, rtol=1e-6)
    draws = got.sample(50, ctx[0], generator=torch.Generator().manual_seed(0))
    assert sorted(draws) == names and draws["a"].shape == (50,)


def test_flow_training_rounds_epochs_up_to_whole_blocks():
    """Fault 3g, fixed in the port: verbose training runs exactly
    n_epochs epochs (13 run 13, where the JAX package's whole blocks of
    13 // 5 run 15), and its weights equal the silent run's, which draws
    the same minibatches."""
    rng = np.random.default_rng(4)
    theta = rng.normal(size=(20, 1)).astype(np.float32)
    ctx = rng.normal(size=(20, 2)).astype(np.float32)
    steps = []
    orig = torch.optim.Adam.step

    def count(self, *a, **k):
        steps.append(1)
        return orig(self, *a, **k)

    runs = {}
    for n_epochs, verbose in ((7, True), (13, True), (13, False)):
        steps.clear()
        torch.optim.Adam.step = count
        try:
            runs[n_epochs, verbose] = t_train(
                theta, ctx, ["a"], n_epochs=n_epochs, batch_size=8,
                verbose=verbose, raw_context=True, device="cpu")
        finally:
            torch.optim.Adam.step = orig
        assert len(steps) == n_epochs
    for a, b in zip(runs[13, True].net.parameters(),
                    runs[13, False].net.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_vicreg_loss_and_augmentation_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(32, 7)).astype(np.float32)
    y = rng.normal(size=(32, 7)).astype(np.float32)
    want = j_vicreg.vicreg_loss(x, y, wt_repr=25.0, wt_std=25.0)
    got = t_vicreg.vicreg_loss(torch.tensor(x), torch.tensor(y),
                               wt_repr=25.0, wt_std=25.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    lcs = lightcurves(rng, 8)
    np.testing.assert_array_equal(
        t_vicreg.augment_lightcurves(np.random.default_rng(6), lcs),
        j_vicreg.augment_lightcurves(np.random.default_rng(6), lcs))


def test_vicreg_pretraining_matches_jax():
    lcs = lightcurves(np.random.default_rng(7), 48)
    j_emb, j_params, j_hist = j_vicreg.pretrain_similarity_embedding(
        lcs, n_epochs=1, batch_size=16, seed=0, verbose=False)
    start = j_vicreg.SimilarityEmbedder().init(jax.random.PRNGKey(0),
                                               jnp.asarray(lcs[:2]))
    port, hist = t_vicreg.pretrain_similarity_embedding(
        lcs, n_epochs=1, batch_size=16, seed=0, verbose=False, device="cpu",
        init_embedder=convert.similarity_embedder_from_flax(host(start),
                                                            N_F))
    assert len(hist) == len(j_hist) == 3
    np.testing.assert_allclose(hist, j_hist, rtol=1e-4)
    np.testing.assert_allclose(port.represent(lcs),
                               np.asarray(j_emb.apply(j_params, lcs)[1]),
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("inputs", ["lightcurves", "extreme"])
def test_pretrained_architecture_matches_jax(inputs):
    sd = seeded_state_dict(3)
    port = SimilarityEmbedding()
    port.load_state_dict(sd)
    assert "layers_f.conv1.weight" in sd and "layer_norm.weight" in sd
    rng = np.random.default_rng(8)
    if inputs == "lightcurves":
        x, tol = rng.uniform(14.0, 22.0, (8, 3, 121)).astype(np.float32), 1e-4
    else:
        x, tol = rng.normal(0.0, 30.0, (8, 3, 121)).astype(np.float32), 5e-4
    params = {k: v.numpy() for k, v in sd.items()}
    j_out, j_rep = jax.jit(similarity_embedding_apply)(params, x)
    with torch.no_grad():
        out, rep = port(torch.tensor(x))
    np.testing.assert_allclose(rep.numpy(), np.asarray(j_rep), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=tol,
                               atol=tol)


def test_pretrained_loads_a_saved_state_dict_with_any_dead_pair(tmp_path):
    sd = seeded_state_dict(4)
    sd["layer_norm.weight"] = torch.ones(3, 121)   # dead: any shape loads
    sd["layer_norm.bias"] = torch.zeros(3, 121)
    torch.save(sd, tmp_path / "weights.pth")
    model = SimilarityEmbedding.load(tmp_path / "weights.pth", device="cpu")
    x = np.random.default_rng(9).uniform(14, 22, (5, 3, 121))
    rep = model.represent(x)
    assert rep.shape == (5, 7) and np.isfinite(rep).all()
    assert np.std(rep, axis=0).max() > 1e-3
