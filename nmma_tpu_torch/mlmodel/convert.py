"""Weights carried across: the JAX package's flax parameter trees into the
port's modules.

Each function takes the tree as nested dicts of numpy arrays (``variables``
or ``variables["params"]``, as ``flax.core.unfreeze`` and ``np.asarray``
leave them) and returns the port's module with those weights. Dense kernels
[in, out] become Linear weights [out, in]; Conv kernels [K, Cin, Cout]
become Conv1d weights [Cout, Cin, K].
"""

from __future__ import annotations

import numpy as np
import torch

from .embedding import LightCurveEmbedding
from .flows import MaskedAutoregressiveFlow
from .inference import ConditionalFlowNet, RawContextProjection
from .vicreg import SimilarityEmbedder


def _params(tree):
    return tree["params"] if "params" in tree else tree


def _dense(layer, tree, conv=False):
    """Copy a flax Dense (or, with ``conv``, Conv) kernel and bias into a
    Linear (Conv1d)."""
    k = np.asarray(tree["kernel"], dtype=np.float32)
    w = k.transpose(2, 1, 0) if conv else k.T
    with torch.no_grad():
        layer.weight.copy_(torch.tensor(np.ascontiguousarray(w)))
        layer.bias.copy_(torch.tensor(np.asarray(tree["bias"],
                                                 dtype=np.float32)))


def load_flow(flow: MaskedAutoregressiveFlow, tree):
    """Copy a ``MaskedAutoregressiveFlow`` tree (blocks_i / MaskedDense_j,
    Dense_j) into ``flow``."""
    tree = _params(tree)
    for i, block in enumerate(flow.blocks):
        b = tree[f"blocks_{i}"]
        _dense(block.inp, b["MaskedDense_0"])
        _dense(block.out, b["MaskedDense_1"])
        if block.ctx_hidden is not None:
            _dense(block.ctx_hidden, b["Dense_0"])
            _dense(block.ctx_out, b["Dense_1"])
    return flow


def load_embedding(emb: LightCurveEmbedding, tree):
    """Copy a ``LightCurveEmbedding`` tree (ResBlock1D_i / Conv_j, Dense_j)
    into ``emb``."""
    tree = _params(tree)
    for i, block in enumerate(emb.blocks):
        b = tree[f"ResBlock1D_{i}"]
        _dense(block.conv0, b["Conv_0"], conv=True)
        _dense(block.conv1, b["Conv_1"], conv=True)
        if block.proj is not None:
            _dense(block.proj, b["Conv_2"], conv=True)
    _dense(emb.dense0, tree["Dense_0"])
    _dense(emb.dense1, tree["Dense_1"])
    return emb


def flow_from_flax(tree, dim, n_transforms, hidden=90, context_dim=None):
    """A ``MaskedAutoregressiveFlow`` with the tree's weights."""
    return load_flow(MaskedAutoregressiveFlow(dim, n_transforms, hidden,
                                              context_dim), tree)


def embedding_from_flax(tree, n_filters, embed_dim=20, channels=32):
    """A ``LightCurveEmbedding`` with the tree's weights."""
    return load_embedding(LightCurveEmbedding(n_filters, embed_dim, channels),
                          tree)


def conditional_flow_from_flax(tree, dim, n_inputs, n_transforms=6,
                               hidden=90, embed_dim=20, raw_context=False):
    """A ``ConditionalFlowNet`` (either context mode) with the weights of a
    ``_ConditionalFlowNet`` tree; ``n_inputs`` is the light curves' filter
    count, or with ``raw_context`` the context vectors' width."""
    tree = _params(tree)
    net = ConditionalFlowNet(dim, n_inputs, n_transforms, hidden, embed_dim,
                             raw_context)
    if raw_context:
        emb: RawContextProjection = net.embedding
        _dense(emb.dense0, tree["embedding"]["Dense_0"])
        _dense(emb.dense1, tree["embedding"]["Dense_1"])
    else:
        load_embedding(net.embedding, tree["embedding"])
    load_flow(net.flow, tree["flow"])
    return net


def similarity_embedder_from_flax(tree, n_filters, num_dim=7,
                                  num_dim_final=10, num_hidden_layers_h=1,
                                  expander_hidden=20, trunk_channels=32):
    """A ``SimilarityEmbedder`` with the weights of the JAX package's."""
    tree = _params(tree)
    emb = SimilarityEmbedder(n_filters, num_dim, num_dim_final,
                             num_hidden_layers_h, expander_hidden,
                             trunk_channels)
    load_embedding(emb.trunk, tree["LightCurveEmbedding_0"])
    _dense(emb.contraction, tree["Dense_0"])
    for i, layer in enumerate(emb.expander):
        _dense(layer, tree[f"Dense_{1 + i}"])
    _dense(emb.final, tree[f"Dense_{1 + len(emb.expander)}"])
    return emb
