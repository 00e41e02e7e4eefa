"""The reference's shipped LFI similarity embedding as a torch module.

Port of ``nmma_tpu/mlmodel/pretrained.py``: the architecture of the
reference's ``SimilarityEmbedding`` (nmma/mlmodel/embedding.py:140-178 over
the 1-D ResNet of resnet.py:228-468) in its shipped configuration (3 bands x
121 times, kernel 5, layers [2, 2], context 100, similarity dim 7, final dim
5), with the reference's ``state_dict`` keys (``layers_f.conv1.weight``,
...), so ``similarity_embedding_weights.pth`` loads with ``load_state_dict``:

  Conv1d(3->64, k7, s2, p3, no bias) -> ChannelNorm -> relu
  MaxPool1d(k3, s2, p1)
  2 x BasicBlock(64, k5)
  BasicBlock(64->128, k5, s2, 1x1 downsample) + BasicBlock(128, k5)
  mean over time -> Linear(128->100)       (layers_f.fc)
  Linear(100->7)                           (contraction_layer: representation)
  tanh(Linear(7->20)) -> tanh(Linear(20->20)) -> Linear(20->5)

ChannelNorm is per-channel normalisation over time with a (C, 1) affine.
The state dict's ``layer_norm.{weight,bias}`` pair is dead: the reference's
forward never applies it. It is accepted whatever its shape, and never used.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import resolve_device


class ChannelNorm(nn.Module):
    """Per-channel statistics over time (reference resnet.py:29-56)."""

    def __init__(self, channels, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, 1))
        self.bias = nn.Parameter(torch.zeros(channels, 1))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        sq_mean = (x * x).mean(-1, keepdim=True)
        scale = self.weight / torch.sqrt(sq_mean - mean * mean + self.eps)
        return (self.bias - scale * mean) + x * scale


class BasicBlock(nn.Module):
    """conv-norm-relu-conv-norm plus the (downsampled) input -> relu
    (reference resnet.py:136-153)."""

    def __init__(self, in_ch, out_ch, kernel=5, stride=1):
        super().__init__()
        pad = (kernel - 1) // 2
        self.conv1 = nn.Conv1d(in_ch, out_ch, kernel, stride, pad, bias=False)
        self.bn1 = ChannelNorm(out_ch)
        self.conv2 = nn.Conv1d(out_ch, out_ch, kernel, 1, pad, bias=False)
        self.bn2 = ChannelNorm(out_ch)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                nn.Conv1d(in_ch, out_ch, 1, stride, bias=False),
                ChannelNorm(out_ch))

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class ResNet1D(nn.Module):
    def __init__(self, in_ch=3, kernel=5, context=100):
        super().__init__()
        self.conv1 = nn.Conv1d(in_ch, 64, 7, 2, 3, bias=False)
        self.bn1 = ChannelNorm(64)
        self.residual_layers = nn.ModuleList([
            nn.Sequential(BasicBlock(64, 64, kernel),
                          BasicBlock(64, 64, kernel)),
            nn.Sequential(BasicBlock(64, 128, kernel, stride=2),
                          BasicBlock(128, 128, kernel))])
        self.fc = nn.Linear(128, context)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = nn.functional.max_pool1d(x, 3, 2, 1)
        for layer in self.residual_layers:
            x = layer(x)
        return self.fc(x.mean(-1))


class _DeadPair(nn.Module):
    """Holds the state dict's unused ``layer_norm`` weight and bias, of
    whatever shape the file gives them."""

    def __init__(self, size):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(size))
        self.bias = nn.Parameter(torch.zeros(size))

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        for name in ("weight", "bias"):
            key = prefix + name
            if key in state_dict:
                setattr(self, name, nn.Parameter(
                    state_dict[key].detach().clone().to(
                        getattr(self, name).device)))
            elif strict:
                missing_keys.append(key)


class SimilarityEmbedding(nn.Module):
    """light curves [B, 3, 121] -> (out [B, 5], representation [B, 7])."""

    def __init__(self, num_dim=7, num_dim_final=5, kernel=5, context=100,
                 expander_hidden=20):
        super().__init__()
        self.layers_f = ResNet1D(3, kernel, context)
        self.contraction_layer = nn.Linear(context, num_dim)
        self.expander_layer = nn.Linear(num_dim, expander_hidden)
        self.layers_h = nn.ModuleList([nn.Linear(expander_hidden,
                                                 expander_hidden)])
        self.final_layer = nn.Linear(expander_hidden, num_dim_final)
        self.layer_norm = _DeadPair(num_dim)

    def forward(self, x):
        rep = self.contraction_layer(self.layers_f(x))
        h = torch.tanh(self.expander_layer(rep))
        for layer in self.layers_h:
            h = torch.tanh(layer(h))
        return self.final_layer(h), rep

    @classmethod
    def load(cls, path, device=None):
        """The module with the state dict saved at ``path`` (the
        reference's ``similarity_embedding_weights.pth``) on ``device``."""
        device = resolve_device(device)
        model = cls()
        model.load_state_dict(torch.load(path, map_location="cpu",
                                         weights_only=True))
        return model.to(device).eval()

    @torch.no_grad()
    def represent(self, lcs, batch=8192):
        """The representation [N, 7] (numpy) of inputs [N, 3, 121]."""
        device = self.final_layer.weight.device
        lcs = np.asarray(lcs, dtype=np.float32)
        return np.concatenate([
            self(torch.as_tensor(lcs[i:i + batch], device=device))[1]
            .cpu().numpy() for i in range(0, len(lcs), batch)])


def seeded_state_dict(seed=0):
    """A state dict of the shipped architecture's keys and shapes with
    seeded values (torch's default initialisation, ChannelNorm affines drawn
    near 1 and 0), for checks while the real weights are not at hand."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = SimilarityEmbedding()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ChannelNorm):
                m.weight.copy_(1.0 + 0.1 * torch.randn(m.weight.shape,
                                                       generator=gen))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
    return model.state_dict()
