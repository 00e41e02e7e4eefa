"""Likelihood-free inference: normalising flows, light-curve embeddings,
VICReg pre-training and the reference's pretrained similarity embedding.

Port of ``nmma_tpu/mlmodel/``. Modules are ``torch.nn`` modules,
batch-first and channels first; ``convert`` carries the JAX package's flax
weights into them.
"""

from .embedding import LightCurveEmbedding
from .flows import MaskedAutoregressiveFlow
from .inference import (ConditionalFlowNet, LFIPosterior, nnanalysis,
                        train_flow_posterior)
from .pretrained import SimilarityEmbedding
from .vicreg import (SimilarityEmbedder, augment_lightcurves,
                     pretrain_similarity_embedding, vicreg_loss)

__all__ = ["MaskedAutoregressiveFlow", "LightCurveEmbedding",
           "ConditionalFlowNet", "LFIPosterior", "train_flow_posterior",
           "nnanalysis", "SimilarityEmbedding", "SimilarityEmbedder",
           "augment_lightcurves", "pretrain_similarity_embedding",
           "vicreg_loss"]
