"""Quality prediction: host features, the MLP predictor, the inline head."""

from .embed import EMBED_LEN, EMBED_VOCAB, hash_batch, hash_indices
from .features import FEATURE_DIM, extract_batch, extract_features
from .inline import (
    INLINE_DIM,
    INLINE_SLICE,
    InlinePolicyParams,
    inline_decision,
    inline_features_torch,
    policy_from_predictor,
)
from .mlp import (
    MLPQualityPredictor,
    TrainReport,
    mlp_forward,
    mlp_forward_embed,
    predictor_from_jax,
)

__all__ = [name for name in dir() if not name.startswith("_")]
