"""Quality prediction: host features, the MLP predictor and its training,
the ensemble predictor, the inline head, training data."""

from .data import (
    TrainingSample,
    generate_from_engines,
    generate_synthetic,
    load_samples,
    ngram_similarity,
    save_samples,
)
from .embed import EMBED_LEN, EMBED_VOCAB, hash_batch, hash_indices
from .ensemble import EnsembleQualityPredictor, ensemble_from_jax
from .features import FEATURE_DIM, extract_batch, extract_features
from .inline import (
    INLINE_DIM,
    INLINE_SLICE,
    InlinePolicyParams,
    inline_decision,
    inline_features_torch,
    policy_from_predictor,
    train_inline_predictor,
)
from .mlp import (
    MLPQualityPredictor,
    TrainReport,
    mlp_forward,
    mlp_forward_embed,
    predictor_from_jax,
)

__all__ = [name for name in dir() if not name.startswith("_")]
