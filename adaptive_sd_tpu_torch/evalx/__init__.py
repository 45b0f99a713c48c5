from .baselines import (
    BaselinePolicy,
    BaselineReport,
    CascadeBaseline,
    FixedStageBaseline,
    OracleBaseline,
    RandomBaseline,
    ThresholdBaseline,
    default_baseline_suite,
    evaluate_baselines,
    stage_quality,
)
from .quality import (
    ComprehensiveQualityEvaluator,
    bleu,
    creativity_score,
    factual_consistency,
    math_accuracy,
    reasoning_score,
    rouge_l,
    rouge_n,
    soft_token_f1,
    token_f1,
)
from .stats import (
    RigorousEvaluator,
    StatisticalResult,
    generate_publication_table,
)
from .datasets import evaluate_answers, load_frozen, load_samples, score_item
from .sweep import (
    EvalSample,
    LambdaSweepHarness,
    SweepPoint,
    load_dataset,
    synthetic_dataset,
)
from .workload import make_workload, realize_goodness, tier_capabilities
from .oracle import (
    expected_gate_constrained_assignments,
    gate_constrained_assignments,
    oracle_assignments,
)

__all__ = [name for name in dir() if not name.startswith("_")]
