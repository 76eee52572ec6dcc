"""Early stopping (the JAX package's ``earlystopping/``; ref:
deeplearning4j-nn/.../earlystopping/)."""

from deeplearning4j_tpu_torch.earlystopping.config import (  # noqa: F401
    EarlyStoppingConfiguration,
    EarlyStoppingResult,
    MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition,
    ScoreImprovementEpochTerminationCondition,
    BestScoreEpochTerminationCondition,
    InvalidScoreIterationTerminationCondition,
    DataSetLossCalculator,
    InMemoryModelSaver,
    LocalFileModelSaver,
)
from deeplearning4j_tpu_torch.earlystopping.config import (  # noqa: F401
    LocalFileModelSaver as LocalFileGraphSaver,
)
from deeplearning4j_tpu_torch.earlystopping.trainer import (  # noqa: F401
    EarlyStoppingGraphTrainer,
    EarlyStoppingListener,
    EarlyStoppingTrainer,
)
from deeplearning4j_tpu_torch.earlystopping.parallel_trainer import (  # noqa: F401
    EarlyStoppingParallelTrainer,
)
