from .early_stopping import (BestScoreEpochTerminationCondition,
                             DataSetLossCalculator,
                             EarlyStoppingConfiguration,
                             EarlyStoppingGraphTrainer, EarlyStoppingResult,
                             EarlyStoppingTrainer, InMemoryModelSaver,
                             InvalidScoreIterationTerminationCondition,
                             LocalFileModelSaver,
                             MaxEpochsTerminationCondition,
                             MaxScoreIterationTerminationCondition,
                             MaxTimeIterationTerminationCondition,
                             ScoreImprovementEpochTerminationCondition)

__all__ = [
    "BestScoreEpochTerminationCondition", "DataSetLossCalculator",
    "EarlyStoppingConfiguration", "EarlyStoppingGraphTrainer",
    "EarlyStoppingResult", "EarlyStoppingTrainer", "InMemoryModelSaver",
    "InvalidScoreIterationTerminationCondition", "LocalFileModelSaver",
    "MaxEpochsTerminationCondition", "MaxScoreIterationTerminationCondition",
    "MaxTimeIterationTerminationCondition",
    "ScoreImprovementEpochTerminationCondition",
]
