"""Training tools: port of deeplearning4j_tpu/optimize/ (the listeners,
the full-batch solvers; `profiler` is imported on its own, as in the
reference)."""
from .listeners import (CollectScoresIterationListener,
                        ComposableIterationListener, IterationListener,
                        PerformanceListener, ScoreIterationListener,
                        TrainingListener)
from .solvers import (LBFGS, BackTrackLineSearch, ConjugateGradient,
                      LineGradientDescent, Solver)

__all__ = ["BackTrackLineSearch", "CollectScoresIterationListener",
           "ComposableIterationListener", "ConjugateGradient",
           "IterationListener", "LBFGS", "LineGradientDescent",
           "PerformanceListener", "ScoreIterationListener", "Solver",
           "TrainingListener"]
