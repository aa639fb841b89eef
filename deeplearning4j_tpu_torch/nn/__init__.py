"""Networks: port of deeplearning4j_tpu/nn/ (configuration DSL, layers,
updaters, the two containers, `MultiLayerNetwork` and `ComputationGraph`,
and their fused steps, `fused`)."""
