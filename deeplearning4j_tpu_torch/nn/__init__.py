"""Networks: port of deeplearning4j_tpu/nn/ (configuration DSL, layers,
updaters and the two containers, `MultiLayerNetwork` and
`ComputationGraph`)."""
