"""Utilities: port of deeplearning4j_tpu/util/ (so far the model zips,
`model_serializer`, and the training-state checkpoints of replicated
state, `sharded_checkpoint`)."""
