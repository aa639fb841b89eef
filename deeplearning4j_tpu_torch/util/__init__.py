"""Utilities: port of deeplearning4j_tpu/util/ (the model zips,
`model_serializer`, the training-state checkpoints of replicated state,
`sharded_checkpoint`, and `model_guesser`, which loads whichever model or
configuration a file holds)."""
