"""Utilities: port of deeplearning4j_tpu/util/ (so far the model zips,
`model_serializer`)."""
