"""Parallel training helpers (port of deeplearning4j_tpu/parallel/); only
what the ported models use so far."""
