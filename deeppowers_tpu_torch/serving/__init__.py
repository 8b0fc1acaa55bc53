"""Serving pipeline: requests, queue, continuous-batching scheduler,
metrics, HTTP server, tokenizers and structured-output guides (host-only
code copied from deeppowers_tpu/serving and adapted)."""
