"""Serving pipeline: requests, queue, continuous-batching scheduler,
metrics, HTTP server, byte tokenizer (host-only code copied from
deeppowers_tpu/serving and adapted)."""
