"""Typed configuration, ported from deeppowers_tpu/config.py.

Same dataclasses, fields, defaults and JSON round-trip as the JAX package.
The JAX module imported jax.numpy only for a default dtype, which the
port does not need. RuntimeConfig keeps every field so configs round-trip
unchanged; one of them names machinery not ported yet
(`seq_parallel_prefill`), and the port's engine raises NotImplementedError
when it differs from its default (runtime/engine.py
`UNPORTED_RUNTIME_DEFAULTS`). `GenerationConfig.guide` carries a compiled
structured-output guide (serving/structured.py), which the engine honours.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence


class QuantMode(str, enum.Enum):
    """Weight/activation quantization mode."""

    NONE = "none"
    INT8 = "int8"
    INT4 = "int4"
    FP16 = "fp16"
    MIXED = "mixed"    # per-layer-kind overrides via QuantConfig.layer_overrides


class CalibrationMethod(str, enum.Enum):
    """How activation/weight ranges are estimated during calibration."""

    MINMAX = "minmax"
    PERCENTILE = "percentile"
    MSE = "mse"
    ENTROPY = "entropy"
    KL_DIVERGENCE = "kl_divergence"


@dataclass(frozen=True)
class QuantConfig:
    """Quantization scheme for a model or a tensor.

    group_size: 0 => per-channel over the whole contraction axis; g > 0 =>
    per-group of g elements along the contraction axis.
    """

    mode: QuantMode = QuantMode.INT8
    group_size: int = 0
    symmetric: bool = True
    calibration: CalibrationMethod = CalibrationMethod.MINMAX
    percentile: float = 99.9
    layer_overrides: Mapping[str, str] = field(default_factory=dict)
    skip_layers: Sequence[str] = ()
    # KV-cache storage dtype: "bf16" | "int8" | "int4"
    kv_cache_dtype: str = "bf16"
    # 0 = weight-only quantization, 8 = dynamic int8 activations (W8A8)
    act_bits: int = 0

    def __post_init__(self):
        object.__setattr__(self, "layer_overrides", _freeze(self.layer_overrides))
        object.__setattr__(self, "skip_layers", tuple(self.skip_layers))

    def mode_for_layer(self, kind: str) -> QuantMode:
        if self.mode != QuantMode.MIXED:
            return self.mode
        return QuantMode(dict(self.layer_overrides).get(kind, "none"))


class _FrozenDict(dict):
    def __hash__(self):
        return hash(tuple(sorted(self.items())))

    def _blocked(self, *a, **k):
        raise TypeError("config mapping is frozen")

    __setitem__ = __delitem__ = update = pop = clear = _blocked  # type: ignore


def _freeze(m: Mapping[str, Any]) -> "_FrozenDict":
    return _FrozenDict(m)


@dataclass(frozen=True)
class GenerationConfig:
    """Per-request generation parameters."""

    max_tokens: int = 100
    min_tokens: int = 0
    temperature: float = 0.7
    top_k: int = 50
    top_p: float = 0.9
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    do_sample: bool = True
    stop_tokens: Sequence[str] = ()
    stop_token_ids: Sequence[int] = ()
    num_return_sequences: int = 1
    seed: int | None = None
    stream: bool = False
    # OpenAI-style additive logit bias {token_id: bias}
    logit_bias: Mapping[int, float] | None = None
    # compiled structured-output guide (serving/structured.py `Guide`)
    guide: Any | None = None

    def __post_init__(self):
        object.__setattr__(self, "stop_tokens", tuple(self.stop_tokens))
        object.__setattr__(self, "stop_token_ids", tuple(self.stop_token_ids))

    def validate(self) -> None:
        """Raise ValueError on invalid parameters."""
        if self.max_tokens <= 0:
            raise ValueError(f"max_tokens must be positive, got {self.max_tokens}")
        if not 0.0 <= self.temperature <= 2.0:
            raise ValueError(f"temperature must be in [0, 2], got {self.temperature}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.repetition_penalty <= 0.0:
            raise ValueError(
                f"repetition_penalty must be positive, got {self.repetition_penalty}")
        if self.logit_bias:
            from .ops.sampling import LOGIT_BIAS_SLOTS
            if len(self.logit_bias) > LOGIT_BIAS_SLOTS:
                raise ValueError(
                    f"logit_bias supports at most {LOGIT_BIAS_SLOTS} "
                    f"entries, got {len(self.logit_bias)}")


@dataclass(frozen=True)
class RuntimeConfig:
    """Engine-level runtime knobs (field set of the JAX package)."""

    max_batch_size: int = 32
    max_seq_len: int = 2048
    prefill_chunk_size: int = 512
    # Pad prefill lengths up to one of these buckets.
    prefill_buckets: Sequence[int] = (32, 64, 128, 256, 512, 1024, 2048)
    request_timeout_s: float = 600.0
    enable_profiling: bool = False
    kv_page_size: int = 128
    kv_reserve: str = "full"
    kv_lazy_slack: int = 64
    enable_prefix_cache: bool = False
    decode_steps_per_dispatch: int = 1
    # Enqueue decode dispatch n + 1 before harvesting dispatch n.
    pipelined_dispatch: bool = True
    # Batch the prefills of an admission round into per-bucket groups.
    batched_admission: bool = True
    emit_top_logprobs: int = 0
    speculative_tokens: int = 0
    speculative_ngram: int = 3
    speculative_min_accepted: float = 0.0
    speculative_probe_steps: int = 50
    seq_parallel_prefill: bool = False
    # As the JAX engine reads it (runtime/engine.py `_scan_policy`): "auto"
    # stacks the layers of a model with >= 16 of them on the contiguous
    # layout (the stacked cache, runtime/kvcache_stacked.py) and stays
    # unrolled when they do not stack; True stacks them or raises; False
    # keeps per-layer caches.
    scan_layers: object = "auto"

    def __post_init__(self):
        object.__setattr__(self, "prefill_buckets", tuple(self.prefill_buckets))


@dataclass(frozen=True)
class SchedulerConfig:
    """Continuous-batching scheduler limits."""

    max_batch_size: int = 32
    max_queue_size: int = 1000
    max_active_requests: int = 100
    batch_timeout_ms: float = 10.0
    max_wait_time_ms: float = 100.0
    enable_priority: bool = True
    enable_admission_control: bool = True


def config_to_json(cfg: Any) -> str:
    """Serialize any of the dataclass configs to JSON."""

    def default(o):
        if isinstance(o, enum.Enum):
            return o.value
        if dataclasses.is_dataclass(o):
            return dataclasses.asdict(o)
        if isinstance(o, (tuple, set)):
            return list(o)
        raise TypeError(f"cannot serialize {type(o)}")

    if getattr(cfg, "guide", None) is not None:
        cfg = dataclasses.replace(
            cfg, guide=getattr(cfg.guide, "key", None) or "<guide>")
    return json.dumps(dataclasses.asdict(cfg), default=default, indent=2)


def config_from_json(cls, payload: str):
    """Deserialize a dataclass config from JSON produced by config_to_json."""
    raw = json.loads(payload)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in raw.items():
        if key not in fields:
            continue
        ftype = fields[key].type
        if isinstance(ftype, str):
            if "QuantMode" in ftype:
                value = QuantMode(value)
            elif "CalibrationMethod" in ftype:
                value = CalibrationMethod(value)
        kwargs[key] = value
    return cls(**kwargs)

