"""Launch the port's serving stack: the HTTP server and the scheduler over
one engine, ported from examples/serve.py.

    python -m deeppowers_tpu_torch.scripts.serve --model tinyllama-1.1b \
        --port 8000
    python -m deeppowers_tpu_torch.scripts.serve --model tiny-llama \
        --device cpu --port 0

Then:
    curl -s localhost:8000/v1/completions \
         -d '{"prompt": "hello", "max_tokens": 16}'
    curl -s localhost:8000/metrics

`--model` is a preset (random weights, drawn from `--seed`; the tokenizer
is the byte tokenizer, as JAX's `Model` takes `load_tokenizer(None)` for a
preset) or a checkpoint directory (runtime/checkpoint.py; its
`tokenizer.json` when it has one). The engine runs on the card unless
`--device cpu` is given (bf16 activations there, f32 on the CPU). It
takes the flags of the JAX script whose features the port has, and
`--emit-top-logprobs`; the gRPC server, multi-process serving, meshes and
the XLA compilation cache are not ported, and their flags are refused.
The first line printed after the warm-up is the server's URL.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

import torch

from ..config import (GenerationConfig, QuantConfig, QuantMode, RuntimeConfig,
                      SchedulerConfig)
from ..device import resolve_device
from ..models import transformer as T
from ..models.presets import PRESETS
from ..runtime.checkpoint import load_checkpoint
from ..runtime.engine import InferenceEngine
from ..serving.scheduler import Scheduler
from ..serving.server import APIServer
from ..serving.tokenizer import load_tokenizer

#: examples/serve.py's flags for what the port does not have yet
NOT_PORTED = {"--grpc-port": "the gRPC server (ROADMAP.md queue 1 item 8)",
              "--coordinator": "multi-process serving",
              "--num-processes": "multi-process serving",
              "--process-id": "multi-process serving",
              "--mesh": "meshes (tensor and expert parallelism)",
              "--compile-cache": "XLA's compilation cache (nothing to "
                                 "cache: kernels build once, graphs are "
                                 "captured at run time)",
              "--platform": "JAX platforms (use --device)"}

#: --quantize as JAX's `Model.apply_quantization` maps it (api.py:244-256)
QUANT = {"int8": (QuantMode.INT8, 0), "int4": (QuantMode.INT4, 8),
         "w4a16": (QuantMode.INT4, 0), "w8a8": (QuantMode.INT8, 8),
         "w4a8": (QuantMode.INT4, 8), "mixed": (QuantMode.MIXED, 0)}


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="gpt2",
                    help="preset name or checkpoint directory")
    ap.add_argument("--quantize", choices=["none"] + sorted(QUANT),
                    default="int8",
                    help="int4 is W4A8; w4a16 is weight-only int4")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="0 takes a free port")
    ap.add_argument("--auth-token", default=None)
    ap.add_argument("--ssl-certfile", default=None,
                    help="PEM cert chain: serve HTTPS (else plaintext)")
    ap.add_argument("--ssl-keyfile", default=None)
    ap.add_argument("--decode-steps", type=int, default=0,
                    help="decode steps per dispatch; 0 = the auto depth")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="verify K draft tokens a step (0 = off): prompt "
                         "lookup, or --draft")
    ap.add_argument("--draft", default=None,
                    help="draft model (preset or checkpoint directory)")
    ap.add_argument("--scan-layers", action="store_true",
                    help="stack the layers (the default 'auto' already "
                         "does for 16 or more on the contiguous layout)")
    ap.add_argument("--kv-layout", choices=["contiguous", "paged"],
                    default="contiguous")
    ap.add_argument("--kv-reserve", choices=["full", "lazy"], default="full")
    ap.add_argument("--kv-pages", type=int, default=0,
                    help="paged only: total page-pool size (0 = full)")
    ap.add_argument("--max-batch", type=int, default=32,
                    help="continuous-batching slots")
    ap.add_argument("--max-seq", type=int, default=0,
                    help="max context (0 = the model's)")
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--emit-top-logprobs", type=int, default=0, metavar="K",
                    help="return each token's top K log-probabilities")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of a preset's random weights")
    for flag, what in NOT_PORTED.items():
        ap.add_argument(flag, default=None, help=f"not ported: {what}")
    args = ap.parse_args(argv)
    for flag, what in NOT_PORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            ap.error(f"{flag}: {what} is not ported")
    return args


def load(name: str, device: torch.device, dtype: torch.dtype, seed: int):
    """(params, cfg, tokenizer) of a preset (random weights) or a
    checkpoint directory."""
    if os.path.isdir(name):
        params, cfg, _ = load_checkpoint(name, device=device, dtype=dtype)
        if cfg is None:
            raise ValueError(f"checkpoint {name} has no model config")
        path = os.path.join(name, "tokenizer.json")
        return params, cfg, load_tokenizer(path if os.path.isfile(path)
                                           else None)
    if name not in PRESETS:
        raise SystemExit(f"unknown model {name!r}: a preset "
                         f"({', '.join(sorted(PRESETS))}) or a checkpoint "
                         f"directory")
    cfg = PRESETS[name]
    gen = torch.Generator(device=device).manual_seed(seed)
    return (T.init_params(cfg, gen, dtype=dtype, device=device), cfg,
            load_tokenizer(None))


def build(args):
    """(scheduler, server) of the arguments, warmed up, not started."""
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    params, cfg, tok = load(args.model, device, dtype, args.seed)
    if args.quantize != "none":
        mode, act_bits = QUANT[args.quantize]
        params = T.quantize_params(params, QuantConfig(
            mode=mode, act_bits=act_bits,
            layer_overrides={"attention": "int8", "mlp": "int4"}
            if mode == QuantMode.MIXED else {}))
    draft = {}
    if args.draft:
        dparams, dcfg, _ = load(args.draft, device, dtype, args.seed + 1)
        draft = dict(draft_params=dparams, draft_cfg=dcfg)
    runtime = RuntimeConfig(
        max_batch_size=args.max_batch,
        max_seq_len=args.max_seq or RuntimeConfig().max_seq_len,
        decode_steps_per_dispatch=args.decode_steps,
        speculative_tokens=args.speculative,
        scan_layers=True if args.scan_layers else "auto",
        kv_reserve=args.kv_reserve, enable_prefix_cache=args.prefix_cache,
        emit_top_logprobs=args.emit_top_logprobs)
    engine = InferenceEngine(
        params, cfg, runtime=runtime, eos_token_id=tok.eos_token_id,
        act_dtype=dtype, device=device, kv_layout=args.kv_layout,
        kv_total_pages=args.kv_pages or None, **draft)
    print("warming up...", flush=True)
    engine.generate(tok.encode("warmup"), GenerationConfig(
        max_tokens=8, temperature=0.0, do_sample=False))
    sched = Scheduler(engine, encode=tok.encode, decode=tok.decode,
                      config=SchedulerConfig(), tokenizer=tok,
                      model_name=os.path.basename(args.model.rstrip("/")))
    http = APIServer(sched, host=args.host, port=args.port,
                     auth_token=args.auth_token,
                     ssl_certfile=args.ssl_certfile,
                     ssl_keyfile=args.ssl_keyfile)
    return sched, http


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    sched, http = build(args)
    sched.start()
    http.start()
    scheme = "https" if args.ssl_certfile else "http"
    print(f"{scheme}://{args.host}:{http.port}", flush=True)
    print("endpoints: /api/v1/generate /api/v1/generate_stream "
          "/api/v1/generate_batch /api/v1/generate_async /v1/completions "
          "/v1/chat/completions /v1/models /health /metrics", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        while not stop.wait(5.0):
            alerts = sched.monitor.check_alerts()
            if alerts:
                print("ALERTS:", alerts, flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        http.stop()
        sched.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
