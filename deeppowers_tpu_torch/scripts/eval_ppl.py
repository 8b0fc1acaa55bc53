"""The Δppl acceptance gate on a local checkpoint, ported from
scripts/eval_ppl.py.

    python -m deeppowers_tpu_torch.scripts.eval_ppl --checkpoint moelm_ckpt
    python -m deeppowers_tpu_torch.scripts.eval_ppl --synthetic --device cpu

Perplexity of the float reference against each quantized recipe on a text
(the checkpoint's own `ppl_eval.txt` by default): the weight rows through
the teacher-forced prefill (runtime/evaluate.py `perplexity`), the KV rows
through the decode path over a quantized cache (`cached_perplexity`), and
for a model with experts the served MoE layouts (the cat experts of
`fuse_params`: grouped-cat prefill, cat decode). The gate is the JAX
script's: the worst Δppl of the gated rows against an absolute 0.1 on a
checkpoint, or `max(gate, 1e-3 * ppl_ref)` under `--synthetic` (random
weights, whose perplexity is near the vocabulary's size); exit code 1
above it. The gated rows are JAX's: the shipped recipes int8, W8A8, int4
g128 + GPTQ and W4A8 g128 + GPTQ, the KV rows over the W4A8 GPTQ weights
(but int4 KV) and the MoE layouts over them; round-to-nearest int4 and
AWQ are diagnostic. GPTQ and AWQ calibrate on `--calib-seqs` sequences
(0: 4, or 16 for a model with experts) drawn from beyond the evaluated
ones where the text allows, as JAX's script draws them; GPTQ runs on the
evaluation device (quant/gptq.py). The port has no expert parallelism
yet (ROADMAP.md, queue 1 item 9): the EP row prints as not ported.

`--device` is `cuda` by default (it raises where no card is found): there
the hand-written kernels run, on bf16 activations (`--dtype bf16`, the
default on the card; quantized weights with f32 activations raise). On
`--device cpu` the port's CPU functions run, f32 by default. The last line
of the output is one JSON object with every row, the device and the dtype.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from ..config import QuantConfig, QuantMode
from ..device import resolve_device
from ..models import transformer as T
from ..quant.gptq import collect_xtx, gptq_quantize
from ..quant.smooth import awq_quantize
from ..runtime.checkpoint import load_checkpoint
from ..runtime.evaluate import cached_perplexity, perplexity
from ..serving.tokenizer import ByteTokenizer

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
NOT_PORTED = {"ep": "not ported (ROADMAP.md queue 1 item 9: expert "
                    "parallelism)"}


def sequences(token_ids: List[int], seq_len: int) -> List[List[int]]:
    """Consecutive windows of seq_len tokens (the last may be shorter),
    those of fewer than 2 tokens dropped (JAX `_sequences`)."""
    return [token_ids[i:i + seq_len]
            for i in range(0, len(token_ids) - 1, seq_len)
            if len(token_ids[i:i + seq_len]) >= 2]


def synthetic(max_seqs: int, seq_len: int, device):
    """Random-init tiny-llama (vocab 512) and a uniform random corpus, as
    the JAX script's harness self-check (its weights are the port's own
    draw, not JAX's)."""
    from ..models.presets import tiny_llama_config
    cfg = tiny_llama_config(vocab_size=512, max_seq_len=512)
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = T.init_params(cfg, gen, dtype=torch.float32, device="cpu")
    params = _to(params, device)
    rng = np.random.RandomState(0)
    ids = rng.randint(2, 512, size=(max_seqs * seq_len,)).tolist()
    return params, cfg, ids


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def load(path: str, text: Optional[str], device):
    """(params f32, cfg, token ids, text path) of a native checkpoint.
    A HuggingFace directory raises: models/hf_import.py is not ported."""
    if not os.path.exists(os.path.join(path, "manifest.json")):
        raise SystemExit(f"{path}: HuggingFace checkpoints are not yet "
                         f"ported (ROADMAP.md queue 1 item 10); a native "
                         f"checkpoint has a manifest.json")
    params, cfg, extra = load_checkpoint(path, device=device,
                                         dtype=torch.float32)
    if extra.get("trained", {}).get("tokenizer") != "byte":
        raise SystemExit(f"{path}: only the byte tokenizer is ported")
    if not text:
        text = os.path.join(path, "ppl_eval.txt")
        if not os.path.exists(text):
            raise SystemExit("--text required with --checkpoint")
    with open(text, encoding="utf-8") as f:
        ids = ByteTokenizer().encode(f.read())
    return params, cfg, ids, text


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", help="native checkpoint directory")
    ap.add_argument("--text", help="UTF-8 text file for evaluation")
    ap.add_argument("--synthetic", action="store_true",
                    help="random-init tiny model + synthetic corpus")
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--max-seqs", type=int, default=16)
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--calib-seqs", type=int, default=0,
                    help="calibration sequences for GPTQ / AWQ (0: 4 "
                         "dense, 16 with experts, whose per-expert "
                         "Hessians see about 1/E of the tokens)")
    ap.add_argument("--gate", type=float, default=0.1,
                    help="max allowed delta_ppl (exit 1 above)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default=None,
                    help="activations: bf16 (the card's default) or f32 "
                         "(the CPU's)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dname = args.dtype or ("bf16" if device.type == "cuda" else "f32")
    dtype = DTYPES[dname]
    t_start = time.perf_counter()

    if args.synthetic or not args.checkpoint:
        if args.checkpoint:
            raise SystemExit("--checkpoint and --synthetic are exclusive")
        params, cfg, ids = synthetic(args.max_seqs, args.seq_len, device)
        print("synthetic harness check (random-init tiny-llama; measures "
              "quantizer numerics, not language quality)")
    else:
        params, cfg, ids, args.text = load(args.checkpoint, args.text, device)
        print(f"checkpoint {args.checkpoint}: {cfg.num_layers} layers, "
              f"vocab {cfg.vocab_size}")
    all_seqs = sequences(ids, args.seq_len)
    seqs = all_seqs[:args.max_seqs]
    ncal = args.calib_seqs or (16 if cfg.num_experts else 4)
    # calibration from beyond the evaluated sequences where the text
    # allows (no overlap), else from them (JAX's script :164-173)
    calib = all_seqs[args.max_seqs:args.max_seqs + ncal]
    if len(calib) < ncal:
        calib = (calib + seqs)[:ncal]
    print(f"{len(seqs)} sequences of <= {args.seq_len} tokens on {device} "
          f"({dname} activations; +{len(calib)} calibration)")
    rows = []

    def row(name, ppl, ref, gated, path, note=None, width=22):
        d = ppl - ref
        rows.append({"name": name, "ppl": ppl, "delta": d, "gated": gated,
                     "path": path, **({"note": note} if note else {})})
        tag = "  [gated]" if gated else (f"  [{note}]" if note else "")
        print(f"{name:<{width}} ppl {ppl:8.4f}  delta {d:+.4f}{tag}",
              flush=True)

    def not_ported(name, why, width=22):
        rows.append({"name": name, "ppl": None, "delta": None,
                     "gated": False, "note": NOT_PORTED[why]})
        print(f"{name:<{width}} {NOT_PORTED[why]}", flush=True)

    ref_name = "fp32 reference" if dtype == torch.float32 else \
        "bf16 reference"
    ppl_ref = perplexity(params, cfg, seqs, dtype=dtype)
    print(f"{ref_name:<22} ppl {ppl_ref:8.4f}", flush=True)

    g = args.group_size

    def qcfg(mode, group=0, act_bits=0):
        return QuantConfig(mode=mode, group_size=group, act_bits=act_bits)

    def quantized(mode, group=0, act_bits=0):
        return T.quantize_params(params, qcfg(mode, group, act_bits))

    # both GPTQ recipes walk the same Hessians of the float model (their
    # collection timed with the first); the W4A8 one is the shipped recipe,
    # which the KV and MoE rows run on too
    t0 = time.perf_counter()
    xtx = collect_xtx(params, cfg, calib)
    gptq_s, qp_gptq = [], {}
    for act_bits in (0, 8):
        qp_gptq[act_bits] = gptq_quantize(
            params, cfg, calib, qcfg(QuantMode.INT4, g, act_bits), stats=xtx)
        gptq_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
    qp_ship = qp_gptq[8]

    weight_rows = [
        ("int8 per-channel", lambda: quantized(QuantMode.INT8), True),
        (f"int4 g{g}", lambda: quantized(QuantMode.INT4, g), False),
        (f"int4 g{g} + AWQ", lambda: awq_quantize(
            params, cfg, calib, qcfg(QuantMode.INT4, g)), False),
        (f"int4 g{g} + GPTQ", lambda: qp_gptq[0], True),
        (f"W4A8 g{g}", lambda: quantized(QuantMode.INT4, g, 8), False),
        (f"W4A8 g{g} + GPTQ", lambda: qp_ship, True),
        ("W8A8", lambda: quantized(QuantMode.INT8, 0, 8), True),
    ]
    for name, build, gated in weight_rows:
        note = None if gated else ("diagnostic: AWQ" if "AWQ" in name
                                   else "diagnostic: round-to-nearest")
        row(name, perplexity(build(), cfg, seqs, dtype=dtype), ppl_ref,
            gated, "prefill", note)

    print("--- KV-cache gate (decode path, cached forward) ---")
    kv_ref_name = "fp32 KV (control)" if dtype == torch.float32 else \
        "bf16 KV (control)"
    ppl_kv_ref = cached_perplexity(params, cfg, seqs, dtype=dtype)
    print(f"{kv_ref_name:<22} ppl {ppl_kv_ref:8.4f}  delta "
          f"{ppl_kv_ref - ppl_ref:+.4f} vs prefill", flush=True)
    kv_rows = [
        ("bf16 weights + int8 KV", params, "int8"),
        ("bf16 weights + int4 KV", params, "int4"),
        ("bf16 weights + k8v4 KV", params, "k8v4"),
        (f"W4A8 g{g} GPTQ + int8 KV", qp_ship, "int8"),
        (f"W4A8 g{g} GPTQ + k8v4 KV", qp_ship, "k8v4"),
        (f"W4A8 g{g} GPTQ + int4 KV", qp_ship, "int4"),
    ]
    if args.synthetic:
        # the harness self-check runs one bf16-weight and one combined row
        kv_rows = [kv_rows[2], kv_rows[4]]
    for name, p, kvd in kv_rows:
        # int4 KV is diagnostic (JAX's gate fired on it; k8v4 ships)
        gated = kvd != "int4"
        row(name, cached_perplexity(p, cfg, seqs, kv_cache_dtype=kvd,
                                    dtype=dtype),
            ppl_kv_ref, gated, f"decode, {kvd} KV",
            None if gated else "diagnostic: int4 KV", width=26)

    if cfg.num_experts:
        print("--- MoE paths: grouped-cat prefill / cat decode / EP ---")
        fused = T.fuse_params(qp_ship, cfg)
        if "experts_cat" not in fused["layers"][0].get("moe", {}):
            raise RuntimeError("cat fuse did not apply")
        row(f"W4A8 g{g} GPTQ grouped-cat prefill",
            perplexity(fused, cfg, seqs, dtype=dtype), ppl_ref, True,
            "prefill, cat experts", width=34)
        row(f"W4A8 g{g} GPTQ cat decode + int8 KV",
            cached_perplexity(fused, cfg, seqs, kv_cache_dtype="int8",
                              dtype=dtype),
            ppl_kv_ref, True, "decode, cat experts, int8 KV", width=34)
        not_ported(f"W4A8 g{g} GPTQ EP=2 prefill", "ep", width=34)

    worst = max([r["delta"] for r in rows if r["gated"]], default=0.0)
    worst = max(worst, 0.0)
    gate = args.gate if args.checkpoint else max(args.gate, 1e-3 * ppl_ref)
    status = "PASS" if worst <= gate else "FAIL"
    print(f"gate (gated rows the port has): worst delta_ppl {worst:+.4f} vs "
          f"limit {gate:.4g} -> {status}")
    print(json.dumps({
        "checkpoint": args.checkpoint, "synthetic": bool(args.synthetic or
                                                         not args.checkpoint),
        "text": args.text, "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "dtype": dname, "sequences": len(seqs), "seq_len": args.seq_len,
        "reference": {"name": ref_name, "ppl": ppl_ref},
        "kv_reference": {"name": kv_ref_name, "ppl": ppl_kv_ref},
        "rows": rows, "gate": gate, "worst_delta": worst, "status": status,
        "calibration": len(calib), "gptq_seconds": gptq_s,
        "seconds": time.perf_counter() - t_start}), flush=True)
    return 1 if status == "FAIL" else 0


if __name__ == "__main__":
    sys.exit(main())
