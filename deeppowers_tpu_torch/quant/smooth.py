"""Activation-aware weight smoothing (SmoothQuant / AWQ) for low-bit
quantization, ported from deeppowers_tpu/quant/smooth.py.

Per-input-channel scales s_j divide the activation path and multiply the
weight rows, which is exact in floating point and moves quantization
resolution to where the activations are large:

    y = (x / s) @ (diag(s) W)

The division folds into the preceding norm's weight (and bias), so the
served model pays nothing. Four edges:

  ln1 -> wq/wk/wv      (fold into the norm weight)
  ln2 -> w_in/w_gate   (fold into the norm weight)
  v   -> wo            (fold into wv's output columns; GQA-constrained so
                        q-heads sharing a kv head share scales: exact)
  up  -> w_out         (GLU models only: fold into w_in's output columns)

plus AWQ's per-(group, column) clip search. The statistics come from a
layer-by-layer forward of float weights over calibration prompts on the
params' device (`calibration_forward`: the port's own transformer
functions, the dense prefill attention as JAX passes `use_flash=False`),
in f32. The small per-channel vectors (scales, absmax) are computed with
numpy on the host, as JAX computes them, so that the CPU's results are
JAX's bit for bit; the folds and the clip search run in torch on the
weights' device.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from ..models import transformer as T
from ..models.transformer import TransformerConfig
from ..ops.attention import attention_dense
from ..ops.rotary import apply_rope


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _device(params) -> torch.device:
    return params["embedding"].device


def calibration_batch(sample_ids: Sequence[Sequence[int]], device):
    """(ids (B, S), lengths (B,), positions (B, S), valid (B, S, 1)): the
    prompts padded with 0 to the longest."""
    pad_to = max(len(s) for s in sample_ids)
    b = len(sample_ids)
    ids = np.zeros((b, pad_to), dtype=np.int64)
    lens = np.zeros((b,), dtype=np.int64)
    for i, sq in enumerate(sample_ids):
        ids[i, :len(sq)] = sq
        lens[i] = len(sq)
    ids_t = torch.from_numpy(ids).to(device)
    lens_t = torch.from_numpy(lens).to(device)
    pos = torch.arange(pad_to, device=device)
    positions = pos.expand(b, pad_to)
    valid = (pos[None, :] < lens_t[:, None])[..., None]
    return ids_t, lens_t, positions, valid


def calibration_forward(params: Any, cfg: TransformerConfig,
                        sample_ids: Sequence[Sequence[int]], *,
                        dtype=torch.float32) -> Iterator[Tuple]:
    """The float model's forward over padded prompts, layer by layer, as
    JAX's calibration forwards run it (smooth.py :60-78, gptq.py :111-
    181). Yields (layer, valid, stage) for each layer at three points:
    ("ln1", xn), ("attn", attention output (B, S, q_size)), ("ln2", xn2);
    the caller's `send` is ignored. The residual stream advances through
    wo and the layer's FFN (`T._ffn`) after the "ln2" stage, or through
    the tensor the caller returns from the "ln2" yield's `send` (the GLU
    collectors compute the MLP themselves). Ends with ("final", x)."""
    ids, lens, positions, valid = calibration_batch(sample_ids,
                                                    _device(params))
    b, s = ids.shape
    x = T._embed(params, cfg, ids, positions, dtype)
    for layer in params["layers"]:
        ap = layer["attn"]
        xn = T._norm(x, layer["ln1"], cfg)
        yield layer, valid, ("ln1", xn)
        q, k, v = T._qkv(xn, ap, cfg)
        if cfg.positions == "rope":
            q = apply_rope(q, positions, theta=cfg.rope_theta)
            k = apply_rope(k, positions, theta=cfg.rope_theta)
        attn = attention_dense(q, k, v, lengths=lens).reshape(b, s,
                                                             cfg.q_size)
        yield layer, valid, ("attn", attn)
        x = x + T._dense(attn, ap["wo"])
        xn2 = T._norm(x, layer["ln2"], cfg)
        ffn = yield layer, valid, ("ln2", xn2)
        x = x + (ffn if ffn is not None else T._ffn(xn2, layer, cfg))
    yield None, valid, ("final", x)


def _glu_inter(xn2, mlp, cfg):
    """act(xn2 @ w_gate) * (xn2 @ w_in) and the MLP's output (JAX
    smooth.py :219-224, gptq.py :136-142)."""
    up = T._dense(xn2, mlp["w_in"])
    gate = T._act(T._dense(xn2, mlp["w_gate"]), cfg)
    inter = gate * up
    return inter, T._dense(inter, mlp["w_out"])


def _is_glu(layer, cfg) -> bool:
    return "mlp" in layer and cfg.glu and "w_gate" in layer["mlp"]


def collect_norm_stats(params: Any, cfg: TransformerConfig,
                       sample_ids: Sequence[Sequence[int]],
                       *, dtype=torch.float32) -> List[Dict[str, np.ndarray]]:
    """Per-layer per-channel absmax of the ln1 / ln2 outputs over the
    prompts: [{"ln1": (H,), "ln2": (H,)} per layer], f32 numpy."""
    stats: List[Dict[str, np.ndarray]] = []
    st: Dict[str, np.ndarray] = {}
    for _, valid, (stage, t) in calibration_forward(params, cfg, sample_ids,
                                                    dtype=dtype):
        if stage in ("ln1", "ln2"):
            st[stage] = _host(torch.where(valid, t, 0.0).abs().amax((0, 1)))
        if stage == "ln2":
            stats.append(st)
            st = {}
    return stats


def _smooth_scales(act_absmax: np.ndarray, w_absmax: np.ndarray,
                   alpha: float) -> np.ndarray:
    """AWQ-style balance: s_j = act^alpha / w^(1-alpha), centred in log
    space and clipped to [1e-3, 1e3] (numpy f32, JAX :84-92)."""
    act = np.maximum(act_absmax, 1e-5)
    w = np.maximum(w_absmax, 1e-5)
    s = act ** alpha / w ** (1 - alpha)
    s = s / np.sqrt(s.max() * s.min())
    return np.asarray(np.clip(s, 1e-3, 1e3), dtype=np.float32)


def _row_absmax(nodes) -> np.ndarray:
    """max over the nodes of each weight row's absmax, f32 numpy."""
    return np.maximum.reduce([_host(n["w"].float().abs().amax(1))
                              for n in nodes])


def _scale_rows(w: torch.Tensor, s: np.ndarray) -> torch.Tensor:
    st = torch.from_numpy(s).to(w.device)
    return (w.float() * st[:, None]).to(w.dtype)


def _fold_norm(node, s: np.ndarray):
    st = torch.from_numpy(s)
    d = dict(node)
    for key in ("w", "b"):
        if key in node:
            d[key] = (node[key].float() / st.to(node[key].device)).to(
                node[key].dtype)
    return d


def smooth_params(params: Any, cfg: TransformerConfig,
                  stats: List[Dict[str, np.ndarray]],
                  *, alpha: float = 0.5) -> Any:
    """Fold smoothing scales into the norm weights and the projections
    after them: exact in fp, model(smooth(params)) == model(params).
    Needs unfused projections (before `fuse_params`)."""
    out = dict(params)
    out["layers"] = []
    for layer, st in zip(params["layers"], stats):
        layer = dict(layer)
        ap = dict(layer["attn"])
        if "wqkv" in ap:
            raise ValueError("smooth_params must run before fuse_params")
        s1 = _smooth_scales(st["ln1"], _row_absmax(
            [ap[k] for k in ("wq", "wk", "wv")]), alpha)
        layer["ln1"] = _fold_norm(layer["ln1"], s1)
        for key in ("wq", "wk", "wv"):
            ap[key] = dict(ap[key], w=_scale_rows(ap[key]["w"], s1))
        layer["attn"] = ap
        if "mlp" in layer:
            mlp = dict(layer["mlp"])
            keys = [k for k in ("w_in", "w_gate") if k in mlp]
            s2 = _smooth_scales(st["ln2"], _row_absmax(
                [mlp[k] for k in keys]), alpha)
            layer["ln2"] = _fold_norm(layer["ln2"], s2)
            for key in keys:
                mlp[key] = dict(mlp[key], w=_scale_rows(mlp[key]["w"], s2))
            layer["mlp"] = mlp
        out["layers"].append(layer)
    return out


def smooth_quantize(params: Any, cfg: TransformerConfig,
                    sample_ids: Sequence[Sequence[int]], qcfg,
                    *, alpha: float = 0.5) -> Any:
    """Calibrate -> smooth -> quantize in one call."""
    stats = collect_norm_stats(params, cfg, sample_ids)
    return T.quantize_params(smooth_params(params, cfg, stats, alpha=alpha),
                             qcfg)


# ---------------------------------------------------------------------------
# The full AWQ recipe: 4-edge smoothing + per-(group, column) clip search
# ---------------------------------------------------------------------------

def collect_awq_stats(params: Any, cfg: TransformerConfig,
                      sample_ids: Sequence[Sequence[int]],
                      *, dtype=torch.float32, max_rows: int = 64
                      ) -> List[Dict[str, Any]]:
    """Per-layer activation statistics for smoothing and the clip search:
    [{"ln1", "ln2", "wo_in", "wout_in": absmax vectors (f32 numpy),
    "rows_ln1", "rows_wo", "rows_ln2", "rows_wout": the first max_rows
    valid activation rows, (R, .) f32 tensors on the params' device} per
    layer]; wout_in / rows_wout for GLU MLPs only."""
    stats: List[Dict[str, Any]] = []
    st: Dict[str, Any] = {}
    take = None
    names = {"ln1": ("ln1", "rows_ln1"), "attn": ("wo_in", "rows_wo"),
             "ln2": ("ln2", "rows_ln2")}

    def absmax_rows(t, valid):
        t = torch.where(valid, t, 0.0)
        return (_host(t.abs().amax((0, 1))),
                t.reshape(-1, t.shape[-1]).float()[take])

    gen = calibration_forward(params, cfg, sample_ids, dtype=dtype)
    ffn = None
    while True:
        try:
            layer, valid, (stage, t) = gen.send(ffn)
        except StopIteration:
            break
        ffn = None
        if stage == "final":
            continue
        if take is None:
            take = torch.nonzero(valid.reshape(-1)).reshape(-1)[:max_rows]
        a, r = names[stage]
        st[a], st[r] = absmax_rows(t, valid)
        if stage == "ln2":
            if _is_glu(layer, cfg):
                inter, ffn = _glu_inter(t, layer["mlp"], cfg)
                st["wout_in"], st["rows_wout"] = absmax_rows(inter, valid)
            stats.append(st)
            st = {}
    return stats


def _fold_dense_cols(node, inv_s: np.ndarray):
    """Scale a dense param dict's output columns (and bias) by inv_s."""
    d = dict(node)
    st = torch.from_numpy(inv_s)
    d["w"] = (node["w"].float() * st.to(node["w"].device)[None, :]).to(
        node["w"].dtype)
    if "b" in d:
        d["b"] = (node["b"].float() * st.to(node["b"].device)).to(
            node["b"].dtype)
    return d


def smooth_params_ex(params: Any, cfg: TransformerConfig,
                     stats: List[Dict[str, Any]], *, alpha: float = 0.5,
                     extended: bool = True):
    """`smooth_params` plus the wo and w_out edges. Returns (params, the
    per-layer smoothing scales {"s1", "s2", "s_wo", "s_out"} as f32
    numpy), the scales that let the clip search divide its activation
    rows to match the smoothed model. Exact in fp."""
    base = smooth_params(params, cfg, stats, alpha=alpha)
    scales_out: List[Dict[str, np.ndarray]] = []
    out = dict(base)
    out["layers"] = []
    for layer, raw_layer, st in zip(base["layers"], params["layers"], stats):
        ap = dict(layer["attn"])
        sc: Dict[str, np.ndarray] = {"s1": _smooth_scales(
            st["ln1"], _row_absmax([raw_layer["attn"][k]
                                    for k in ("wq", "wk", "wv")]), alpha)}
        if "mlp" in layer:
            keys = [k for k in ("w_in", "w_gate") if k in raw_layer["mlp"]]
            sc["s2"] = _smooth_scales(st["ln2"], _row_absmax(
                [raw_layer["mlp"][k] for k in keys]), alpha)
        if extended and "wo_in" in st:
            # v -> wo: one scale a wo input channel, shared by the q heads
            # of a kv head (exact under GQA)
            hq, kv, d = cfg.num_heads, cfg.kv_heads, cfg.dim_head
            s_raw = _smooth_scales(st["wo_in"], _row_absmax([ap["wo"]]),
                                   alpha)
            rep = hq // kv
            s_kv = np.exp(np.log(s_raw.reshape(kv, rep, d)).mean(axis=1))
            s_exp = np.repeat(s_kv[:, None, :], rep, axis=1).reshape(hq * d)
            ap["wv"] = _fold_dense_cols(ap["wv"], 1.0 / s_kv.reshape(-1))
            ap["wo"] = dict(ap["wo"], w=_scale_rows(ap["wo"]["w"], s_exp))
            sc["s_wo"] = s_exp
        layer = dict(layer)
        layer["attn"] = ap
        if (extended and "wout_in" in st and "mlp" in layer
                and "w_gate" in layer["mlp"]):
            # up -> w_out (GLU): fold into w_in's output columns
            mlp = dict(layer["mlp"])
            s_out = _smooth_scales(st["wout_in"], _row_absmax([mlp["w_out"]]),
                                   alpha)
            mlp["w_in"] = _fold_dense_cols(mlp["w_in"], 1.0 / s_out)
            mlp["w_out"] = dict(mlp["w_out"],
                                w=_scale_rows(mlp["w_out"]["w"], s_out))
            layer["mlp"] = mlp
            sc["s_out"] = s_out
        out["layers"].append(layer)
        scales_out.append(sc)
    return out, scales_out


def search_clip_scales(w: torch.Tensor, x_rows: torch.Tensor, *, bits: int,
                       group_size: int, n_grid: int = 10,
                       min_ratio: float = 0.5) -> torch.Tensor:
    """AWQ's clip search: per-(group, column) quantization scales from the
    clip ratio (1 down to min_ratio in n_grid steps) whose reconstruction,
    weighted by the activation rows x_rows (R, K), errs least; the first
    ratio wins ties. w: (K, N) float. Returns f32 scales shaped as
    `compute_scales` gives them ((G, N) grouped, (1, N) per-channel), on
    w's device. The ratios and the quantization are JAX's f32 arithmetic;
    the activation-weighted error is a batched product in f32 (its sums'
    order is PyTorch's, so a cell whose two best ratios err within f32
    rounding of each other may pick the other)."""
    w = w.detach().float()
    k, n = w.shape
    g = group_size if group_size else k
    if k % g:
        g = k
    ng = k // g
    x = x_rows.to(device=w.device, dtype=torch.float32)
    qmax = 7 if bits == 4 else 127
    qmin = -qmax - 1
    wg = w.reshape(ng, g, n)
    xg = x.reshape(-1, ng, g).transpose(0, 1)             # (G, R, g)
    absmax = wg.abs().amax(1).clamp_min(1e-8)             # (G, N)
    qmax_t = torch.tensor(float(qmax), device=w.device)
    best_err = best_scales = None
    for i in range(n_grid):
        ratio = np.float32(1.0 - i * (1.0 - min_ratio) / max(n_grid - 1, 1))
        scales = absmax * torch.tensor(ratio, device=w.device) / qmax_t
        q = torch.round(wg / scales[:, None, :]).clamp(qmin, qmax)
        err = torch.bmm(xg, q * scales[:, None, :] - wg)  # (G, R, N)
        err = (err * err).mean(1)                         # (G, N)
        if best_err is None:
            best_err, best_scales = err, scales
        else:
            better = err < best_err
            best_err = torch.where(better, err, best_err)
            best_scales = torch.where(better, scales, best_scales)
    return best_scales


def awq_quantize(params: Any, cfg: TransformerConfig,
                 sample_ids: Sequence[Sequence[int]], qcfg,
                 *, alpha: float = 0.5, clip: bool = True,
                 max_rows: int = 64, n_grid: int = 10) -> Any:
    """The full AWQ recipe: calibrate -> 4-edge smoothing -> per-group clip
    search -> quantize. Weights without collected activations (MoE
    experts and router, embeddings) stay as they are, and the lm_head
    quantizes plainly, as in JAX (:344-427)."""
    from ..config import QuantMode
    from .quantize import quantize

    stats = collect_awq_stats(params, cfg, sample_ids, max_rows=max_rows)
    smoothed, sm_scales = smooth_params_ex(params, cfg, stats, alpha=alpha)
    if not clip:
        return T.quantize_params(smoothed, qcfg)
    bits_of = {QuantMode.INT8: 8, QuantMode.INT4: 4}

    def clip_quantize(node, kind, rows):
        mode = qcfg.mode_for_layer(kind)
        if mode not in bits_of:
            return node
        w = node["w"]
        bits = bits_of[mode]
        kdim = w.shape[0]
        gs = qcfg.group_size if (qcfg.group_size
                                 and kdim % qcfg.group_size == 0) else 0
        if bits == 4 and kdim % 2:
            return node
        scales = search_clip_scales(w, rows, bits=bits, group_size=gs,
                                    n_grid=n_grid)
        qt = quantize(w.float(), bits=bits, group_size=gs, symmetric=True,
                      scales=scales)
        if qcfg.act_bits == 8:
            qt.act_bits = 8
        return dict(node, w=qt)

    def divided(rows, s):
        return rows / torch.from_numpy(s).to(rows.device)[None, :]

    out = dict(smoothed)
    out["layers"] = []
    for li, (layer, st, sc) in enumerate(zip(smoothed["layers"], stats,
                                             sm_scales)):
        if any(frag in f"layers/{li}" for frag in qcfg.skip_layers):
            out["layers"].append(layer)
            continue
        layer = dict(layer)
        ap = dict(layer["attn"])
        rows1 = divided(st["rows_ln1"], sc["s1"])
        for key in ("wq", "wk", "wv"):
            ap[key] = clip_quantize(ap[key], "attention", rows1)
        rows_wo = (divided(st["rows_wo"], sc["s_wo"]) if "s_wo" in sc
                   else st["rows_wo"])
        ap["wo"] = clip_quantize(ap["wo"], "attention", rows_wo)
        layer["attn"] = ap
        if "mlp" in layer and "s2" in sc:
            mlp = dict(layer["mlp"])
            rows2 = divided(st["rows_ln2"], sc["s2"])
            for key in ("w_in", "w_gate"):
                if key in mlp:
                    mlp[key] = clip_quantize(mlp[key], "mlp", rows2)
            if "s_out" in sc:
                mlp["w_out"] = clip_quantize(
                    mlp["w_out"], "mlp", divided(st["rows_wout"],
                                                 sc["s_out"]))
            elif "rows_wout" in st:
                mlp["w_out"] = clip_quantize(mlp["w_out"], "mlp",
                                             st["rows_wout"])
            else:
                # no intermediate rows (not a GLU): plain quantization
                sub = T.quantize_params(
                    {"layers": [{"mlp": {"w_out": mlp["w_out"]}}]}, qcfg)
                mlp["w_out"] = sub["layers"][0]["mlp"]["w_out"]
            layer["mlp"] = mlp
        out["layers"].append(layer)
    if "lm_head" in out:
        sub = T.quantize_params({"lm_head": out["lm_head"], "layers": []},
                                qcfg)
        out["lm_head"] = sub["lm_head"]
    return out
