"""Port kernels' plain versions against the JAX package's Pallas kernels.

The JAX kernels run in Pallas interpret mode on the CPU, as
tests/test_pallas_kernels.py and tests/test_decode_attention.py run them;
the port's wrappers take their plain versions for CPU tensors. Inputs are
made with numpy from fixed seeds and handed to both. The CUDA kernels
themselves run only on a card (the `cuda` marker below; chip_smoke.py
holds each against its plain version at the main path's shapes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppowers_tpu.ops.attention import attention_decode, attention_prefill
from deeppowers_tpu.ops.pallas.decode_attention import decode_attention_mxu
from deeppowers_tpu.ops.pallas.dequant_matmul import dequant_matmul_fused
from deeppowers_tpu.ops.pallas.flash_attention import flash_attention_prefill as jax_flash
from deeppowers_tpu.ops.pallas.kv_append import scatter_rows as jax_scatter_rows
from deeppowers_tpu.quant import quantize as jax_quantize

from deeppowers_tpu_torch.ops.attention import (
    attention_prefill as torch_attention_prefill)
from deeppowers_tpu_torch.ops.kernels import _build
from deeppowers_tpu_torch.ops.kernels.decode_attention import (
    decode_attention, decode_attention_plain)
from deeppowers_tpu_torch.ops.kernels.dequant_matmul import (
    dequant_matmul, dequant_matmul_plain)
from deeppowers_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_plain, flash_attention_prefill)
from deeppowers_tpu_torch.ops.kernels.kv_append import (
    scatter_rows, scatter_rows_plain)
from deeppowers_tpu_torch.quant.qtypes import QuantizedTensor

torch.set_num_threads(1)


def _bf16_pair(a: np.ndarray):
    """The same bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    return j, t


def _port_qw(qw) -> QuantizedTensor:
    return QuantizedTensor(torch.from_numpy(np.array(qw.data)),
                           torch.from_numpy(np.array(qw.scales)), None,
                           qw.bits, qw.group_size)


# (rms, glu, residual, bias, out f32): every fusion of the kernel
FUSIONS = {
    "plain_f32_out": (False, False, False, False, True),
    "plain_bf16_out": (False, False, False, False, False),
    "rms": (True, False, False, False, True),
    "glu_residual": (False, True, True, False, True),
    "residual": (False, False, True, False, True),
    "bias": (False, False, False, True, True),
    "rms_bias_bf16_out": (True, False, False, True, False),
}


@pytest.mark.parametrize("case", sorted(FUSIONS))
def test_dequant_matmul_plain_matches_pallas(case):
    rms, glu, res, bias, f32 = FUSIONS[case]
    rng = np.random.default_rng(11)
    m, k, n = 8, 256, 384
    w = jnp.asarray(rng.standard_normal((k, n)) * 0.05, jnp.float32)
    qw = jax_quantize(w, bits=8)
    xj, xt = _bf16_pair(rng.standard_normal((m, 2 * k if glu else k)))
    kw_j, kw_t = {}, {}
    if rms:
        gj, gt = _bf16_pair(1.0 + 0.2 * rng.standard_normal(k))
        kw_j.update(rms_weight=gj, rms_eps=1e-5)
        kw_t.update(rms_weight=gt, rms_eps=1e-5)
    if glu:
        kw_j["glu"] = kw_t["glu"] = True
    if res:
        rj, rt = _bf16_pair(rng.standard_normal((m, n)))
        kw_j["residual"], kw_t["residual"] = rj, rt
    if bias:
        bj, bt = _bf16_pair(0.1 * rng.standard_normal(n))
        kw_j["bias"], kw_t["bias"] = bj, bt
    jout = jnp.float32 if f32 else jnp.bfloat16
    tout = torch.float32 if f32 else torch.bfloat16
    ref = np.asarray(dequant_matmul_fused(
        xj, qw, out_dtype=jout, block_n=256, block_k=128,
        **kw_j).astype(jnp.float32))
    got = dequant_matmul(xt, _port_qw(qw), out_dtype=tout, **kw_t)
    assert got.dtype == tout and got.shape == (m, n)
    # Same bf16 activation block on both sides; left over: f32 summation
    # order, a 1-ulp f32 difference in silu flipping a bf16 rounding, and
    # the bf16 output rounding itself when the output is bf16.
    tol = 1e-3 if f32 else 1e-2
    err = np.abs(got.float().numpy() - ref).max() / np.abs(ref).max()
    assert err < tol, f"{case}: rel err {err}"


def test_dequant_matmul_plain_is_the_wrapper_on_cpu():
    rng = np.random.default_rng(3)
    qw = _port_qw(jax_quantize(jnp.asarray(rng.standard_normal((64, 32)),
                                           jnp.float32)))
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    launches = dequant_matmul.launches
    a = dequant_matmul(x, qw, out_dtype=torch.float32)
    b = dequant_matmul_plain(x, qw.data, qw.scales, out_dtype=torch.float32)
    assert torch.equal(a, b)
    assert dequant_matmul.launches == launches      # no kernel on the CPU


def test_scatter_rows_plain_matches_pallas_with_drops():
    rng = np.random.default_rng(5)
    b, s, f = 4, 32, 64
    kc = rng.standard_normal((b, s, f)).astype(np.float32)
    vc = rng.standard_normal((b, s, f)).astype(np.float32)
    kr = rng.standard_normal((b, f)).astype(np.float32)
    vr = rng.standard_normal((b, f)).astype(np.float32)
    pos = np.array([0, 31, 32, -1], np.int32)          # two dropped writes
    jk, jv = jax_scatter_rows([jnp.asarray(kc), jnp.asarray(vc)],
                              [jnp.asarray(kr), jnp.asarray(vr)],
                              jnp.asarray(pos))[:2]
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    scatter_rows(tk, tv, torch.from_numpy(kr), torch.from_numpy(vr),
                 torch.from_numpy(pos))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk[2].numpy(), kc[2])   # untouched slot


def _decode_inputs(seed, b=3, s=256, kh=2, rep=4, d=64):
    rng = np.random.default_rng(seed)
    h = kh * rep
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kc = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    vc = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    lens = np.array([1, 97, 256][:b], np.int32)          # ragged
    return q, kc, vc, lens


def test_decode_attention_plain_matches_reference_and_pallas():
    q, kc, vc, lens = _decode_inputs(7)
    b, s, kh, d = kc.shape
    got = decode_attention(torch.from_numpy(q),
                           torch.from_numpy(kc.reshape(b, s, kh * d)),
                           torch.from_numpy(vc.reshape(b, s, kh * d)),
                           torch.from_numpy(lens)).numpy()
    ref = np.asarray(attention_decode(jnp.asarray(q), jnp.asarray(kc),
                                      jnp.asarray(vc), jnp.asarray(lens)))
    # both f32 end to end: summation order only
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    kern = np.asarray(decode_attention_mxu(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
        block_s=128))
    # the TPU kernel feeds p.V to the MXU in bf16 (~3 decimal digits)
    np.testing.assert_allclose(got, kern, atol=2e-2)


def test_decode_attention_ignores_nan_past_length():
    q, kc, vc, lens = _decode_inputs(8)
    b, s, kh, d = kc.shape
    clean = decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(kc.reshape(b, s, -1)),
        torch.from_numpy(vc.reshape(b, s, -1)), torch.from_numpy(lens))
    vbad = vc.copy()
    for i, n in enumerate(lens):
        vbad[i, n:] = np.nan                      # 0 * NaN trap
    kbad = kc.copy()
    for i, n in enumerate(lens):
        kbad[i, n:] = np.nan
    got = decode_attention(torch.from_numpy(q),
                           torch.from_numpy(kbad.reshape(b, s, -1)),
                           torch.from_numpy(vbad.reshape(b, s, -1)),
                           torch.from_numpy(lens))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, clean, atol=0, rtol=0)


@pytest.mark.parametrize("s,lens,block", [(300, [300, 171], 128),
                                          (200, [57, 200], 128)])
def test_flash_plain_matches_pallas(s, lens, block):
    """S not a block multiple, lengths < S, GQA with unrepeated K/V."""
    rng = np.random.default_rng(s)
    b, h, kh, d = 2, 4, 2, 64
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    ln = np.array(lens, np.int32)
    got = flash_attention_prefill(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v),
                                  torch.from_numpy(ln)).numpy()
    kern = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(ln),
                                block_q=block, block_k=block))
    dense = np.asarray(attention_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        lengths=jnp.asarray(ln), use_flash=False))
    for i, n in enumerate(lens):                 # compare valid rows only
        np.testing.assert_allclose(got[i, :n], kern[i, :n], atol=2e-3)
        np.testing.assert_allclose(got[i, :n], dense[i, :n], atol=1e-5)
    assert np.isfinite(got).all()                # rows past the length too


def test_flash_plain_is_the_dense_path():
    """On the CPU the wrapper takes the plain version, launching nothing,
    and the port's dense prefill path (written apart from it) agrees with
    it to f32 rounding."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((1, 16, 4, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 16, 2, 8)).astype(np.float32))
    lens = torch.tensor([9])
    launches = flash_attention_prefill.launches
    plain = flash_attention_plain(q, k, k, lens)
    torch.testing.assert_close(flash_attention_prefill(q, k, k, lens), plain)
    assert flash_attention_prefill.launches == launches
    torch.testing.assert_close(torch_attention_prefill(q, k, k, lengths=lens),
                               plain, atol=1e-6, rtol=1e-5)


def test_nvcc_missing_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device):
    """Each CUDA kernel against its plain version on the card, small."""
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=cuda_device).to(dtype)

    data = torch.randint(-127, 128, (512, 256), generator=g,
                         device=cuda_device, dtype=torch.int8)
    qw = QuantizedTensor(data, torch.full((1, 256), 1e-3, device=cuda_device),
                         None, 8, 0)
    gw = rn(512)
    for m in (3, 40):                      # the GEMV and the tiled path
        x = rn(m, 512)
        got = dequant_matmul(x, qw, rms_weight=gw, out_dtype=torch.float32)
        ref = dequant_matmul_plain(x, qw.data, qw.scales, rms_weight=gw,
                                   out_dtype=torch.float32)
        assert (got - ref).abs().max() <= 2e-2 * ref.abs().max()
    kc, vc = rn(2, 128, 256), rn(2, 128, 256)
    kc2, vc2 = kc.clone(), vc.clone()
    rows, pos = rn(2, 256), torch.tensor([5, 128], device=cuda_device)
    scatter_rows(kc, vc, rows, rows, pos)
    scatter_rows_plain(kc2, vc2, rows, rows, pos)
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    q, lens = rn(2, 16, 64), torch.tensor([7, 128], device=cuda_device)
    out = decode_attention(q, kc, vc, lens)
    ref = decode_attention_plain(q, kc, vc, lens)
    assert (out.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()
    assert torch.equal(out, decode_attention(q, kc, vc, lens))  # same bytes
    kc[0, 7:], vc[0, 7:] = float("nan"), float("nan")   # stale rows
    empty = decode_attention(q, kc, vc,
                             torch.tensor([7, 0], device=cuda_device))
    assert torch.equal(empty[0], out[0]) and (empty[1] == 0).all()
    q, k = rn(1, 600, 16, 64), rn(1, 600, 4, 64)
    lens = torch.tensor([555], device=cuda_device)
    out = flash_attention_prefill(q, k, k, lens)[:, :555]
    ref = flash_attention_plain(q, k, k, lens)[:, :555]
    assert (out.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("bits,act_bits,n", [(8, 0, 2048), (4, 8, 2048),
                                             (8, 0, 40000)])
def test_cuda_gemv_is_one_launch_and_reproducible(cuda_device, bits,
                                                   act_bits, n):
    """A decode matmul on the GEMV route is one kernel launch (a8: after
    the row quantizer), with K split (N = 2048: its last block sums the
    splits) or not (N = 40000), and no epilogue kernel; the same inputs
    give the same bits twice."""
    g = torch.Generator(device=cuda_device).manual_seed(bits + n)
    k = 2048
    data = torch.randint(-127, 128, (k // 2 if bits == 4 else k, n),
                         generator=g, device=cuda_device, dtype=torch.int8)
    scales = 1e-3 * (0.5 + torch.rand((k // 128, n), generator=g,
                                      device=cuda_device))
    qw = QuantizedTensor(data, scales, None, bits, 128, act_bits)
    x = torch.randn(8, k, generator=g, device=cuda_device).to(torch.bfloat16)
    gw = torch.randn(k, generator=g, device=cuda_device).to(torch.bfloat16)
    res = torch.randn(8, n, generator=g, device=cuda_device).to(torch.bfloat16)
    first = dequant_matmul(x, qw, rms_weight=gw, residual=res)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        again = dequant_matmul(x, qw, rms_weight=gw, residual=res)
        torch.cuda.synchronize()
    assert torch.equal(first, again)
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower()
               and "memset" not in e.name.lower()]
    assert sum("gemv_kernel" in k for k in kernels) == 1, kernels
    assert not any("epilogue_kernel" in k for k in kernels), kernels
    assert len(kernels) == (2 if act_bits else 1), kernels


# (B, S, H, Kh, D, lengths, start): TinyLlama's heads at the serve
# phase's bucket; the 7B's (MHA) and Mixtral's (GQA) at D = 128; length 1
# and lengths off the 128-row tile; S off a multiple of 64; and chunks
# (start > 0, one slot, every key of the view valid) at both widths, the
# last one a chunk padded past the end of a 1024-row cache
FLASH_CASES = [(2, 512, 32, 4, 64, (300, 450), 0),
               (1, 512, 32, 32, 128, (512,), 0),
               (2, 300, 32, 8, 128, (1, 257), 0),
               (2, 200, 8, 2, 64, (57, 200), 0),
               (1, 388, 32, 4, 64, None, 512),
               (1, 100, 32, 8, 128, None, 13),
               (1, 64, 32, 32, 128, None, 700),
               (1, 512, 32, 4, 64, None, 896)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_matches_plain(cuda_device, case):
    """#4 on the card, prefill (start 0, lengths) and chunks (start > 0),
    against its plain versions on the same inputs: every valid (token,
    head) row within 1e-2 of its own max|ref| (chip_smoke.py's gate), all
    rows finite, and the entry point's launch counted."""
    from deeppowers_tpu_torch.ops.kernels import flash_attention as fa
    b, s, h, kh, d, lens, start = case
    g = torch.Generator(device=cuda_device).manual_seed(s + d + start)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device).to(
            torch.bfloat16)

    q = rn(b, s, h, d)
    if lens is None:
        rows = min(start + s + 5, 1024)
        k, v = rn(b, rows, kh, d), rn(b, rows, kh, d)
        fn = fa.flash_attention_chunk
        before = fn.launches
        out = fn(q, k, v, start)
        ref = fa.flash_attention_chunk_plain(q, k[:, :start + s],
                                             v[:, :start + s], start)
        lens = (s,) * b
    else:
        k, v = rn(b, s, kh, d), rn(b, s, kh, d)
        ln = torch.tensor(lens, device=cuda_device, dtype=torch.int32)
        fn = fa.flash_attention_prefill
        before = fn.launches
        out = fn(q, k, v, ln)
        ref = fa.flash_attention_plain(q, k, v, ln)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.isfinite(out).all()
    for i, n in enumerate(lens):
        diff = (out[i, :n].float() - ref[i, :n].float()).abs().amax(-1)
        assert (diff <= 1e-2 * ref[i, :n].float().abs().amax(-1)).all()


def test_ops_matmul_wrappers_match_jax():
    """ops/matmul.py (kernel 1's callers) against the JAX package's, f32:
    both apply the same algebra; only summation order differs."""
    from deeppowers_tpu.ops import matmul as jm
    from deeppowers_tpu_torch.ops import matmul as tm
    rng = np.random.default_rng(21)
    k, n = 128, 96
    qw = jax_quantize(jnp.asarray(rng.standard_normal((k, n)) * 0.05,
                                  jnp.float32), bits=8)
    tq = _port_qw(qw)
    x = rng.standard_normal((3, 5, k)).astype(np.float32)
    gu = rng.standard_normal((3, 5, 2 * k)).astype(np.float32)
    g = (1.0 + 0.2 * rng.standard_normal(k)).astype(np.float32)
    res = rng.standard_normal((3, 5, n)).astype(np.float32)
    f32 = jnp.float32
    cases = [
        (jm.quantized_matmul(jnp.asarray(x), qw, out_dtype=f32),
         tm.quantized_matmul(torch.from_numpy(x), tq, out_dtype=torch.float32)),
        (jm.rms_matmul(jnp.asarray(x), jnp.asarray(g), qw, eps=1e-5,
                       out_dtype=f32),
         tm.rms_matmul(torch.from_numpy(x), torch.from_numpy(g), tq, eps=1e-5,
                       out_dtype=torch.float32)),
        (jm.glu_matmul(jnp.asarray(gu), qw, residual=jnp.asarray(res),
                       out_dtype=f32),
         tm.glu_matmul(torch.from_numpy(gu), tq, residual=torch.from_numpy(res),
                       out_dtype=torch.float32)),
        (jm.matmul_residual(jnp.asarray(x), qw, jnp.asarray(res),
                            out_dtype=f32),
         tm.matmul_residual(torch.from_numpy(x), tq, torch.from_numpy(res),
                            out_dtype=torch.float32)),
    ]
    for ref, got in cases:
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-5 * np.abs(ref).max())


def test_kvcache_matches_jax():
    """runtime/kvcache.py (kernel 2's caller): prompt writes, a decode
    append with a dropped position, a window view and read, against the
    JAX package's functions."""
    from deeppowers_tpu.runtime import kvcache as jkv
    from deeppowers_tpu_torch.runtime import kvcache as tkv
    rng = np.random.default_rng(9)
    b, s, kh, d = 3, 16, 2, 8
    jc = jkv.init_cache(1, b, s, kh, d, dtype=jnp.float32)[0]
    tc = tkv.init_cache(1, b, s, kh, d, dtype=torch.float32)[0]
    kp = rng.standard_normal((8, kh, d)).astype(np.float32)
    vp = rng.standard_normal((8, kh, d)).astype(np.float32)
    jc = jkv.write_prompt(jc, jnp.asarray(kp), jnp.asarray(vp), 1)
    tkv.write_prompt(tc, torch.from_numpy(kp), torch.from_numpy(vp), 1)
    kn = rng.standard_normal((b, kh, d)).astype(np.float32)
    vn = rng.standard_normal((b, kh, d)).astype(np.float32)
    pos = np.array([3, 8, s], np.int32)                  # last one dropped
    jc = jkv.append_token(jc, jnp.asarray(kn), jnp.asarray(vn),
                          jnp.asarray(pos))
    tkv.append_token(tc, torch.from_numpy(kn), torch.from_numpy(vn),
                     torch.from_numpy(pos))
    for jw, tw in ((jc, tc), (jkv.slice_window(jc, 12),
                              tkv.slice_window(tc, 12))):
        for a, t in zip(jkv.read(jw, jnp.float32), tkv.read(tw, torch.float32)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(a))
