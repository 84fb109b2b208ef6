"""The arithmetic of the MRF kernel (K1) on the CPU: its TF32 split, the
three TF32 passes its float32 path takes, and the layout of the weights
`pack_stage` hands it.

The kernel rounds with `cvt.rna.tf32.f32` and clears the low 13 bits;
`tf32_split` does the same on the CPU, so a plain emulation of the 3-pass
products over a whole MRF stack shows what the kernel's float32 path can
reach. TF32 × TF32 products are exact in float32, so float32 convolutions
of the split operands emulate the tensor cores' products. The kernel itself
is held to the plain version on the card in tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpu_tts_torch.ops import hifigan_mrf

torch.set_num_threads(1)


def _stage(C, seed, dtype=torch.float32, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5)):
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    return hifigan_mrf.pack_stage(
        [
            [(rnd(C, C, k, scale=(C * k) ** -0.5), rnd(C, scale=0.1), rnd(C, C, k, scale=(C * k) ** -0.5),
              rnd(C, scale=0.1), d) for d in dilations]
            for k in kernel_sizes
        ],
        dtype,
    )


def _emulated_stack(x, stage, passes):
    """The MRF stack with every conv product taken as the kernel takes it:
    lo·hi + hi·lo + hi·hi of the TF32 split operands (passes = 3), or hi·hi
    alone (passes = 1), summed in float32."""

    def conv(h, w, b, d):
        k = w.shape[-1]
        (hh, hl), (wh, wl) = hifigan_mrf.tf32_split(h), hifigan_mrf.tf32_split(w)

        def f(a, ww):
            return F.conv1d(a, ww, padding=(k // 2) * d, dilation=d)

        y = f(hh, wh) if passes == 1 else f(hl, wh) + f(hh, wl) + f(hh, wh)
        return y + b[None, :, None]

    acc = None
    for units in stage.blocks:
        h = x
        for u in units:
            t = conv(F.leaky_relu(h, hifigan_mrf.LRELU_SLOPE), u.w1, u.b1, u.d)
            h = h + conv(F.leaky_relu(t, hifigan_mrf.LRELU_SLOPE), u.w2, u.b2, 1)
        acc = h if acc is None else acc + h
    return acc / len(stage.blocks)


def test_tf32_split_rounds_to_nearest_and_rebuilds_x():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(200_000) * np.exp(rng.uniform(-20, 20, 200_000))).astype(np.float32))
    hi, lo = hifigan_mrf.tf32_split(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0  # 10 mantissa bits kept
    # nearest: |x − hi| is at most half a TF32 step of |x|'s binade (2^-11 relative to its power of two)
    step = torch.exp2(torch.floor(torch.log2(x.abs())) - 10)
    assert bool(((x - hi).abs() <= step / 2).all())
    assert float(((hi.double() + lo.double() - x.double()).abs() / x.abs().double()).max()) <= 2.0**-22
    # ties go away from zero, for both signs
    base = torch.tensor([1.0, 3.0, 1e-3, 12345.0], dtype=torch.float32).view(torch.int32) & ~0x1FFF
    tie = (base | 0x1000).view(torch.float32)
    up = (base + 0x2000).view(torch.float32)
    assert torch.equal(hifigan_mrf.tf32_split(tie)[0], up)
    assert torch.equal(hifigan_mrf.tf32_split(-tie)[0], -up)
    # values already in TF32 split into themselves and zero
    assert torch.equal(hifigan_mrf.tf32_split(hi)[0], hi) and not hifigan_mrf.tf32_split(hi)[1].any()


@pytest.mark.parametrize("passes,bound", [(3, 1e-5), (1, None)])
def test_three_tf32_passes_keep_float32_accuracy(passes, bound):
    """Over a whole VITS-like stack (k 3/7/11, d 1/3/5) at C = 32, T = 1024,
    three passes stay within 1e-5 of the float32 plain version; one pass
    misses the float32 bar of 2e-4 (tests/test_hifigan_pallas.py)."""
    stage = _stage(32, seed=1)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 32, 1024)).astype(np.float32))
    ref = hifigan_mrf.mrf_stack_reference(x, stage)
    err = float((_emulated_stack(x, stage, passes) - ref).abs().max())
    assert float(ref.abs().max()) > 1.0
    if bound is not None:
        assert err <= bound
    else:
        assert err > 2e-4


@pytest.mark.parametrize("C", [32, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_stage_gives_the_kernel_its_layout(dtype, C):
    """w*_hi, w*_lo: float32 `[k, Cp, Cp]` (C_out, C_in zero-padded to a
    whole K step), the TF32 split of the working-type weight; for bfloat16
    weights hi is exact and lo zero."""
    k, Cp = 7, hifigan_mrf.padded_channels(C)
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((C, C, k)).astype(np.float32))
    b = torch.zeros(C)
    u = hifigan_mrf.pack_stage([[(w, b, 2 * w, b, 3)]], dtype).blocks[0][0]
    for plain, hi_p, lo_p in ((u.w1, u.w1_hi, u.w1_lo), (u.w2, u.w2_hi, u.w2_lo)):
        assert plain.dtype == dtype and plain.shape == (C, C, k)
        for t in (hi_p, lo_p):
            assert t.dtype == torch.float32 and t.shape == (k, Cp, Cp) and t.is_contiguous()
            assert not t[:, C:].any() and not t[:, :, C:].any()
        hi, lo = hi_p[:, :C, :C], lo_p[:, :C, :C]
        want_hi, want_lo = hifigan_mrf.tf32_split(plain.float())
        for j in range(k):
            assert torch.equal(hi[j], want_hi[:, :, j]) and torch.equal(lo[j], want_lo[:, :, j])
        if dtype == torch.bfloat16:
            assert torch.equal(hi, plain.float().permute(2, 0, 1)) and not lo.any()
        else:
            assert float((hi + lo - plain.permute(2, 0, 1)).abs().max()) <= 2.0**-22 * float(plain.abs().max())
    assert (u.k, u.d) == (k, 3)


def _padded_emulation(x, stage):
    """The stack as the kernel computes a width that is not a multiple of 32:
    x zero-padded to Cp channels, every conv on the packed `[k, Cp, Cp]`
    TF32 pairs in three passes (the biases read for the first C channels),
    the output's first C channels kept."""
    B, C, T = x.shape
    pad = hifigan_mrf.padded_channels(C) - C

    def conv(h, w_hi, w_lo, b, d):
        k = w_hi.shape[0]
        hh, hl = hifigan_mrf.tf32_split(h)
        wh, wl = w_hi.permute(1, 2, 0), w_lo.permute(1, 2, 0)

        def f(a, ww):
            return F.conv1d(a, ww, padding=(k // 2) * d, dilation=d)

        return f(hl, wh) + f(hh, wl) + f(hh, wh) + F.pad(b, (0, pad))[None, :, None]

    xp, acc = F.pad(x, (0, 0, 0, pad)), None
    for units in stage.blocks:
        h = xp
        for u in units:
            t = conv(F.leaky_relu(h, hifigan_mrf.LRELU_SLOPE), u.w1_hi, u.w1_lo, u.b1, u.d)
            t = t * (torch.arange(t.shape[1]) < C)[None, :, None]  # the kernel stores no channel >= C
            h = h + conv(F.leaky_relu(t, hifigan_mrf.LRELU_SLOPE), u.w2_hi, u.w2_lo, u.b2, 1)
        acc = h if acc is None else acc + h
    return (acc / len(stage.blocks))[:, :C]


@pytest.mark.parametrize("C", [8, 16, 24])
def test_padded_packing_emulates_the_stack(C):
    """HiFi-GAN V2's narrow widths: the 3×TF32 emulation on the padded
    packing equals the plain version within 1e-5, and the padded channels
    never reach the first C."""
    stage = _stage(C, seed=C)
    x = torch.from_numpy(np.random.default_rng(C + 1).standard_normal((2, C, 300)).astype(np.float32))
    ref = hifigan_mrf.mrf_stack_reference(x, stage)
    assert float((_padded_emulation(x, stage) - ref).abs().max()) <= 1e-5
