"""The port's CUDA kernels against their plain versions on the card, and the
launch plan of the MRF kernel on the CPU.

WaveRNN sampler (K2): a free-running comparison with the plain version can
part after one near-tie flip of an argmax (float32 sums in another order),
so the plain version is rerun teacher-forced with the kernel's own samples
and every draw of the kernel must score within 1e-4 of that step's best.

The `cuda` tests skip without a CUDA device. This file imports neither JAX
nor the JAX package, so it also runs on a machine with only PyTorch:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -o addopts="" -q
"""

import math

import pytest
import torch

from tpu_tts_torch.ops import hifigan_mrf, wavernn_sampler

torch.set_num_threads(1)


def _stage(C, kernel_sizes, dilations, gen, device, dtype=torch.float32):
    def rnd(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    return hifigan_mrf.pack_stage(
        [
            [(rnd(C, C, k, scale=(C * k) ** -0.5), rnd(C, scale=0.1), rnd(C, C, k, scale=(C * k) ** -0.5),
              rnd(C, scale=0.1), d) for d in dils]
            for k, dils in zip(kernel_sizes, dilations)
        ],
        dtype,
    )


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the MRF kernel is CUDA C++ with no CPU mode")
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("C,T,B", [(32, 1000, 2), (64, 333, 1), (128, 77, 2), (256, 130, 1)])
def test_mrf_kernel_matches_reference_f32(C, T, B):
    """Ragged T, every cluster size the plan picks at these shapes; 2e-4 as
    tests/test_hifigan_pallas.py."""
    _need_cuda()
    gen = torch.Generator().manual_seed(C)
    stage = _stage(C, (3, 7, 11), ((1, 3, 5),) * 3, gen, "cuda")
    x = torch.randn(B, C, T, generator=gen).cuda()
    before = hifigan_mrf.launches
    got = hifigan_mrf.mrf_stack(x, stage)
    ref = hifigan_mrf.mrf_stack_reference(x, stage)
    torch.cuda.synchronize()
    assert hifigan_mrf.launches == before + 9
    assert float((got - ref).abs().max()) <= 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1, 2])
def test_mrf_kernel_matches_reference_bf16(blocks):
    """bf16: the plain version rounds every conv output to bf16, the kernel
    only the residual stream; held to 2e-2 of the output's scale."""
    _need_cuda()
    gen = torch.Generator().manual_seed(blocks)
    stage = _stage(64, (3, 7)[:blocks], ((1, 3),) * blocks, gen, "cuda", torch.bfloat16)
    x = torch.randn(1, 64, 500, generator=gen).cuda()
    got = hifigan_mrf.mrf_stack(x, stage)
    ref = hifigan_mrf.mrf_stack_reference(x, stage)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert float((got.float() - ref.float()).abs().max()) <= 2e-2 * float(ref.float().abs().max())


@pytest.mark.cuda
def test_mrf_kernel_rejects_bad_input():
    _need_cuda()
    gen = torch.Generator().manual_seed(0)
    stage = _stage(32, (3,), ((1,),), gen, "cuda")
    with pytest.raises(ValueError):
        hifigan_mrf.mrf_stack(torch.randn(1, 64, 100, device="cuda"), stage)
    with pytest.raises(ValueError):
        hifigan_mrf.mrf_stack(torch.randn(1, 32, 100, device="cuda"), _stage(32, (3,), ((1,),), gen, "cpu"))


def test_mrf_plan_fills_the_card_within_shared_memory():
    """The launch plan at the VITS stage shapes: every SM gets a block, the
    first conv's output fills whole warp tiles, one pass of warp tiles."""
    def smem(C, k, d):  # the bound the plan must respect, with the kernel's layout
        return lambda tile, S: 4 * (C * (tile + (k - 1) * (d + 1)) + C * (tile + k - 1) + 72) + 2 * 8 * k * (C // S) * 4

    for C, up in ((256, 8), (128, 64), (64, 128), (32, 256)):
        T = 256 * up
        for k in (3, 7, 11):
            for d in (1, 3, 5):
                tile, S = hifigan_mrf.plan(1, C, T, k, d, 132, smem(C, k, d))
                assert (tile + k - 1) % 32 == 0 and C % (32 * S) == 0
                assert math.ceil(T / tile) * S >= 132
                assert smem(C, k, d)(tile, S) <= hifigan_mrf.SMEM_LIMIT
                assert (C // S // 32) * ((tile + k - 1) // 32) <= hifigan_mrf.MAX_ITEMS
    with pytest.raises(ValueError):
        hifigan_mrf.plan(1, 4096, 1000, 11, 5, 132, smem(4096, 11, 5))


def _wavernn(B, T, R, F, C, mel=20, aux=8, seed=0):
    """A random WaveRNN cell's packed weights and the streams of random
    conditioning, on the card."""
    from tpu_tts_torch.vocoder.models.wavernn import WavernnArgs, WavernnNet

    torch.manual_seed(seed)
    args = WavernnArgs(rnn_dims=R, fc_dims=F, mode=str(int(math.log2(C))), res_out_dims=4 * aux, feat_dims=mel)
    w = wavernn_sampler.pack_weights(WavernnNet(args).cuda())
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mels_up = torch.randn(B, T, mel, generator=gen, device="cuda")
    aux_in = torch.randn(B, T, 4 * aux, generator=gen, device="cuda")
    return w, *wavernn_sampler.precompute_streams(w, mels_up, aux_in)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,R,F,C", [(2, 40, 16, 16, 128), (7, 300, 32, 48, 256), (5, 512, 512, 512, 512)])
@pytest.mark.parametrize("greedy", [True, False])
def test_wavernn_sampler_matches_reference(B, T, R, F, C, greedy):
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    w, streams, tc = _wavernn(B, T, R, F, C)
    before = wavernn_sampler.launches
    got = wavernn_sampler.sample(w, streams, tc, greedy=greedy, seed=11)
    torch.cuda.synchronize()
    assert wavernn_sampler.launches == before + 1
    assert got.shape == (B, streams[0].shape[1])
    gap = wavernn_sampler.score_gap(w, streams, tc, got, greedy=greedy, seed=11)
    assert float(gap.max()) <= 1e-4
    assert float(gap.min()) >= 0.0
    assert len(torch.unique(got)) > 10  # the draw moves


@pytest.mark.cuda
def test_wavernn_sampler_rejects_bad_input():
    _need_cuda()
    w, streams, tc = _wavernn(2, 16, 16, 16, 128)
    bad = [
        (streams[0].double(),) + streams[1:],  # type
        (streams[0], streams[1].cpu()) + streams[2:],  # device
        (streams[0].transpose(0, 1).contiguous().transpose(0, 1),) + streams[1:],  # contiguity
        (streams[0][:, :, :8].contiguous(),) + streams[1:],  # shape
        streams[:3],  # count
    ]
    for s in bad:
        with pytest.raises(ValueError):
            wavernn_sampler.sample(w, s, tc)
    with pytest.raises(ValueError):  # T not a whole number of chunks
        wavernn_sampler.sample(w, tuple(x[:, :15].contiguous() for x in streams), tc)
    w.fc3 = w.fc3.cpu()
    with pytest.raises(ValueError):  # weights on another device
        wavernn_sampler.sample(w, streams, tc)
