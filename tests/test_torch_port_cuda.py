"""The port's CUDA kernels against their plain versions on the card, and the
launch plans of both kernels on the CPU.

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

from tpu_tts_torch.ops import build, hifigan_mrf, wavernn_sampler

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
    """Ragged T, a batch of 2; 2e-4 as tests/test_hifigan_pallas.py. Two
    launches a dilation unit."""
    _need_cuda()
    gen = torch.Generator().manual_seed(C)
    stage = _stage(C, (3, 7, 11), ((1, 3, 5),) * 3, gen, "cuda")
    x = torch.randn(B, C, T, generator=gen).cuda()
    before = hifigan_mrf.launches
    got = hifigan_mrf.mrf_stack(x, stage)
    ref = hifigan_mrf.mrf_stack_reference(x, stage)
    torch.cuda.synchronize()
    assert hifigan_mrf.launches == before + 18
    assert float((got - ref).abs().max()) <= 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("C,T", [(256, 256), (128, 2048), (64, 4096), (32, 8192), (64, 50), (256, 7)])
def test_mrf_kernel_vits_stage_shapes(C, T):
    """The four VITS stage widths at 32 mel frames (each stage's plan), and
    a ragged T shorter than one time tile; float32 within 2e-4."""
    _need_cuda()
    gen = torch.Generator().manual_seed(T)
    stage = _stage(C, (3, 7, 11), ((1, 3, 5),) * 3, gen, "cuda")
    x = torch.randn(1, C, T, generator=gen).cuda()
    got = hifigan_mrf.mrf_stack(x, stage)
    ref = hifigan_mrf.mrf_stack_reference(x, stage)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("C,up", [(256, 8), (32, 256)])
@pytest.mark.parametrize("B", [8, 16])
def test_mrf_kernel_batched_stage_shapes(C, up, B):
    """The batch the micro-batcher sends: B rows of the first and last VITS
    stage widths at 32 mel frames, B on the grid's z axis; float32 within
    2e-4 and 18 launches a stage whatever B."""
    _need_cuda()
    gen = torch.Generator().manual_seed(B * C)
    stage = _stage(C, (3, 7, 11), ((1, 3, 5),) * 3, gen, "cuda")
    x = torch.randn(B, C, 32 * up, generator=gen).cuda()
    before = hifigan_mrf.launches
    got = hifigan_mrf.mrf_stack(x, stage)
    ref = hifigan_mrf.mrf_stack_reference(x, stage)
    torch.cuda.synchronize()
    assert hifigan_mrf.launches == before + 18
    assert torch.isfinite(got).all()
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


@pytest.mark.cuda
def test_mrf_kernel_runs_on_the_tensor_cores():
    """The built MRF kernel holds tensor-core instructions with TF32 operands."""
    _need_cuda()
    counts = build.sass_counts("hifigan_mrf")
    assert counts["HMMA.TF32"] + counts["HGMMA.TF32"] > 0, counts


@pytest.mark.cuda
def test_mrf_plan_matches_the_kernel_layout():
    """The plan's shared memory is the kernel's own, for every tile and type."""
    _need_cuda()
    lib = hifigan_mrf.load_kernel()
    for bn in hifigan_mrf.BN_CHOICES:
        for bf16 in (False, True):
            assert lib.hifigan_mrf_smem_bytes(bn, int(bf16)) == hifigan_mrf.smem_bytes(bn, bf16)
    assert lib.hifigan_mrf_smem_bytes(48, 0) == 0


def test_mrf_plan_fills_the_card_within_shared_memory():
    """The launch plan at the VITS stage shapes: every tile fits in a
    block's shared memory, the tile divides C, and at 256 mel frames (B = 1
    and 2) the grid leaves at most n_sm/32 SMs without a block."""
    n_sm = 132
    for bn in hifigan_mrf.BN_CHOICES:
        for bf16 in (False, True):
            assert hifigan_mrf.smem_bytes(bn, bf16) <= build.SMEM_LIMIT
    for C, up in ((256, 8), (128, 64), (64, 128), (32, 256)):
        for B, frames in ((1, 256), (2, 256), (1, 384)):
            T = frames * up
            pl = hifigan_mrf.plan(B, C, T, n_sm)
            BM, BN = pl.shape
            assert C % BN == 0 and pl.grid == (math.ceil(T / BM), C // BN, B)
            if frames == 256:
                assert pl.blocks >= n_sm - n_sm // 32
    assert hifigan_mrf.plan(1, 32, 7, n_sm).blocks == 1
    with pytest.raises(ValueError):
        hifigan_mrf.plan(1, 48, 1000, n_sm)


def test_mrf_plan_at_batch_16():
    """The plan of the batches the micro-batcher sends (B up to 16, the
    VITS stage shapes at the 384-frame decode bucket): the tile divides C,
    fits in shared memory and B is the grid's z axis."""
    n_sm = 132
    for C, up in ((256, 8), (128, 64), (64, 128), (32, 256)):
        T = 384 * up
        for B in (2, 4, 8, 16):
            pl = hifigan_mrf.plan(B, C, T, n_sm)
            BM, BN = pl.shape
            assert C % BN == 0 and pl.grid == (math.ceil(T / BM), C // BN, B)
            assert hifigan_mrf.smem_bytes(BN, False) <= build.SMEM_LIMIT
            assert hifigan_mrf.smem_bytes(BN, True) <= build.SMEM_LIMIT
    assert hifigan_mrf.plan(8, 32, 384 * 256, n_sm).blocks >= 6000


def _tiny_vits_on_card():
    """A tiny VITS whose generator widths K1 takes (128 → 64 → 32), random
    weights from a seed, noise scales 0, behind a `Synthesizer`."""
    from tpu_tts_torch.configs.vits_config import VitsArgs, VitsAudioConfig, VitsConfig
    from tpu_tts_torch.infer.synthesizer import Synthesizer
    from tpu_tts_torch.models.vits import Vits

    torch.manual_seed(0)
    args = VitsArgs(hidden_channels=32, hidden_channels_ffn_text_encoder=48, num_layers_text_encoder=2,
                    num_layers_flow=2, upsample_rates_decoder=[4, 4], upsample_kernel_sizes_decoder=[8, 8],
                    upsample_initial_channel_decoder=128, resblock_kernel_sizes_decoder=[3, 7],
                    resblock_dilation_sizes_decoder=[[1, 3], [1, 3]], inference_noise_scale=0.0,
                    inference_noise_scale_dp=0.0)
    config = VitsConfig(model_args=args, audio=VitsAudioConfig(fft_size=64, win_length=64, hop_length=16))
    synth = Synthesizer(device="cuda")
    synth.tts_model = Vits.init_from_config(config, device="cuda")
    synth.tts_config = synth.tts_model.config
    return synth


@pytest.mark.cuda
def test_batcher_on_the_card_runs_k1_once_a_batch():
    """4 concurrent requests through the micro-batcher on the card: fewer
    batches than requests, every inference call launching K1 for each
    stage's dilation units (2 × 4 a stage, 2 stages), and each reply the
    locked path's waveform within 1e-4 (rows of one batch against B = 1)."""
    import threading

    from tpu_tts_torch.infer.batcher import TTSMicroBatcher

    _need_cuda()
    synth = _tiny_vits_on_card()
    gen = synth.tts_model.net.waveform_decoder
    per_call = sum(hifigan_mrf.launches_per_stage(gen.mrf_stage(i)) for i in range(gen.num_upsamples))
    assert per_call == 16
    texts = ["First request here.", "The second one is longer than that.", "Third.", "And a fourth request."]
    batcher = TTSMicroBatcher(synth, gather_window_s=0.5)
    replies = {}
    try:
        before = hifigan_mrf.launches
        threads = [threading.Thread(target=lambda i=i: replies.__setitem__(i, batcher.tts(texts[i])))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        launched = hifigan_mrf.launches - before
    finally:
        batcher.close()
    assert batcher.batches_run < 4 and batcher.rows_run == 4
    assert launched == per_call * batcher.batches_run
    for i, text in enumerate(texts):
        serial = torch.tensor(synth.tts(text))
        got = torch.from_numpy(replies[i])
        assert got.shape == serial.shape and bool(torch.isfinite(got).all()) and float(got.abs().max()) > 0
        assert float((got - serial).abs().max()) <= 1e-4


def test_wavernn_plan_holds_the_weights_in_shared_memory():
    """K2's launch plan: at the served widths on 132 SMs the 3.93 M loop
    weights live in the blocks' shared memory (one block an SM, four columns
    of each phase a block) beside the staging of about 26 rows; at
    R = F = 1024 a block's share does not fit and the weights stay in global
    memory."""
    pl = wavernn_sampler.plan(512, 512, 512, 132)
    assert pl.weights_shared and pl.grid == 128 and pl.cols == (4, 4, 4)
    assert pl.weight_floats() * pl.grid == 12 * 512 * 512 + 3 * 512 * 512  # every loop weight, once
    assert 24 <= pl.rows_per_launch <= 27
    assert pl.smem_bytes(pl.rows_per_launch) <= wavernn_sampler.build.SMEM_LIMIT
    assert pl.smem_bytes(pl.rows_per_launch + 1) > wavernn_sampler.build.SMEM_LIMIT
    wide = wavernn_sampler.plan(1024, 1024, 512, 132)
    assert not wide.weights_shared and wide.grid == 132 and wide.rows_per_launch >= 1
    assert wide.smem_bytes(wide.rows_per_launch) <= wavernn_sampler.build.SMEM_LIMIT
    small = wavernn_sampler.plan(16, 16, 128, 132)
    assert small.weights_shared and small.grid == 32 and small.cols == (1, 1, 4)


def _wavernn(B, T, R, F, C, mel=20, aux=8, seed=0, device="cuda"):
    """A random WaveRNN cell's packed weights and the streams of random
    conditioning, on `device`."""
    from tpu_tts_torch.vocoder.models.wavernn import WavernnArgs, WavernnNet

    torch.manual_seed(seed)
    args = WavernnArgs(rnn_dims=R, fc_dims=F, mode=str(int(math.log2(C))), res_out_dims=4 * aux, feat_dims=mel)
    w = wavernn_sampler.pack_weights(WavernnNet(args).to(device))
    gen = torch.Generator(device=device).manual_seed(seed)
    mels_up = torch.randn(B, T, mel, generator=gen, device=device)
    aux_in = torch.randn(B, T, 4 * aux, generator=gen, device=device)
    return w, *wavernn_sampler.precompute_streams(w, mels_up, aux_in)


@pytest.mark.parametrize("greedy", [True, False])
def test_wavernn_padding_to_float4_changes_no_draw(greedy):
    """The kernel reads rows as float4, so the wrapper zero-pads R and F to
    multiples of 4: the plain version on the padded weights and streams
    draws what it draws on the originals, each draw the best of its step."""
    w, streams, tc = _wavernn(3, 24, 18, 14, 64, device="cpu")
    wp, sp = wavernn_sampler.pad_to_float4(w, streams)
    assert wp.dims == (20, 16, 64) and [s.shape[-1] for s in sp] == [20, 60, 16, 16]
    got = wavernn_sampler.sample_reference(wp, sp, tc, greedy=greedy, seed=3)
    assert len(torch.unique(got)) > 3
    gap = wavernn_sampler.score_gap(w, streams, tc, got, greedy=greedy, seed=3)
    assert float(gap.abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,R,F,C", [(2, 40, 16, 16, 128), (7, 300, 32, 48, 256), (5, 512, 512, 512, 512),
                                       (3, 100, 18, 14, 128)])
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
@pytest.mark.parametrize("greedy", [True, False])
def test_wavernn_sampler_splits_a_large_batch(greedy):
    """More rows than one launch takes, at the served widths: the wrapper
    splits them over ⌈B / rows_per_launch⌉ launches, noise keyed by the row's
    index in the whole batch, and the plain version holds every draw."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    pl = wavernn_sampler.plan(512, 512, 512, torch.cuda.get_device_properties(0).multi_processor_count)
    B = pl.rows_per_launch + 3
    w, streams, tc = _wavernn(B, 512, 512, 512, 512)
    before = wavernn_sampler.launches
    got = wavernn_sampler.sample(w, streams, tc, greedy=greedy, seed=11)
    torch.cuda.synchronize()
    assert wavernn_sampler.launches == before + math.ceil(B / pl.rows_per_launch)
    gap = wavernn_sampler.score_gap(w, streams, tc, got, greedy=greedy, seed=11)
    assert float(gap.max()) <= 1e-4
    assert float(gap.min()) >= 0.0


@pytest.mark.cuda
def test_wavernn_sampler_global_weights():
    """A width whose weight share does not fit in a block's shared memory:
    the same kernel reads its weight rows from global memory."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    w, streams, tc = _wavernn(2, 64, 1024, 1024, 512)
    assert not wavernn_sampler.device_plan(w, streams[0].device).weights_shared
    before = wavernn_sampler.launches
    got = wavernn_sampler.sample(w, streams, tc, greedy=False, seed=5)
    torch.cuda.synchronize()
    assert wavernn_sampler.launches == before + 1
    gap = wavernn_sampler.score_gap(w, streams, tc, got, greedy=False, seed=5)
    assert float(gap.max()) <= 1e-4
    assert float(gap.min()) >= 0.0


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


@pytest.mark.cuda
def test_wavernn_plan_matches_the_kernel_layout():
    """The plan's shared memory is the kernel's own layout, and the kernel's
    blocks fit on the card at the grid the plan gives."""
    _need_cuda()
    lib = wavernn_sampler._kernel()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for R, F, C in ((512, 512, 512), (1024, 1024, 512), (16, 16, 128), (32, 48, 256)):
        pl = wavernn_sampler.plan(R, F, C, n_sm)
        assert pl.grid <= n_sm
        for rows in (1, 5, pl.rows_per_launch):
            assert lib.wavernn_smem_bytes(rows, R, F, C, pl.grid, int(pl.weights_shared)) == pl.smem_bytes(rows)
