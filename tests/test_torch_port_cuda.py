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

from chip_smoke import plain_mrf, unit_gain_decoder
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
@pytest.mark.parametrize("C,T,B", [(8, 700, 2), (16, 333, 1), (24, 260, 2), (48, 129, 1), (40, 90, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mrf_kernel_channel_tail(C, T, B, dtype):
    """Widths that are not a multiple of 32 (HiFi-GAN V2's 16 and 8, and 24,
    40, 48): the weights padded to a whole K step, the padded channels read
    as zero and never written; float32 within 2e-4, bf16 within 2e-2 of the
    output's scale; 18 launches a stage."""
    _need_cuda()
    gen = torch.Generator().manual_seed(C + T)
    stage = _stage(C, (3, 7, 11), ((1, 3, 5),) * 3, gen, "cuda", dtype)
    x = torch.randn(B, C, T, generator=gen).cuda().to(dtype)
    before = hifigan_mrf.launches
    got = hifigan_mrf.mrf_stack(x, stage)
    ref = hifigan_mrf.mrf_stack_reference(x, stage)
    torch.cuda.synchronize()
    assert hifigan_mrf.launches == before + 18
    assert got.shape == x.shape and bool(torch.isfinite(got).all())
    err = float((got.float() - ref.float()).abs().max())
    assert err <= (2e-4 if dtype == torch.float32 else 2e-2 * float(ref.float().abs().max()))


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
    for bn in hifigan_mrf.BN_CHOICES + hifigan_mrf.BN_NARROW:
        for bf16 in (False, True):
            assert lib.hifigan_mrf_smem_bytes(bn, int(bf16)) == hifigan_mrf.smem_bytes(bn, bf16)
    assert lib.hifigan_mrf_smem_bytes(48, 0) == 0


def test_mrf_plan_fills_the_card_within_shared_memory():
    """The launch plan at the VITS stage shapes: every tile fits in a
    block's shared memory, the tile divides C, and at 256 mel frames (B = 1
    and 2) the grid leaves at most n_sm/32 SMs without a block."""
    n_sm = 132
    for bn in hifigan_mrf.BN_CHOICES + hifigan_mrf.BN_NARROW:
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
        hifigan_mrf.plan(1, 0, 1000, n_sm)


@pytest.mark.parametrize("C", [1, 8, 16, 24, 40, 48, 100])
def test_mrf_plan_takes_any_width(C):
    """A width that is not a multiple of 32 (HiFi-GAN V2's 16 and 8 at 256
    mel frames, a ragged T): the tile divides the padded width, the grid
    covers C with fewer than one tile of columns past it, and V2's 16 and 8
    take a 16- and an 8-wide tile."""
    n_sm = 132
    Cp = hifigan_mrf.padded_channels(C)
    assert Cp % hifigan_mrf.BK == 0 and 0 <= Cp - C < hifigan_mrf.BK
    for T in (256 * 128, 1000, 7):
        pl = hifigan_mrf.plan(2, C, T, n_sm)
        BM, BN = pl.shape
        assert Cp % BN == 0 and pl.grid == (math.ceil(T / BM), math.ceil(C / BN), 2)
        assert pl.grid[1] * BN - C < BN
    assert hifigan_mrf.plan(1, 16, 256 * 128, n_sm).bn == 16
    assert hifigan_mrf.plan(1, 8, 256 * 256, n_sm).bn == 8


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


@pytest.mark.cuda
def test_conditioned_generator_through_k1():
    """A speaker-conditioned generator (`cond_layer` from g [B, 16, 1]) on
    the card: every stage through K1 (18 launches a stage), the waveform
    within 1e-4 of the same generator with the plain MRF, and two speakers
    giving different waveforms."""
    from tpu_tts_torch.vocoder.models import hifigan_generator

    _need_cuda()
    torch.manual_seed(0)
    dec = hifigan_generator.HifiganGenerator(
        in_channels=32, upsample_initial_channel=128, upsample_factors=(4, 4), upsample_kernel_sizes=(8, 8),
        cond_channels=16).cuda().eval()
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 32, 50, generator=gen).cuda()
    g = torch.randn(2, 16, 1, generator=gen).cuda()
    with torch.no_grad():
        before = hifigan_mrf.launches
        got = dec(x, g=g)
        launched = hifigan_mrf.launches - before
        other = dec(x, g=g.flip(0))
        with plain_mrf():
            ref = dec(x, g=g)
    torch.cuda.synchronize()
    assert launched == 2 * 18 and got.shape == (2, 1, 800)
    assert float((got - ref).abs().max()) <= 1e-4
    assert float((got - other).abs().max()) > 1e-3


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


def _tiny_xtts_on_card(**overrides):
    """A small XTTS-v2 (2 GPT layers, 64 wide) with the full decoder
    (512 → 32, upsampling 8·8·2·2) on the card, weights from torch's seed 0;
    position embeddings ~N(0, 1) so greedy decoding moves between codes."""
    from tpu_tts_torch.configs.xtts_config import XttsArgs, XttsConfig
    from tpu_tts_torch.models.xtts import Xtts

    torch.manual_seed(0)
    args = XttsArgs(**{**dict(gpt_layers=2, gpt_n_heads=2, gpt_n_model_channels=64, gpt_number_text_tokens=50,
                              gpt_num_audio_tokens=66, gpt_start_audio_token=64, gpt_stop_audio_token=65,
                              num_cond_latents=4, d_vector_dim=32, decoder_input_dim=64, kv_cache_len=256),
                       **overrides})
    return Xtts(XttsConfig(model_args=args), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("n_latents", [8, 24])
def test_xtts_decoder_through_k1(B, n_latents):
    """The XTTS decoder (g on `cond_layer` and every `conds.{i}`) at a first
    chunk's 8 latents and a full chunk's 4 + 20: 72 K1 launches a call, the
    waveform within 1e-3 of the same decoder with the plain MRF (four
    stages of float32 sums in another order), each row its own speaker."""
    import torch.nn.functional as F

    _need_cuda()
    model = _tiny_xtts_on_card()
    gen = torch.Generator().manual_seed(1)
    lat = torch.randn(B, n_latents, 64, generator=gen).cuda()
    spk = F.normalize(torch.randn(B, 32, generator=gen), dim=-1).cuda()
    before = hifigan_mrf.launches
    got = model.net.decode_latents(lat, spk)
    launched = hifigan_mrf.launches - before
    with plain_mrf():
        ref = model.net.decode_latents(lat, spk)
    torch.cuda.synchronize()
    frames = math.floor(math.floor(n_latents * 4) * 24000 / 22050)
    assert launched == 72 and tuple(got.shape) == (B, frames * 256)
    assert bool(torch.isfinite(got).all()) and float((got - ref).abs().max()) <= 1e-3


@pytest.mark.cuda
def test_xtts_pool_greedy_codes_score_best_teacher_forced():
    """Four greedy streams (mixed text lengths, one admitted mid-round) on
    the card; each stream's codes, replayed teacher-forced through the GPT
    alone, score within 1e-4 of that step's best logit: another batch size
    may flip a near-tie, never a clear argmax."""
    from tpu_tts_torch.infer.xtts_pool import XttsStreamPool

    _need_cuda()
    model = _tiny_xtts_on_card()
    with torch.no_grad():
        for emb in (model.net.gpt.text_pos_embedding.emb, model.net.gpt.mel_pos_embedding.emb):
            emb.weight.normal_(0.0, 1.0)
        model.net.gpt.mel_head.bias[model.args.gpt_stop_audio_token] = -1e4  # streams run to their budget
    gen = torch.Generator().manual_seed(2)
    rows = [(torch.randint(1, 48, (n,), generator=gen), torch.randn(1, 4, 64, generator=gen),
             torch.nn.functional.normalize(torch.randn(1, 32, generator=gen), dim=-1)) for n in (5, 9, 12, 7)]
    pool = XttsStreamPool(model, max_streams=4, stream_chunk_size=8, first_chunk_size=4, max_new_tokens=24, top_k=1,
                          gather_window_s=0.3)
    try:
        streams = [pool.submit(text_tokens=t, gpt_cond_latent=c, speaker_embedding=s) for t, c, s in rows[:3]]
        first = next(streams[0])
        streams.append(pool.submit(text_tokens=rows[3][0], gpt_cond_latent=rows[3][1], speaker_embedding=rows[3][2]))
        chunks = [[first] + list(streams[0])] + [list(st) for st in streams[1:]]
    finally:
        pool.close()
    assert pool.rounds_served == 1 and pool.admissions == 1
    for (text, cond, _), st, ch in zip(rows, streams, chunks):
        codes = torch.tensor(st.codes)
        assert len(codes) > 0 and sum(c.size for c in ch) > 0
        prev = torch.cat([torch.tensor([model.args.gpt_start_audio_token]), codes[:-1]])[None].cuda()
        with torch.no_grad():
            logits = model.net.gpt(cond.cuda(), text[None].cuda(), prev)["mel_logits"][0]
        gap = logits.max(dim=-1).values - logits.gather(1, codes.cuda()[:, None])[:, 0]
        assert float(gap.max()) <= 1e-4


def _tiny_train_pair(mixed: bool = False):
    """A tiny VITS set up for training on the CPU and on the card with the
    same seeded weights (weight-norm gains ≈ 1, the rest ~N(0, 0.1²), so the
    zero-initialised projections do work), no dropout; with `mixed`, at
    mixed precision."""
    from tpu_tts_torch.configs.vits_config import VitsArgs, VitsAudioConfig, VitsConfig
    from tpu_tts_torch.models.vits import Vits

    args = VitsArgs(num_chars=40, hidden_channels=32, hidden_channels_ffn_text_encoder=48, num_layers_text_encoder=2,
                    num_layers_flow=2, out_channels=33, num_layers_posterior_encoder=1, spec_segment_size=4,
                    upsample_rates_decoder=[4, 4], upsample_kernel_sizes_decoder=[8, 8],
                    upsample_initial_channel_decoder=32, resblock_kernel_sizes_decoder=[3, 7],
                    resblock_dilation_sizes_decoder=[[1, 3], [1, 3]], periods_multi_period_discriminator=[2],
                    dropout_p_text_encoder=0.0, dropout_p_duration_predictor=0.0)
    config = VitsConfig(model_args=args, audio=VitsAudioConfig(fft_size=64, win_length=64, hop_length=16, num_mels=20),
                        mixed_precision=mixed)
    cpu, card = Vits(config, device="cpu"), Vits(config, device="cuda")
    cpu.init_training()
    card.init_training()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in list(cpu.net.named_parameters()) + list(cpu.disc.named_parameters()):
            p.copy_(1 + 0.1 * (2 * torch.rand(p.shape, generator=gen) - 1) if name.endswith(("original0", "gamma"))
                    else 0.1 * torch.randn(p.shape, generator=gen))
    card.load_training_state(cpu.training_state_dict(), strict=True)
    wav = torch.zeros(2, 1, 24 * 16)
    wav[0, 0] = 0.4 * torch.sin(0.2 * torch.arange(24 * 16.0))
    wav[1, 0, : 18 * 16] = 0.3 * torch.sin(0.3 * torch.arange(18 * 16.0))
    batch = {"text_input": torch.randint(1, 40, (2, 11), generator=gen), "text_lengths": torch.tensor([11, 7]),
             "mel_lengths": torch.tensor([24, 18]), "waveform": wav + 0.05 * torch.randn(wav.shape, generator=gen)}
    draws = {"posterior": torch.randn(2, 32, 24, generator=gen), "sdp": torch.randn(2, 2, 11, generator=gen),
             "segments": torch.rand(2, generator=gen)}
    return cpu, card, batch, draws


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer_idx", [0, 1])
def test_train_step_on_card_matches_cpu(optimizer_idx):
    """One D step (0) or G step (1) of a tiny VITS on the card against the
    same step on the CPU, same weights, batch and draws: losses within 1e-4
    relative, each gradient within 1e-3 of its tensor's largest |gradient|
    plus 1e-6 (float32 with TF32 off; cuDNN sums in another order)."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu, card, batch, draws = _tiny_train_pair()
    results = []
    for m in (cpu, card):
        m.train(True)
        b = {k: v.to(m.device) for k, v in batch.items()}
        loss, logs = m.loss_fn(b, optimizer_idx, draws={k: v.to(m.device) for k, v in draws.items()})
        loss.backward()
        mod = m.disc if optimizer_idx == 0 else m.net
        results.append(({k: float(v) for k, v in logs.items()},
                        {n: p.grad.cpu() for n, p in mod.named_parameters() if p.grad is not None}))
    (lc, gc), (lg, gg) = results
    for k in lc:
        assert abs(lc[k] - lg[k]) <= 1e-4 * max(1.0, abs(lc[k])), k
    assert set(gc) == set(gg) and gc
    for n in gc:
        assert float((gc[n] - gg[n]).abs().max()) <= 1e-3 * float(gc[n].abs().max()) + 1e-6, n


def _tiny_gan_pair(kind):
    """`chip_smoke`'s tiny GAN vocoder `kind` on the CPU and on the card with
    the same seeded weights, and its batch (`tiny_gan_batch`: the float32
    gradients of these tiny STFT and log-mel losses stray from float64's by
    up to 3e-3 of a tensor's max on some data, and little on this batch)."""
    import chip_smoke
    from tpu_tts_torch.vocoder.models import setup_model

    config = chip_smoke.tiny_gan_configs()[kind]
    cpu, card = (setup_model(config, device=d) for d in ("cpu", "cuda"))
    chip_smoke.randomize_module(cpu.net, torch.Generator().manual_seed(chip_smoke.SEED))
    card.net.load_state_dict(cpu.net.state_dict(), strict=True)
    return cpu, card, {k: torch.from_numpy(v) for k, v in chip_smoke.tiny_gan_batch().items()}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hifigan", "multiband_melgan"])
@pytest.mark.parametrize("optimizer_idx", [0, 1])
def test_gan_vocoder_step_on_card_matches_cpu(kind, optimizer_idx):
    """One D step (0) or G step (1) of a tiny GAN vocoder on the card against
    the CPU: losses within 1e-4 relative, each gradient within 1e-3 of its
    tensor's largest |gradient| plus 1e-6 (float32, TF32 off)."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu, card, batch = _tiny_gan_pair(kind)
    results = []
    for m in (cpu, card):
        m.train(True)
        loss, logs = m.loss_fn({k: v.to(m.device) for k, v in batch.items()}, optimizer_idx)
        loss.backward()
        part = m.model_d if optimizer_idx == 0 else m.model_g
        results.append(({k: float(v.detach()) for k, v in logs.items()},
                        {n: p.grad.cpu() for n, p in part.named_parameters() if p.grad is not None}))
    (lc, gc), (lg, gg) = results
    for k in lc:
        assert abs(lc[k] - lg[k]) <= 1e-4 * max(1.0, abs(lc[k])), k
    assert set(gc) == set(gg) and gc
    for n in gc:
        assert float((gc[n] - gg[n]).abs().max()) <= 1e-3 * float(gc[n].abs().max()) + 1e-6, n


@pytest.mark.cuda
def test_mrf_stack_refuses_a_gradient_on_cuda():
    """K1 has no backward: a CUDA input requiring grad, or an eval() generator
    whose parameters require it, raises; under no_grad the kernel runs (18
    launches a stage)."""
    from tpu_tts_torch.vocoder.models.hifigan_generator import HifiganGenerator

    _need_cuda()
    gen = HifiganGenerator(in_channels=16, upsample_initial_channel=128, upsample_factors=(2, 2),
                           upsample_kernel_sizes=(4, 4)).cuda().eval()
    x = torch.randn(1, 16, 20, device="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        gen(x)
    with pytest.raises(RuntimeError, match="no backward"):
        hifigan_mrf.mrf_stack(torch.randn(1, 64, 40, device="cuda", requires_grad=True), gen.mrf_stage(0))
    before = hifigan_mrf.launches
    with torch.no_grad():
        assert gen(x).shape == (1, 1, 80)
    assert hifigan_mrf.launches - before == 2 * 18


def _tiny_xtts_train_pair():
    """A tiny XTTS-v2 (2 GPT layers, 32 wide) for fine-tuning on the CPU and
    on the card with the same seeded weights, a DVAE of 32 codes from seed
    0 (`load_dvae`) on each, and a raw-wav batch of 2 rows."""
    from tpu_tts_torch.configs.xtts_config import XttsArgs, XttsConfig
    from tpu_tts_torch.models.xtts import Xtts

    args = XttsArgs(gpt_layers=2, gpt_n_heads=2, gpt_n_model_channels=32, gpt_number_text_tokens=50,
                    gpt_num_audio_tokens=34, gpt_start_audio_token=32, gpt_stop_audio_token=33, num_cond_latents=4,
                    d_vector_dim=16, decoder_input_dim=32, gpt_start_text_token=48)
    cpu, card = (Xtts(XttsConfig(model_args=args), device=d) for d in ("cpu", "cuda"))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in cpu.net.gpt.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    card.net.load_state_dict(cpu.net.state_dict(), strict=True)
    for m in (cpu, card):
        m.load_dvae()
    wav = torch.zeros(2, 8192)
    wav[0] = 0.4 * torch.sin(0.05 * torch.arange(8192.0))
    wav[1, :5000] = 0.3 * torch.sin(0.08 * torch.arange(5000.0))
    batch = {"text_tokens": torch.randint(1, 47, (2, 12), generator=gen), "text_lengths": torch.tensor([12, 7]),
             "wav": wav + 0.05 * torch.randn(wav.shape, generator=gen), "wav_lengths": torch.tensor([8192, 5000]),
             "cond_wav": 0.3 * torch.randn(2, 4096, generator=gen), "cond_lengths": torch.tensor([4096, 3000])}
    return cpu, card, batch


@pytest.mark.cuda
def test_xtts_dvae_codes_on_card_match_cpu():
    """The DVAE's codes of a batch's mels on the card against the CPU's: at
    least 0.999 of them equal, each other one within 1e-4 (relative) of the
    CPU's best distance."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu, card, batch = _tiny_xtts_train_pair()
    mel = cpu._dvae_mel(batch["wav"])
    got, want = card.dvae.get_codebook_indices(mel.cuda()).cpu(), cpu.dvae.get_codebook_indices(mel)
    z = cpu.dvae.encode_latents(mel).double().transpose(1, 2)
    embed = cpu.dvae.codebook.embed.double()
    dist = z.pow(2).sum(-1, keepdim=True) - 2 * z @ embed + embed.pow(2).sum(0)
    best = dist.gather(-1, want[..., None])
    gap = (dist.gather(-1, got[..., None]) - best) / best.abs().clamp_min(1.0)
    assert float((got == want).float().mean()) >= 0.999 and float(gap.abs().max()) <= 1e-4


@pytest.mark.cuda
def test_xtts_fine_tune_step_on_card_matches_cpu():
    """One fine-tuning loss and backward of a tiny XTTS through the raw
    wavs (mels and DVAE codes on each device) on the card against the CPU:
    losses within 1e-4 relative, each GPT gradient within 1e-3 of its
    tensor's largest |gradient| plus 1e-6; the frozen decoder and
    `speaker_proj` get none, and K1 is launched no time."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu, card, batch = _tiny_xtts_train_pair()
    before = hifigan_mrf.launches
    results = []
    for m in (cpu, card):
        m.train(True)
        loss, logs = m.loss_fn({k: v.to(m.device) for k, v in batch.items()})
        loss.backward()
        results.append(({k: float(v) for k, v in {"loss": loss, **logs}.items()},
                        {n: p.grad.cpu() for n, p in m.net.named_parameters() if p.grad is not None}))
    torch.cuda.synchronize()
    assert hifigan_mrf.launches == before
    (lc, gc), (lg, gg) = results
    for k in lc:
        assert abs(lc[k] - lg[k]) <= 1e-4 * max(1.0, abs(lc[k])), k
    assert set(gc) == set(gg) and gc and all(n.startswith("gpt.") for n in gc)
    for n in gc:
        assert float((gc[n] - gg[n]).abs().max()) <= 1e-3 * float(gc[n].abs().max()) + 1e-6, n


@pytest.mark.cuda
def test_vits_voice_conversion_through_k1():
    """A multi-speaker VITS's voice conversion on the card: 72 K1 launches
    (the full 512 → 32 decoder), within 1e-3 of the same conversion through
    the plain MRF, one spectrogram frame × hop of audio a frame; another
    target speaker moves the waveform."""
    from tpu_tts_torch.configs.vits_config import VitsArgs, VitsAudioConfig, VitsConfig
    from tpu_tts_torch.models.vits import Vits

    _need_cuda()
    torch.manual_seed(0)
    config = VitsConfig(model_args=VitsArgs(num_chars=40, hidden_channels=32, hidden_channels_ffn_text_encoder=48,
                                            num_layers_text_encoder=1, num_layers_flow=1, use_speaker_embedding=True,
                                            num_speakers=3, speaker_embedding_channels=16, use_sdp=False),
                        audio=VitsAudioConfig(sample_rate=16000))
    model = Vits(config, device="cuda")
    model.init_training()  # the posterior encoder
    model.train(False)
    wav = 0.3 * torch.sin(0.03 * torch.arange(40 * 256.0)) + 0.02 * torch.randn(40 * 256)
    before = hifigan_mrf.launches
    got = model.voice_conversion(wav, 0, 2)
    launches = hifigan_mrf.launches - before
    with plain_mrf():
        ref = model.voice_conversion(wav, 0, 2)
    assert launches == 72 and got.shape == (40 * 256,)
    assert float(abs(got - ref).max()) <= 1e-3
    assert float(abs(model.voice_conversion(wav, 0, 1) - got).max()) > 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer_idx", [0, 1])
def test_mixed_precision_train_step_on_card_matches_cpu(optimizer_idx):
    """A D step (0) or G step (1) of the tiny VITS at mixed precision
    (bfloat16 compute on float32 parameters) on the card against the CPU:
    losses within 2e-2 relative, every parameter and gradient float32, the
    gradients' relative L2 distance within 0.5 (bfloat16 rounds cuDNN's sums
    and the CPU's differently, and a GAN step's gradients carry that noise;
    a wrong backward lands near 1)."""
    _need_cuda()
    cpu, card, batch, draws = _tiny_train_pair(mixed=True)
    results = []
    for m in (cpu, card):
        m.train(True)
        loss, logs = m.loss_fn({k: v.to(m.device) for k, v in batch.items()}, optimizer_idx,
                               draws={k: v.to(m.device) for k, v in draws.items()})
        loss.backward()
        mod = m.disc if optimizer_idx == 0 else m.net
        results.append(({k: float(v.detach()) for k, v in logs.items()},
                        {n: p.grad.cpu() for n, p in mod.named_parameters() if p.grad is not None}))
        assert {p.dtype for p in mod.parameters()} == {torch.float32}
    (lc, gc), (lg, gg) = results
    for k in lc:
        assert abs(lc[k] - lg[k]) <= 2e-2 * max(1.0, abs(lc[k])), k
    assert set(gc) == set(gg) and gc and {g.dtype for g in gg.values()} == {torch.float32}
    vc, vg = torch.cat([gc[n].flatten() for n in gc]), torch.cat([gg[n].flatten() for n in gc])
    assert float((vc - vg).norm() / vc.norm()) <= 0.5


@pytest.mark.cuda
def test_delightful_tts_through_k1():
    """A DelightfulTTS with a tiny acoustic model, 4 speakers and the default
    512 → 32 decoder redrawn at unit gain on the card: 72 K1 launches a
    sentence (every ResBlock1 stage), the waveform within 1e-3 of the plain
    MRF's, neither near silent nor mostly saturated, n_frames · hop samples;
    another speaker moves the waveform."""
    from tpu_tts_torch.configs import DelightfulTTSConfig
    from tpu_tts_torch.models.delightful_tts import DelightfulTTS

    _need_cuda()
    torch.manual_seed(0)
    config = DelightfulTTSConfig(use_speaker_embedding=True, num_speakers=4)
    ma = config.model_args
    ma.n_hidden_conformer_encoder = ma.n_hidden_conformer_decoder = ma.n_hidden_variance_adaptor = 32
    ma.n_layers_conformer_encoder = ma.n_layers_conformer_decoder = 1
    ma.n_heads_conformer_encoder = ma.n_heads_conformer_decoder = 2
    ma.bottleneck_size_u_reference_encoder, ma.speaker_embedding_channels = 32, 16
    model = DelightfulTTS.init_from_config(config, device="cuda")
    unit_gain_decoder(model.net.waveform_decoder)
    ids = model.tokenizer.text_to_ids("Be a voice, not an echo.")
    before = hifigan_mrf.launches
    got = model.inference(ids, aux_input={"speaker_ids": [1]})
    launches = hifigan_mrf.launches - before
    with plain_mrf():
        ref = model.inference(ids, aux_input={"speaker_ids": [1]})["model_outputs"]
    wav = got["model_outputs"]
    assert launches == 72 and wav.shape == (1, int(got["y_lengths"][0]) * 256, 1)
    assert bool(torch.isfinite(wav).all()) and float((wav - ref).abs().max()) <= 1e-3
    assert float(ref.pow(2).mean().sqrt()) > 1e-3 and float((ref.abs() > 0.999).float().mean()) <= 0.5
    other = model.inference(ids, aux_input={"speaker_ids": [2]})["model_outputs"]
    assert other.shape != wav.shape or float((other - wav).abs().max()) > 1e-5


@pytest.mark.cuda
def test_delightful_train_step_on_card_matches_cpu():
    """One D and one G step of `chip_smoke`'s tiny DelightfulTTS (aligner
    priors and the binary term on) on the card against the CPU, float32 and
    float64, TF32 off: losses within 1e-4 relative and the MAS durations
    equal in both, each float64 gradient within 1e-3 of its tensor's largest
    |gradient| plus 1e-6 (`check_delightful_train_card_vs_cpu` says why not
    float32's). The
    training generator in eval() mode asks K1 for a gradient and is refused;
    in train() mode it runs plain ResBlock1, no K1 launch, every decoder
    parameter with a gradient."""
    import chip_smoke
    from tpu_tts_torch.models.delightful_tts import DelightfulTTS

    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = chip_smoke.check_delightful_train_card_vs_cpu()
    assert out["float32"]["max_loss_rel_err"] <= 1e-4 and out["float64"]["max_loss_rel_err"] <= 1e-4
    assert out["float64"]["max_grad_err_of_max"] <= 1e-3
    model = DelightfulTTS.init_from_config(chip_smoke.delightful_tiny_config(), device="cuda")
    model.init_training()
    dec = model.net.waveform_decoder
    x = torch.randn(2, model.config.audio.num_mels, 8, device="cuda")
    dec.eval()
    with pytest.raises(RuntimeError, match="no backward"):
        dec(x)
    dec.train()
    before = hifigan_mrf.launches
    dec(x).square().mean().backward()
    assert hifigan_mrf.launches == before
    assert all(p.grad is not None and float(p.grad.abs().max()) > 0 for p in dec.parameters())


@pytest.mark.cuda
def test_speaker_encoders_on_card_match_cpu():
    """The LSTM, a narrow "batch" ResNet in eval and the full XTTS-side ResNet
    (64 → 512, frozen batch norms) with seeded weights: the card's embedding
    of the same mels within 1e-4 of the CPU's (float32, TF32 off)."""
    from tpu_tts_torch.encoder.models import LSTMSpeakerEncoder, ResNetSpeakerEncoder

    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(3)
    for net, c_mel in ((LSTMSpeakerEncoder(16, 8, 24, 2), 16),
                       (ResNetSpeakerEncoder(16, 8, (1, 1, 1, 1), (8, 8, 16, 16), norm_type="batch"), 16),
                       (ResNetSpeakerEncoder(64, 512, norm_type="frozen_batch"), 64)):
        with torch.no_grad():
            for k, v in net.state_dict().items():
                if v.is_floating_point():
                    v.copy_((1 + 0.3 * torch.rand(v.shape, generator=gen)) if k.endswith("running_var")
                            else 0.2 * torch.randn(v.shape, generator=gen))
        net.eval()
        mel = torch.randn(3, c_mel, 150, generator=gen)
        with torch.no_grad():
            ref = net(mel)
            got = net.cuda()(mel.cuda()).cpu()
        assert float((got - ref).abs().max()) <= 1e-4, type(net).__name__


@pytest.mark.cuda
def test_xtts_cloning_through_k1():
    """A tiny XTTS-v2 with Coqui's decoder-side ResNet speaker encoder on the
    card: the speaker embedding of a wav within 1e-4 of the CPU's, and the
    decoder conditioned on it through K1, 72 launches, within 1e-3 of the
    plain MRF; another wav gives another embedding and waveform."""
    from tpu_tts_torch.models.xtts import XttsNet

    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _tiny_xtts_on_card(d_vector_dim=512)
    torch.manual_seed(1)
    model.net = XttsNet(model.args, ref_speaker_encoder=True).cuda().eval()
    cpu_net = XttsNet(model.args, ref_speaker_encoder=True).eval()
    cpu_net.load_state_dict(model.net.state_dict())
    gen = torch.Generator().manual_seed(2)
    wavs = [(0.3 * torch.sin(0.02 * (k + 1) * torch.arange(22050.0)) + 0.05 * torch.randn(22050, generator=gen))
            .numpy() for k in range(2)]
    (_, spk), (_, spk_b) = (model.get_conditioning_latents(w, sr=22050) for w in wavs)
    card_net, model.net = model.net, cpu_net
    model.device = torch.device("cpu")
    try:
        _, spk_cpu = model.get_conditioning_latents(wavs[0], sr=22050)
    finally:
        model.net, model.device = card_net, torch.device("cuda")
    assert spk.shape == (1, 512) and float((spk.cpu() - spk_cpu).abs().max()) <= 1e-4
    assert float((spk - spk_b).abs().max()) > 1e-3
    lat = torch.randn(1, 8, 64, generator=gen).cuda()
    before = hifigan_mrf.launches
    got = model.net.decode_latents(lat, spk)
    launched = hifigan_mrf.launches - before
    with plain_mrf():
        ref = model.net.decode_latents(lat, spk)
    assert launched == 72 and float((got - ref).abs().max()) <= 1e-3
    assert float((model.net.decode_latents(lat, spk_b) - got).abs().max()) > 1e-4
