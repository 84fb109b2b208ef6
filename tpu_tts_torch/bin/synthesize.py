"""`tts` CLI of the port: synthesize speech from the command line.

Counterpart of `tpu_tts/bin/synthesize.py` (`make_parser`:37, `main`:83)
for models given by local path:

    python -m tpu_tts_torch.bin.synthesize --text "Hello." --model_path model.pth \\
        --config_path config.json --out_path out.wav [--vocoder_path v.pth --vocoder_config_path v.json]
    python -m tpu_tts_torch.bin.synthesize --list_models

The models run on `--device` (`cuda` unless told otherwise; `--device cpu`
off the card). `--model_name`/`--vocoder_name` need a download and raise
(ROADMAP.md). `--reference_wav` with `--reference_speaker_idx` converts a
recording into the voice of `--speaker_idx` (VITS with a posterior
encoder, i.e. a trained checkpoint).
"""

import argparse
import sys

description = """Synthesize speech on the command line with the PyTorch port.

Examples:
  # local model
  python -m tpu_tts_torch.bin.synthesize --text "Hello." --model_path model.pth --config_path config.json \\
      --out_path out.wav
  # with an external vocoder (WaveRNN, or a GAN vocoder: HiFi-GAN, MelGAN, multiband MelGAN, UnivNet)
  python -m tpu_tts_torch.bin.synthesize --text "Hello." --model_path glow.pth --config_path glow.json \\
      --vocoder_path wavernn.pth --vocoder_config_path wavernn.json --out_path out.wav
  python -m tpu_tts_torch.bin.synthesize --text "Hello." --model_path glow.pth --config_path glow.json \\
      --vocoder_path hifigan.pth --vocoder_config_path hifigan.json --out_path out.wav
  # a multi-speaker, multilingual model: pick a speaker and a language by name
  python -m tpu_tts_torch.bin.synthesize --text "Bonjour." --model_path model.pth --config_path config.json \\
      --speaker_idx spk_b --language_idx fr --out_path out.wav
  python -m tpu_tts_torch.bin.synthesize --model_path model.pth --config_path config.json --list_speaker_idxs
  # voice conversion: a recording of spk_a in spk_b's voice
  python -m tpu_tts_torch.bin.synthesize --model_path model.pth --config_path config.json \\
      --reference_wav spk_a.wav --reference_speaker_idx spk_a --speaker_idx spk_b --out_path out.wav
  # list released models (the registry; downloading them is not ported)
  python -m tpu_tts_torch.bin.synthesize --list_models
"""


def str2bool(v):
    if isinstance(v, bool):
        return v
    return v.lower() in ("yes", "true", "t", "y", "1")


def make_parser():
    parser = argparse.ArgumentParser(description=description, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--text", type=str, default=None, help="Text to synthesize.")
    parser.add_argument("--list_models", action="store_true", help="List released models from the registry.")
    parser.add_argument("--model_info_by_idx", type=str, default=None, help="<model_type>/<index>, e.g. tts_models/1.")
    parser.add_argument("--model_info_by_name", type=str, default=None, help="<model_type>/<lang>/<dataset>/<model>.")
    parser.add_argument("--model_name", type=str, default=None, help="Released model name (needs a download; "
                        "not ported).")
    parser.add_argument("--vocoder_name", type=str, default=None, help="Released vocoder name (not ported).")
    parser.add_argument("--config_path", type=str, default=None)
    parser.add_argument("--model_path", type=str, default=None)
    parser.add_argument("--out_path", type=str, default="tts_output.wav")
    parser.add_argument("--use_cuda", type=str2bool, default=False, help="Accepted for reference-CLI compat; "
                        "--device says where the models run.")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu.")
    parser.add_argument("--vocoder_path", type=str, default=None)
    parser.add_argument("--vocoder_config_path", type=str, default=None)
    parser.add_argument("--pipe_out", action="store_true", help="Also write the wav to stdout for shell pipes.")
    parser.add_argument("--speaker_idx", type=str, default=None)
    parser.add_argument("--language_idx", type=str, default=None)
    parser.add_argument("--speakers_file_path", type=str, default=None)
    parser.add_argument("--list_speaker_idxs", action="store_true")
    parser.add_argument("--list_language_idxs", action="store_true")
    parser.add_argument("--reference_wav", type=str, default=None, help="Speech to convert into --speaker_idx's voice.")
    parser.add_argument("--reference_speaker_idx", type=str, default=None, help="The speaker of --reference_wav.")
    return parser


def main(argv=None):
    args = make_parser().parse_args(argv)
    pipe_out = sys.stdout if args.pipe_out else None

    if args.list_models or args.model_info_by_idx or args.model_info_by_name:
        from tpu_tts_torch.zoo.manage import ModelManager

        manager = ModelManager()
        if args.list_models:
            manager.list_models()
        elif args.model_info_by_idx:
            manager.model_info_by_idx(args.model_info_by_idx)
        else:
            manager.model_info_by_full_name(args.model_info_by_name)
        return
    if (args.model_name and not args.model_path) or (args.vocoder_name and not args.vocoder_path):
        from tpu_tts_torch.zoo.manage import ModelManager

        ModelManager(verbose=False).download_model(args.model_name or args.vocoder_name)  # raises

    from tpu_tts_torch.infer.synthesizer import Synthesizer

    synthesizer = Synthesizer(
        tts_checkpoint=args.model_path or "",
        tts_config_path=args.config_path or "",
        vocoder_checkpoint=args.vocoder_path or "",
        vocoder_config=args.vocoder_config_path or "",
        device=args.device,
        tts_speakers_file=args.speakers_file_path or "",
    )
    if args.list_speaker_idxs:
        print(" > Available speaker ids:")
        print(synthesizer.speaker_manager.name_to_id if synthesizer.speaker_manager else {})
        return
    if args.list_language_idxs:
        print(" > Available language ids:")
        print(synthesizer.language_manager.name_to_id if synthesizer.language_manager else {})
        return
    if not args.text and not args.reference_wav:
        print(" [!] Define `--text` or `--reference_wav`.")
        sys.exit(1)
    print(f" > Text: {args.text}" if args.text else f" > Reference: {args.reference_wav}")
    wav = synthesizer.tts(text=args.text or "", speaker_name=args.speaker_idx or "",
                          language_name=args.language_idx or "", reference_wav=args.reference_wav,
                          reference_speaker_name=args.reference_speaker_idx)
    print(f" > Saving output to {args.out_path}")
    synthesizer.save_wav(wav, args.out_path, pipe_out=pipe_out)


if __name__ == "__main__":
    main()
