"""Dataset formatters: parse a dataset layout into sample dicts.

A copy of `tpu_tts/data/formatters.py`, which covers the formatter set of
Coqui TTS `TTS/tts/datasets/formatters.py`. Every formatter returns
`[{"text", "audio_file", "speaker_name", "root_path", ...}]`. Written against
the public dataset layouts.
"""

import csv
import glob
import os
import re
import xml.etree.ElementTree as ET
from typing import List, Optional


def _pipe_rows(path: str):
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if line:
                yield line.split("|")


# --------------------------------------------------------------------- single
def ljspeech(root_path, meta_file, **kwargs):
    """LJSpeech metadata.csv: `id|raw text|normalized text`."""
    txt_file = os.path.join(root_path, meta_file)
    items = []
    speaker_name = "ljspeech"
    for cols in _pipe_rows(txt_file):
        wav_file = os.path.join(root_path, "wavs", cols[0] + ".wav")
        try:
            text = cols[2]
        except IndexError:
            text = cols[1]
        items.append({"text": text, "audio_file": wav_file, "speaker_name": speaker_name, "root_path": root_path})
    return items


def ljspeech_test(root_path, meta_file, **kwargs):
    """LJSpeech format with round-robin fake speaker ids for multi-speaker tests."""
    txt_file = os.path.join(root_path, meta_file)
    items = []
    for idx, cols in enumerate(_pipe_rows(txt_file)):
        wav_file = os.path.join(root_path, "wavs", cols[0] + ".wav")
        items.append(
            {
                "text": cols[2] if len(cols) > 2 else cols[1],
                "audio_file": wav_file,
                "speaker_name": f"ljspeech-{idx % 10}",  # 10 round-robin speakers
                "root_path": root_path,
            }
        )
    return items


def thorsten(root_path, meta_file, **kwargs):
    """Thorsten de: `id|text`."""
    items = []
    for cols in _pipe_rows(os.path.join(root_path, meta_file)):
        wav_file = os.path.join(root_path, "wavs", cols[0] + ".wav")
        items.append({"text": cols[1], "audio_file": wav_file, "speaker_name": "thorsten", "root_path": root_path})
    return items


def tweb(root_path, meta_file, **kwargs):
    """TWEB: tab separated `id\ttext`."""
    items = []
    with open(os.path.join(root_path, meta_file), "r", encoding="utf-8") as f:
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 2:
                continue
            wav_file = os.path.join(root_path, cols[0] + ".wav")
            items.append({"text": cols[1], "audio_file": wav_file, "speaker_name": "tweb", "root_path": root_path})
    return items


def mozilla(root_path, meta_file, **kwargs):
    """Mozilla TTS (Judy): `batch_dir_num|wav|text` columns reversed: `wav|text`."""
    items = []
    for cols in _pipe_rows(os.path.join(root_path, meta_file)):
        wav_file = os.path.join(root_path, "wavs", cols[1].strip())
        items.append({"text": cols[0].strip(), "audio_file": wav_file, "speaker_name": "mozilla", "root_path": root_path})
    return items


def mozilla_de(root_path, meta_file, **kwargs):
    """German Mozilla dataset: `wav|text` with batch subdirs."""
    items = []
    with open(os.path.join(root_path, meta_file), "r", encoding="ISO 8859-1") as f:
        for line in f:
            cols = line.strip().split("|")
            if len(cols) < 2:
                continue
            title = cols[0].strip()
            folder_number = int(title.split("_", 1)[0]) // 1000
            wav_file = os.path.join(root_path, f"BATCH_{folder_number}_FINAL", title + ".wav")
            items.append({"text": cols[1].strip(), "audio_file": wav_file, "speaker_name": "mozilla", "root_path": root_path})
    return items


def sam_accenture(root_path, meta_file, **kwargs):
    """Sam (Accenture) recording-script XML."""
    xml_file = os.path.join(root_path, "voice_over_recordings", meta_file)
    xml_root = ET.parse(xml_file).getroot()
    items = []
    for item in xml_root.findall("./fileid"):
        text = item.text
        wav_file = os.path.join(root_path, "vo_voice_quality_transformation", item.get("id") + ".wav")
        if not os.path.exists(wav_file):
            print(f" [!] {wav_file} in metafile does not exist. Skipping...")
            continue
        items.append({"text": text, "audio_file": wav_file, "speaker_name": "sam_accenture", "root_path": root_path})
    return items


def ruslan(root_path, meta_file, **kwargs):
    """RUSLAN russian single speaker: `id|text`."""
    items = []
    for cols in _pipe_rows(os.path.join(root_path, meta_file)):
        wav_file = os.path.join(root_path, "RUSLAN", cols[0] + ".wav")
        items.append({"text": cols[1], "audio_file": wav_file, "speaker_name": "ruslan", "root_path": root_path})
    return items


def css10(root_path, meta_file, **kwargs):
    """CSS10: `path|text|norm`."""
    items = []
    for cols in _pipe_rows(os.path.join(root_path, meta_file)):
        wav_file = os.path.join(root_path, cols[0])
        items.append({"text": cols[1], "audio_file": wav_file, "speaker_name": "css10", "root_path": root_path})
    return items


def nancy(root_path, meta_file, **kwargs):
    """Nancy (Blizzard 2011) prompts file."""
    items = []
    with open(os.path.join(root_path, meta_file), "r", encoding="utf-8") as f:
        for line in f:
            utt_id = line.split()[1]
            text = line[line.find('"') + 1 : line.rfind('"') - 1]
            wav_file = os.path.join(root_path, "wavn", utt_id + ".wav")
            items.append({"text": text, "audio_file": wav_file, "speaker_name": "nancy", "root_path": root_path})
    return items


def blizzard2013(root_path, meta_file, **kwargs):
    """Blizzard 2013 (segmented): `id|text`."""
    items = []
    for cols in _pipe_rows(os.path.join(root_path, meta_file)):
        wav_file = os.path.join(root_path, "wavs", cols[0] + ".wav")
        items.append({"text": cols[1], "audio_file": wav_file, "speaker_name": "ljspeech", "root_path": root_path})
    return items


def baker(root_path: str, meta_file: str, **kwargs) -> List[dict]:
    """Chinese Standard Mandarin (Baker): `wav_name|text`."""
    items = []
    for cols in _pipe_rows(os.path.join(root_path, meta_file)):
        wav_file = os.path.join(root_path, "clips_22", cols[0])
        items.append({"text": cols[1], "audio_file": wav_file, "speaker_name": "baker", "root_path": root_path})
    return items


def kokoro(root_path, meta_file, **kwargs):
    """Japanese Kokoro: `id|raw|norm`."""
    items = []
    for cols in _pipe_rows(os.path.join(root_path, meta_file)):
        wav_file = os.path.join(root_path, "wavs", cols[0] + ".wav")
        items.append({"text": cols[2].replace(" ", ""), "audio_file": wav_file, "speaker_name": "kokoro", "root_path": root_path})
    return items


def kss(root_path, meta_file, **kwargs):
    """Korean single speaker (KSS): `path|raw|expanded|norm|...`."""
    items = []
    for cols in _pipe_rows(os.path.join(root_path, meta_file)):
        wav_file = os.path.join(root_path, cols[0])
        items.append({"text": cols[2], "audio_file": wav_file, "speaker_name": "kss", "root_path": root_path})
    return items


def bel_tts_formatter(root_path, meta_file, **kwargs):
    """Belarusian: `path|text`."""
    items = []
    for cols in _pipe_rows(os.path.join(root_path, meta_file)):
        wav_file = os.path.join(root_path, cols[0])
        items.append({"text": cols[1], "audio_file": wav_file, "speaker_name": "bel_tts", "root_path": root_path})
    return items


def custom_turkish(root_path, meta_file, **kwargs):
    items = []
    skipped_files = []
    for cols in _pipe_rows(os.path.join(root_path, meta_file)):
        wav_file = os.path.join(root_path, "wavs", cols[0].strip() + ".wav")
        if not os.path.exists(wav_file):
            skipped_files.append(wav_file)
            continue
        items.append({"text": cols[1].strip(), "audio_file": wav_file, "speaker_name": "turkish-female", "root_path": root_path})
    print(f" [!] {len(skipped_files)} files skipped. They don't exist...")
    return items


# ---------------------------------------------------------------- multispeaker
def mailabs(root_path, meta_files=None, ignored_speakers=None):
    """M-AILABS: by_book/<gender>/<speaker>/<book>/metadata.csv layout."""
    speaker_regex = re.compile(r"by_book/(male|female)/(?P<speaker_name>[^/]+)/")
    if not meta_files:
        csv_files = glob.glob(root_path + "/**/metadata.csv", recursive=True)
    else:
        csv_files = meta_files if isinstance(meta_files, list) else [meta_files]
    items = []
    for csv_file in csv_files:
        txt_file = csv_file if os.path.isabs(csv_file) else os.path.join(root_path, csv_file)
        folder = os.path.dirname(txt_file)
        speaker_match = speaker_regex.search(txt_file.replace("\\", "/"))
        if speaker_match is None:
            continue
        speaker_name = speaker_match.group("speaker_name")
        if isinstance(ignored_speakers, list) and speaker_name in ignored_speakers:
            continue
        print(" | > {}".format(csv_file))
        for cols in _pipe_rows(txt_file):
            if not meta_files:
                wav_file = os.path.join(folder, "wavs", cols[0] + ".wav")
            else:
                wav_file = os.path.join(root_path, folder.replace("metadata.csv", ""), "wavs", cols[0] + ".wav")
            if os.path.isfile(wav_file):
                items.append({"text": cols[1], "audio_file": wav_file, "speaker_name": speaker_name, "root_path": root_path})
            else:
                raise RuntimeError(f"> File {wav_file} does not exist!")
    return items


def common_voice(root_path, meta_file, ignored_speakers=None):
    """Mozilla Common Voice tsv: client_id, path, sentence columns."""
    items = []
    with open(os.path.join(root_path, meta_file), "r", encoding="utf-8") as f:
        reader = csv.DictReader(f, delimiter="\t")
        for row in reader:
            speaker_name = row["client_id"]
            if isinstance(ignored_speakers, list) and speaker_name in ignored_speakers:
                continue
            wav_file = os.path.join(root_path, "clips", row["path"].replace(".mp3", ".wav"))
            items.append({"text": row["sentence"], "audio_file": wav_file, "speaker_name": "MCV_" + speaker_name, "root_path": root_path})
    return items


def libri_tts(root_path, meta_files=None, ignored_speakers=None):
    """LibriTTS: *.trans.tsv per chapter or explicit meta files."""
    items = []
    if not meta_files:
        meta_files = glob.glob(f"{root_path}/**/*trans.tsv", recursive=True)
    else:
        if isinstance(meta_files, str):
            meta_files = [os.path.join(root_path, meta_files)]
    for meta_file in meta_files:
        _meta_file = os.path.basename(meta_file).split(".")[0]
        with open(meta_file, "r", encoding="utf-8") as f:
            for line in f:
                cols = line.rstrip("\n").split("\t")
                file_name = cols[0]
                speaker_name, chapter_id, *_ = cols[0].split("_")
                _root_path = os.path.join(root_path, f"{speaker_name}/{chapter_id}")
                wav_file = os.path.join(_root_path, file_name + ".wav")
                if isinstance(ignored_speakers, list) and speaker_name in ignored_speakers:
                    continue
                items.append(
                    {"text": cols[2] if len(cols) > 2 else cols[1], "audio_file": wav_file, "speaker_name": f"LTTS_{speaker_name}", "root_path": root_path}
                )
    for item in items:
        assert os.path.exists(item["audio_file"]), f" [!] wav files don't exist - {item['audio_file']}"
    return items


def brspeech(root_path, meta_file, ignored_speakers=None):
    """BRSpeech 3.0 beta: `wav|text|?|speaker_id`."""
    items = []
    for cols in _pipe_rows(os.path.join(root_path, meta_file)):
        if cols[0] == "wav_filename":
            continue
        wav_file = os.path.join(root_path, cols[0])
        speaker_id = cols[3]
        if isinstance(ignored_speakers, list) and speaker_id in ignored_speakers:
            continue
        items.append({"text": cols[2], "audio_file": wav_file, "speaker_name": speaker_id, "root_path": root_path})
    return items


def vctk(root_path, meta_files=None, wavs_path="wav48_silence_trimmed", mic="mic1", ignored_speakers=None):
    """VCTK with flac mics layout."""
    items = []
    meta_files = glob.glob(f"{os.path.join(root_path, 'txt')}/**/*.txt", recursive=True)
    for meta_file in meta_files:
        _, speaker_id, txt_file = os.path.relpath(meta_file, root_path).split(os.sep)
        file_id = txt_file.split(".")[0]
        if isinstance(ignored_speakers, list) and speaker_id in ignored_speakers:
            continue
        with open(meta_file, "r", encoding="utf-8") as f:
            text = f.readlines()[0]
        wav_file = os.path.join(root_path, wavs_path, speaker_id, file_id + f"_{mic}.flac")
        if not os.path.exists(wav_file):
            wav_file = os.path.join(root_path, wavs_path, speaker_id, file_id + ".wav")
        if os.path.exists(wav_file):
            items.append({"text": text, "audio_file": wav_file, "speaker_name": "VCTK_" + speaker_id, "root_path": root_path})
        else:
            print(f" [!] wav files don't exist - {wav_file}")
    return items


def vctk_old(root_path, meta_files=None, wavs_path="wav48", ignored_speakers=None):
    """VCTK, original wav48 layout."""
    items = []
    meta_files = glob.glob(f"{os.path.join(root_path, 'txt')}/**/*.txt", recursive=True)
    for meta_file in meta_files:
        _, speaker_id, txt_file = os.path.relpath(meta_file, root_path).split(os.sep)
        file_id = txt_file.split(".")[0]
        if isinstance(ignored_speakers, list) and speaker_id in ignored_speakers:
            continue
        with open(meta_file, "r", encoding="utf-8") as f:
            text = f.readlines()[0]
        wav_file = os.path.join(root_path, wavs_path, speaker_id, file_id + ".wav")
        items.append({"text": text, "audio_file": wav_file, "speaker_name": "VCTK_old_" + speaker_id, "root_path": root_path})
    return items


def synpaflex(root_path, metafiles=None, **kwargs):
    """SynPaFlex french audiobook corpus."""
    items = []
    speaker_name = "synpaflex"
    root_path = os.path.join(root_path, "")
    wav_files = glob.glob(f"{root_path}**/*.wav", recursive=True)
    for wav_file in wav_files:
        if os.sep + "wav" + os.sep in wav_file:
            txt_file = wav_file.replace("wav", "txt")
        else:
            txt_file = os.path.join(
                os.path.dirname(wav_file), "txt", os.path.basename(wav_file).replace(".wav", ".txt")
            )
        if os.path.exists(txt_file) and os.path.exists(wav_file):
            with open(txt_file, "r", encoding="utf-8") as f:
                text = f.readlines()[0]
            items.append({"text": text, "audio_file": wav_file, "speaker_name": speaker_name, "root_path": root_path})
    return items


def open_bible(root_path, meta_files="train", ignore_digits_sentences=True, ignored_speakers=None):
    """OpenBible (BibleTTS) split dirs with txt next to flac."""
    items = []
    split_dir = meta_files
    meta_files = glob.glob(f"{os.path.join(root_path, split_dir)}/**/*.txt", recursive=True)
    for meta_file in meta_files:
        _, speaker_id, txt_file = os.path.relpath(meta_file, root_path).split(os.sep)
        file_id = txt_file.split(".")[0]
        if isinstance(ignored_speakers, list) and speaker_id in ignored_speakers:
            continue
        with open(meta_file, "r", encoding="utf-8") as f:
            text = f.readline().replace("\n", "")
        if ignore_digits_sentences and any(map(str.isdigit, text)):
            continue
        wav_file = os.path.join(root_path, split_dir, speaker_id, file_id + ".flac")
        items.append({"text": text, "audio_file": wav_file, "speaker_name": "OB_" + speaker_id, "root_path": root_path})
    return items


def mls(root_path, meta_files=None, ignored_speakers=None):
    """Multilingual LibriSpeech: transcripts.txt `speaker_chapter_utt\ttext`."""
    items = []
    with open(os.path.join(root_path, meta_files), "r", encoding="utf-8") as meta:
        for line in meta:
            file, text = line.split("\t")
            text = text[:-1]
            speaker, book, *_ = file.split("_")
            wav_file = os.path.join(root_path, os.path.dirname(meta_files), "audio", speaker, book, file + ".wav")
            if isinstance(ignored_speakers, list) and speaker in ignored_speakers:
                continue
            items.append({"text": text, "audio_file": wav_file, "speaker_name": "MLS_" + speaker, "root_path": root_path})
    return items


# ------------------------------------------------------------ speaker-encoder
def _voxcel_x(root_path, meta_file, voxcel_idx):
    """Shared VoxCeleb 1/2 walker; builds a cached meta csv on first run."""
    assert voxcel_idx in ["1", "2"]
    expected_count = 148_000 if voxcel_idx == "1" else 1_000_000
    voxceleb_path = os.path.join(root_path, "")
    cache_to = os.path.join(voxceleb_path, f"metafile_voxceleb{voxcel_idx}.csv")
    os.makedirs(os.path.dirname(cache_to), exist_ok=True)

    if meta_file is None and not os.path.exists(cache_to):
        cnt = 0
        meta_data = []
        wav_files = glob.glob(os.path.join(voxceleb_path, "**", "*.wav"), recursive=True)
        for path in wav_files:
            speaker_id = os.path.relpath(path, voxceleb_path).split(os.sep)[0]
            text = None
            meta_data.append(f"{text}|{path}|voxcel{voxcel_idx}_{speaker_id}\n")
            cnt += 1
        with open(cache_to, "w", encoding="utf-8") as f:
            f.write("".join(meta_data))
        if cnt < expected_count:
            print(f" [!] Found {cnt} wav files; expected ~{expected_count} for voxceleb{voxcel_idx}")

    with open(meta_file if meta_file is not None else cache_to, "r", encoding="utf-8") as f:
        items = []
        for line in f:
            text, wav_file, speaker_name = line.rstrip("\n").split("|")
            items.append({"text": text if text != "None" else None, "audio_file": wav_file, "speaker_name": speaker_name, "root_path": root_path})
    return items


def voxceleb2(root_path, meta_file=None, **kwargs):
    return _voxcel_x(root_path, meta_file, voxcel_idx="2")


def voxceleb1(root_path, meta_file=None, **kwargs):
    return _voxcel_x(root_path, meta_file, voxcel_idx="1")


# ----------------------------------------------------------------------- misc
def coqui(root_path, meta_file, ignored_speakers=None):
    """Generic csv with `audio_file|text[|speaker_name][|emotion_name]` header."""
    import pandas as pd

    metadata = pd.read_csv(os.path.join(root_path, meta_file), sep="|")
    assert all(x in metadata.columns for x in ["audio_file", "text"])
    speaker_name = None if "speaker_name" in metadata.columns else "coqui"
    emotion_name = None if "emotion_name" in metadata.columns else "neutral"
    items = []
    not_found_counter = 0
    for row in metadata.itertuples():
        if speaker_name is None and isinstance(ignored_speakers, list) and row.speaker_name in ignored_speakers:
            continue
        audio_path = os.path.join(root_path, row.audio_file)
        if not os.path.exists(audio_path):
            not_found_counter += 1
            continue
        items.append(
            {
                "text": row.text,
                "audio_file": audio_path,
                "speaker_name": speaker_name if speaker_name is not None else row.speaker_name,
                "emotion_name": emotion_name if emotion_name is not None else row.emotion_name,
                "root_path": root_path,
            }
        )
    if not_found_counter > 0:
        print(f" | > [!] {not_found_counter} files not found")
    return items


def cml_tts(root_path, meta_file, ignored_speakers=None):
    """CML-TTS: csv with wav_filename/transcript[/client_id] columns."""
    import pandas as pd

    metadata = pd.read_csv(os.path.join(root_path, meta_file), sep="|")
    assert all(x in metadata.columns for x in ["wav_filename", "transcript"])
    client_id = None if "client_id" in metadata.columns else "default"
    items = []
    not_found_counter = 0
    for row in metadata.itertuples():
        if client_id is None and isinstance(ignored_speakers, list) and row.client_id in ignored_speakers:
            continue
        audio_path = os.path.join(root_path, row.wav_filename)
        if not os.path.exists(audio_path):
            not_found_counter += 1
            continue
        items.append(
            {
                "text": row.transcript,
                "audio_file": audio_path,
                "speaker_name": client_id if client_id is not None else row.client_id,
                "root_path": root_path,
            }
        )
    if not_found_counter > 0:
        print(f" | > [!] {not_found_counter} files not found")
    return items


def emotion(root_path, meta_file, ignored_speakers=None):
    """Emotion dataset csv: file_path,speaker_id,emotion_id columns."""
    items = []
    with open(os.path.join(root_path, meta_file), "r", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        for row in reader:
            speaker_id = row["speaker_id"]
            if isinstance(ignored_speakers, list) and speaker_id in ignored_speakers:
                continue
            items.append(
                {
                    "audio_file": os.path.join(root_path, row["file_path"]),
                    "speaker_name": speaker_id,
                    "emotion_name": row["emotion_id"],
                    "root_path": root_path,
                }
            )
    return items
