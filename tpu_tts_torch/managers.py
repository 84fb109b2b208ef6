"""Speaker, language and embedding managers of the port.

Counterpart of `tpu_tts/managers.py` (`load_file`:17, `BaseIDManager`:46,
`EmbeddingManager`:76 with `get_mean_embedding`:144, `SpeakerManager`:182,
`LanguageManager`:227), the surface of Coqui TTS's `managers.py`,
`speakers.py` and `languages.py`. Id files map names to ids; embedding
files are `{clip_name: {"name": speaker, "embedding": [...]}}`, stored as
`.json`, a numpy-pickled `.npy` or a `.pth`. `d_vector_file` may be a list
of such files, merged.

Training reads the rest: ids from dataset samples (`data_items`,
`set_ids_from_data`), `save_ids_to_file`, `embeddings_by_names`, and the
speaker, language and length balancers' sample weights
(`_class_balancer_weights`:268-290). A manager built with an encoder
checkpoint and config (or given one by `init_encoder`, `:160-170`)
computes d-vectors from clips (`compute_embedding_from_clip`, `:172-180`):
each clip loaded at the encoder's rate, its windowed embedding
(`encoder/models.py`), the mean over the clips. The encoder runs on the
manager's `device`, the card unless told otherwise.
"""

import bisect
import json
from typing import Any, Dict, List, Optional

import numpy as np


def load_file(path: str):
    if path.endswith(".json"):
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    if path.endswith(".npy") or path.endswith(".npz"):
        return np.load(path, allow_pickle=True).item()
    if path.endswith(".pth"):
        from tpu_tts_torch.utils.checkpoint import read_checkpoint

        return read_checkpoint(path)
    raise ValueError(f" [!] Unsupported file type {path}")


def save_file(obj: Any, path: str):
    if path.endswith(".json"):
        with open(path, "w", encoding="utf-8") as f:
            json.dump(obj, f, indent=2)
    elif path.endswith(".pth"):
        import torch

        torch.save(obj, path)
    else:
        raise ValueError(f" [!] Unsupported file type {path}")


class BaseIDManager:
    """name ↔ id mapping from dataset samples or a stored file."""

    def __init__(self, id_file_path: str = ""):
        self.name_to_id: Dict[str, int] = {}
        if id_file_path:
            self.name_to_id = load_file(id_file_path)

    def set_ids_from_data(self, items: List, parse_key: str) -> None:
        """Ids 0… of the sorted distinct `parse_key` values of `items`."""
        names = sorted({item[parse_key] for item in items if parse_key in item})
        self.name_to_id = {name: i for i, name in enumerate(names)}

    def save_ids_to_file(self, file_path: str) -> None:
        save_file(self.name_to_id, file_path)


class EmbeddingManager(BaseIDManager):
    """A store of d-vectors by clip and by speaker name."""

    def __init__(self, embedding_file_path="", id_file_path: str = "", encoder_model_path: str = "",
                 encoder_config_path: str = "", device=None):
        super().__init__(id_file_path)
        self.embeddings: Dict[str, Dict] = {}
        self.embeddings_by_name: Dict[str, List] = {}
        self.device = device
        self.encoder = None
        self.encoder_config = None
        self.encoder_ap = None
        if embedding_file_path:
            if isinstance(embedding_file_path, list):
                self.load_embeddings_from_list_of_files(embedding_file_path)
            else:
                self.load_embeddings_from_file(embedding_file_path)
        if encoder_model_path and encoder_config_path:
            self.init_encoder(encoder_model_path, encoder_config_path)

    def _set_embeddings(self, embeddings: Dict):
        self.embeddings = embeddings
        speakers = sorted({x["name"] for x in self.embeddings.values()})
        self.name_to_id = {name: i for i, name in enumerate(speakers)}
        by_name: Dict[str, List] = {}
        for x in self.embeddings.values():
            by_name.setdefault(x["name"], []).append(x["embedding"])
        self.embeddings_by_name = by_name

    def load_embeddings_from_file(self, file_path: str):
        self._set_embeddings(load_file(file_path))

    def load_embeddings_from_list_of_files(self, file_paths: List[str]):
        all_embeddings: Dict = {}
        for path in file_paths:
            all_embeddings.update(load_file(path))
        self._set_embeddings(all_embeddings)

    def embeddings_by_names(self) -> Dict[str, List]:
        return self.embeddings_by_name

    def get_embeddings_by_name(self, idx: str) -> List[List]:
        return self.embeddings_by_name[idx]

    def get_mean_embedding(self, idx: str, num_samples: Optional[int] = None) -> np.ndarray:
        """The mean d-vector of speaker `idx`: over every clip with
        `num_samples=None`, else over its first `num_samples` clips."""
        embeddings = np.array(self.get_embeddings_by_name(idx))
        if num_samples is None:
            return embeddings.mean(0)
        if len(embeddings) < num_samples:
            raise ValueError(f" [!] {idx} has fewer embeddings than num_samples")
        return embeddings[:num_samples].mean(0)

    def init_encoder(self, model_path: str, config_path: str, device=None) -> None:
        """Load the speaker encoder (a port or Coqui checkpoint and its config)
        and its `AudioProcessor`, on `device` (else the manager's)."""
        from tpu_tts_torch.audio import AudioProcessor
        from tpu_tts_torch.config import load_config
        from tpu_tts_torch.encoder.models import setup_encoder_model

        self.encoder_config = load_config(config_path)
        self.encoder = setup_encoder_model(self.encoder_config, device=device or self.device)
        self.encoder.load_checkpoint(self.encoder_config, model_path, eval=True)
        self.encoder_ap = AudioProcessor.init_from_config(self.encoder_config)

    def compute_embedding_from_clip(self, wav_file) -> list:
        """The mean d-vector of one clip or a list of clips (paths)."""
        if self.encoder is None:
            raise RuntimeError(" [!] Speaker encoder not initialized.")
        files = wav_file if isinstance(wav_file, list) else [wav_file]
        embs = [self.encoder.compute_embedding(self.encoder_ap.load_wav(f, sr=self.encoder_ap.sample_rate))
                for f in files]
        return np.stack(embs).mean(0).flatten().tolist()


class SpeakerManager(EmbeddingManager):
    def __init__(self, data_items: Optional[List] = None, d_vectors_file_path="", speaker_id_file_path: str = "",
                 encoder_model_path: str = "", encoder_config_path: str = "", device=None):
        super().__init__(
            embedding_file_path=d_vectors_file_path,
            id_file_path=speaker_id_file_path,
            encoder_model_path=encoder_model_path,
            encoder_config_path=encoder_config_path,
            device=device,
        )
        if data_items:
            self.set_ids_from_data(data_items, parse_key="speaker_name")

    @property
    def num_speakers(self):
        return len(self.name_to_id)

    @property
    def speaker_names(self):
        return list(self.name_to_id.keys())

    @staticmethod
    def init_from_config(config, samples: Optional[List] = None) -> Optional["SpeakerManager"]:
        """From a model's args (or a config): the speakers of the training
        `samples`, or the speakers file, of a speaker embedding table; or
        the d-vector file(s)."""
        speaker_manager = None
        if getattr(config, "use_speaker_embedding", False):
            if samples:
                speaker_manager = SpeakerManager(data_items=samples)
            if getattr(config, "speaker_file", None):
                speaker_manager = SpeakerManager(speaker_id_file_path=config.speaker_file)
            if getattr(config, "speakers_file", None):
                speaker_manager = SpeakerManager(speaker_id_file_path=config.speakers_file)
        if getattr(config, "use_d_vector_file", False):
            speaker_manager = SpeakerManager()
            if getattr(config, "d_vector_file", None):
                speaker_manager = SpeakerManager(d_vectors_file_path=config.d_vector_file)
        return speaker_manager


class LanguageManager(BaseIDManager):
    def __init__(self, language_ids_file_path: str = "", config=None):
        super().__init__(id_file_path=language_ids_file_path)
        if config:
            self.name_to_id = self.parse_language_ids_from_config(config)

    @property
    def num_languages(self):
        return len(self.name_to_id)

    @property
    def language_names(self):
        return list(self.name_to_id.keys())

    @staticmethod
    def parse_language_ids_from_config(c) -> Dict:
        languages = set()
        for dataset in c.datasets:
            if dataset.language:
                languages.add(dataset.language)
            else:
                raise ValueError(f" [!] Dataset {dataset.dataset_name} has no language specified.")
        return {name: i for i, name in enumerate(sorted(languages))}

    @staticmethod
    def init_from_config(config) -> Optional["LanguageManager"]:
        """From the full model config: the language flags may sit on
        `model_args`, the dataset list at the top level."""
        args = getattr(config, "model_args", None) or config
        if getattr(args, "use_language_embedding", False):
            if getattr(args, "language_ids_file", None):
                return LanguageManager(language_ids_file_path=args.language_ids_file)
            return LanguageManager(config=config if hasattr(config, "datasets") else None)
        return None


def _class_balancer_weights(names: np.ndarray) -> np.ndarray:
    """Inverse-frequency sample weights of each item's class, L2-normalised."""
    unique, counts = np.unique(names, return_counts=True)
    per_class = 1.0 / counts
    w = np.array([per_class[np.where(unique == n)[0][0]] for n in names], dtype=np.float64)
    return w / np.linalg.norm(w)


def get_speaker_balancer_weights(items: list) -> np.ndarray:
    return _class_balancer_weights(np.array([item["speaker_name"] for item in items]))


def get_language_balancer_weights(items: list) -> np.ndarray:
    return _class_balancer_weights(np.array([item["language"] for item in items]))


def get_length_balancer_weights(items: list, num_buckets: int = 10) -> np.ndarray:
    """Audio lengths in `num_buckets` equal-width classes, each item weighted
    by the inverse population of its class."""
    lengths = np.array([item.get("audio_length") or len(item.get("text", "")) for item in items], dtype=np.float64)
    max_length, min_length = int(lengths.max()), int(lengths.min())
    step = int((max_length - min_length) / num_buckets) + 1
    buckets_classes = [i + step for i in range(min_length, (max_length - step) + num_buckets + 1, step)]
    bucket_names = np.array([buckets_classes[bisect.bisect_left(buckets_classes, n)] for n in lengths])
    return _class_balancer_weights(bucket_names)
