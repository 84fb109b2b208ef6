"""ModelManager: the catalogue of released models.

Counterpart of `tpu_tts/zoo/manage.py` (`ModelManager`:36, `list_models`:
66-85, `model_info_by_idx`:98, `model_info_by_full_name`:130), reading the
port's copy of the registry, `models.json` beside this file (the public
release index of Coqui TTS models). Listing and describing models works
offline. Downloading them needs the network, so `download_model` and
loading a model by name are not ported: they raise and stand in
ROADMAP.md.
"""

import json
import os
from typing import Dict, List


class ModelManager:
    def __init__(self, models_file: str = None, output_prefix: str = None, progress_bar: bool = False,
                 verbose: bool = True):
        self.progress_bar = progress_bar
        self.verbose = verbose
        self.output_prefix = output_prefix
        self.models_file = models_file or os.path.join(os.path.dirname(__file__), "models.json")
        self.models_dict = self.read_models_file()

    def read_models_file(self) -> Dict:
        with open(self.models_file, "r", encoding="utf-8") as f:
            return json.load(f)

    # ------------------------------------------------------------- catalogue
    def _list_models(self, model_type: str, model_count: int = 0) -> List[str]:
        model_list = []
        for lang in self.models_dict[model_type]:
            for dataset in self.models_dict[model_type][lang]:
                for model in self.models_dict[model_type][lang][dataset]:
                    if self.verbose:
                        print(f" {model_count}: {model_type}/{lang}/{dataset}/{model}")
                    model_list.append(f"{model_type}/{lang}/{dataset}/{model}")
                    model_count += 1
        return model_list

    def list_models(self) -> List[str]:
        models = []
        for model_type in self.models_dict:
            models += self._list_models(model_type, len(models))
        return models

    def list_tts_models(self):
        return self._list_models("tts_models")

    def list_vocoder_models(self):
        return self._list_models("vocoder_models")

    def list_vc_models(self):
        return self._list_models("voice_conversion_models")

    def model_info_by_idx(self, model_query: str):
        """Print the registry entry `<model_type>/<1-based index>`."""
        model_name_list = []
        model_type, model_query_idx = model_query.split("/")
        try:
            model_query_idx = int(model_query_idx)
            if model_query_idx <= 0:
                print("> model_query_idx should be a positive integer!")
                return
        except (TypeError, ValueError):
            print("> model_query_idx should be an integer!")
            return
        if model_type not in self.models_dict:
            print(f"> model_type {model_type} does not exist in the list.")
            return
        for lang in self.models_dict[model_type]:
            for dataset in self.models_dict[model_type][lang]:
                for model in self.models_dict[model_type][lang][dataset]:
                    model_name_list.append(f"{model_type}/{lang}/{dataset}/{model}")
        if model_query_idx > len(model_name_list):
            print(f"model query idx exceeds the number of available models [{len(model_name_list)}]")
            return
        model_type, lang, dataset, model = model_name_list[model_query_idx - 1].split("/")
        print(f"> model type : {model_type}")
        print(f"> language supported : {lang}")
        print(f"> dataset used : {dataset}")
        print(f"> model name : {model}")
        info = self.models_dict[model_type][lang][dataset][model]
        if "description" in info:
            print(f"> description : {info['description']}")

    def model_info_by_full_name(self, model_query_name: str):
        """Print the registry entry `<model_type>/<lang>/<dataset>/<model>`."""
        model_type, lang, dataset, model = model_query_name.split("/")
        try:
            info = self.models_dict[model_type][lang][dataset][model]
        except KeyError:
            print(f"> model {model_query_name} does not exist in the registry.")
            return
        for key in ("description", "default_vocoder", "license", "author"):
            if key in info:
                print(f"> {key} : {info[key]}")

    def download_model(self, model_name: str):
        raise NotImplementedError(
            f"downloading `{model_name}` needs the network; loading released models by name is not ported "
            "(ROADMAP.md): pass --model_path and --config_path"
        )
