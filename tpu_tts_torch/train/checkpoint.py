"""Training checkpoints in Coqui's `.pth` format, with `config.json` beside them.

Counterpart of `tpu_tts/train/checkpoint.py` (`save_checkpoint`:27,
`get_last_checkpoint`:78, `save_best_model`:100, `copy_model_files`:122).
Where the JAX package writes orbax directories, the port writes what Coqui's
trainer writes: `<output_dir>/checkpoint_<step>.pth` (and
`best_model_<step>.pth`) holding `{"model", "optimizer", "step", "epoch",
"config", ...}`, so `utils/checkpoint.py`, the `Synthesizer` and Coqui's
own loaders read it.
"""

import glob
import json
import os
import re
from typing import Dict, Optional, Tuple

import torch

from tpu_tts_torch.utils.checkpoint import read_checkpoint


def _step_of(path: str) -> int:
    m = re.search(r"_(\d+)\.pth$", path)
    return int(m.group(1)) if m else -1


def save_checkpoint(state: Dict, output_dir: str, step: int, config=None, prefix: str = "checkpoint",
                    keep_n: Optional[int] = None) -> str:
    """Write `state` as `<output_dir>/<prefix>_<step>.pth` (through a
    temporary file, so a reader never sees half of it), the config as
    `config.json` beside it, and keep the newest `keep_n` of the prefix."""
    path = os.path.abspath(os.path.join(output_dir, f"{prefix}_{step}.pth"))
    if config is not None:
        state = {**state, "config": config.to_dict()}
        config.save_json(os.path.join(output_dir, "config.json"))
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    if keep_n:
        for old in sorted(glob.glob(os.path.join(output_dir, f"{prefix}_*.pth")), key=_step_of)[:-keep_n]:
            os.remove(old)
    return path


def load_checkpoint(path: str) -> Dict:
    """A training checkpoint (the port's or Coqui's), on the CPU."""
    return read_checkpoint(path)


def get_last_checkpoint(output_dir: str) -> Tuple[str, str]:
    """(the newest checkpoint, the newest best model or else that checkpoint)."""

    def latest(prefix):
        paths = [p for p in glob.glob(os.path.join(output_dir, f"{prefix}_*.pth")) if _step_of(p) >= 0]
        return max(paths, key=_step_of) if paths else None

    last = latest("checkpoint")
    if last is None:
        raise ValueError(f" [!] No checkpoints found in {output_dir}")
    return last, latest("best_model") or last


def save_best_model(current_loss: float, best_loss: float, state: Dict, output_dir: str, step: int, config=None,
                    keep_all_best: bool = False) -> float:
    """Save `state` as the best model when `current_loss` beats `best_loss`;
    returns the best loss so far."""
    if current_loss < best_loss:
        save_checkpoint(state, output_dir, step, config=config, prefix="best_model",
                        keep_n=None if keep_all_best else 1)
        print(f" > BEST MODEL : loss {current_loss:.5f} @ step {step}")
        return current_loss
    return best_loss


def copy_model_files(config, output_dir: str, new_fields: Optional[Dict] = None):
    """Write the config (and extra fields) as `config.json` beside the checkpoints."""
    data = config.to_dict()
    if new_fields:
        data.update(new_fields)
    with open(os.path.join(output_dir, "config.json"), "w", encoding="utf-8") as f:
        json.dump(data, f, indent=4, default=str)
