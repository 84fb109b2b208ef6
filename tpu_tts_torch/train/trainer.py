"""The port's trainer: the JAX trainer's loop, contract and checkpoints, on one device.

Counterpart of `tpu_tts/train/trainer.py` (`TrainerArgs`:37, `Trainer`:74,
`train_step`:363, `_fit`:413, `eval_epoch`:565, `_restore`:615). A step runs
the model's optimizers in index order, each on the parameters the one
before it left: for a GAN the discriminator (0) first, then the generator
(1) against the updated discriminator, each sub-step with its own generator
forward and its own draws. The model's side of the contract:
`init_training()`, `num_optimizers()`, `get_optimizer()` (one
`TrainOptimizer` per index), `loss_fn(batch, optimizer_idx, generator)`,
`get_data_loader(...)`, `train(mode)`, `training_state_dict()` and
`load_training_state(state, strict)`, and optionally
`on_init_start(trainer)`, called once before the first step when there
are training samples (JAX's `:152`).

Randomness: the model's draws come from one `torch.Generator` on the
device, seeded with `training_seed`; dropout draws from torch's default
generators, which the trainer seeds too. A checkpoint holds all of their
states, so a resumed run draws what the uninterrupted run would have.

Mixed precision (`mixed_precision`, `train/precision.py`, JAX's `:254-279`):
a model that handles it itself (VITS) computes its chosen modules in
bfloat16; any other gets the generic cast, its `net`'s parameters and the
batch in bfloat16 for the forward. Either way the parameters, gradients,
optimizer state and losses stay float32.

The dashboard logger (JAX's `:200-210`): with `dashboard_logger ==
"tensorboard"` and `tensorboardX` installed, a `SummaryWriter` under
`<output_path>/logs` gets every step's `train/<k>` scalars and each eval's
`eval/loss`, is flushed at the end of each epoch and closed (every queued
event written) when `fit` returns; without the package, nothing is logged.

Not ported, by design or not yet (ROADMAP.md): the mesh and its shardings,
multi-process data parallelism (M10), the fused single-program step, buffer
donation and the jax.profiler window (XLA's), and the per-epoch `test_run`
synthesis (a stub in `tpu_tts` too, so no audio reaches the logger).
"""

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from tpu_tts_torch.config.base import Coqpit
from tpu_tts_torch.device import resolve_device
from tpu_tts_torch.train import checkpoint as ckpt_io
from tpu_tts_torch.train import precision


@dataclass
class TrainerArgs(Coqpit):
    """CLI-facing trainer args."""

    continue_path: str = ""
    restore_path: str = ""
    grad_accum_steps: int = 1
    small_run: Optional[int] = None
    device: str = "cuda"


class KeepAverage:
    """Running averages of named scalars (Coqui's `KeepAverage`)."""

    def __init__(self):
        self.avg_values: Dict[str, float] = {}
        self.iters: Dict[str, int] = {}

    def update_values(self, name_dict: Dict[str, float]):
        for name, value in name_dict.items():
            if name not in self.avg_values:
                self.avg_values[name], self.iters[name] = value, 0
                continue
            self.avg_values[name] = (self.avg_values[name] * self.iters[name] + value) / (self.iters[name] + 1)
            self.iters[name] += 1


def _print_stats(step: int, stats: Dict):
    msg = " | ".join(f"{k}: {v:.5f}" if isinstance(v, float) else f"{k}: {v}" for k, v in stats.items())
    print(f"   --> STEP: {step} | {msg}", flush=True)


class Trainer:
    def __init__(self, args: TrainerArgs, config, output_path: str, model=None, train_samples: Optional[List] = None,
                 eval_samples: Optional[List] = None, assets: Optional[Dict] = None):
        self.args = args
        self.config = config
        self.output_path = output_path
        os.makedirs(output_path, exist_ok=True)
        self.model = model
        if args.small_run:
            print(f" > [!] Small Run: only {args.small_run} samples used")
            train_samples = train_samples[: args.small_run] if train_samples else train_samples
            eval_samples = eval_samples[: args.small_run] if eval_samples else eval_samples
        self.train_samples = train_samples
        self.eval_samples = eval_samples
        self.assets = assets or {}
        self.total_steps_done = 0
        self.epochs_done = 0
        self.best_loss = float("inf")
        self.keep_avg_train = KeepAverage()

        self.device = resolve_device(args.device)
        if self.device != model.device:
            raise ValueError(f"the model is on {model.device}, the trainer was asked for {self.device}")
        model.init_training()
        if hasattr(model, "on_init_start") and self.train_samples:
            model.on_init_start(self)  # files beside the run's checkpoints, frozen parts the loss reads
        seed = getattr(config, "training_seed", 54321) or 54321
        torch.manual_seed(seed)  # dropout's generators, the CPU's and every card's
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.num_optimizers = model.num_optimizers()
        self.optimizers = model.get_optimizer()
        for opt in self.optimizers:
            opt.accum_steps = int(args.grad_accum_steps or 1)
            if opt.accum_steps < 1:
                raise ValueError(f"grad_accum_steps must be >= 1, got {args.grad_accum_steps}")
        n_params = sum(p.numel() for i in range(self.num_optimizers) for p in model.optimizer_params(i))
        print(f"\n > Model has {n_params} parameters", flush=True)
        self.autocast = precision.autocast_enabled(config, model)
        self.keep_fp32_keys = tuple(getattr(model, "mp_keep_fp32_batch_keys", ()) or ())
        self.dashboard_logger = self._init_dashboard_logger()

        if args.continue_path:
            self._restore(args.continue_path, full_state=True)
        elif args.restore_path:
            self._restore(args.restore_path, full_state=False)

    def _init_dashboard_logger(self):
        if getattr(self.config, "dashboard_logger", "tensorboard") != "tensorboard":
            return None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return None
        return SummaryWriter(os.path.join(self.output_path, "logs"))

    # ------------------------------------------------------------------ steps
    def _to_device(self, batch: Dict) -> Dict:
        return {k: v.to(self.device, non_blocking=True) if isinstance(v, torch.Tensor) else v for k, v in batch.items()}

    def _loss(self, batch: Dict, idx: int):
        """The model's (loss, logs) for optimizer `idx`; under the generic
        cast its net's parameters and the batch are bfloat16 for the forward
        and the loss is read in float32."""
        if not self.autocast:
            return self.model.loss_fn(batch, idx, generator=self.generator)
        net = self.model.net
        params16, batch16 = precision.autocast_args(dict(net.named_parameters()), batch, self.keep_fp32_keys)
        loss, logs = precision.call_cast(net, params16, self.model.loss_fn, batch16, idx, generator=self.generator)
        return loss.float(), logs

    def train_step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One step: each optimizer's loss, backward and update in index
        order. The logs stay device scalars; the loop reads them when it
        prints."""
        batch = self._to_device(batch)
        self.model.train(True)
        logs_all = {}
        for idx, opt in enumerate(self.optimizers):
            loss, logs = self._loss(batch, idx)
            loss.backward()
            opt.step()
            prefix = "" if self.num_optimizers == 1 else f"opt{idx}_"
            logs_all[f"{prefix}loss"] = loss.detach()
            logs_all.update({prefix + k: v.detach() for k, v in logs.items()})
        return logs_all

    # ------------------------------------------------------------------ loops
    def fit(self):
        try:
            self._fit()
        except KeyboardInterrupt:
            if getattr(self.config, "save_on_interrupt", True):
                self.save_checkpoint()
            raise
        finally:
            if self.dashboard_logger is not None:
                # `flush` writes what the writer's queue has handed over; `close` waits for the rest
                self.dashboard_logger.close()
                self.dashboard_logger = None

    def _fit(self):
        c = self.config
        if self.dashboard_logger is None:
            self.dashboard_logger = self._init_dashboard_logger()
        train_loader = self.model.get_data_loader(c, self.assets, is_eval=False, samples=self.train_samples,
                                                  verbose=True)
        eval_loader = None
        if getattr(c, "run_eval", True) and self.eval_samples:
            eval_loader = self.model.get_data_loader(c, self.assets, is_eval=True, samples=self.eval_samples,
                                                     verbose=False)
        for epoch in range(self.epochs_done, c.epochs):
            self.keep_avg_train = KeepAverage()
            epoch_start = time.time()
            print(f"\n > EPOCH: {epoch}/{c.epochs} --> {self.output_path}", flush=True)
            train_loader.set_epoch(epoch)
            pending: List = []
            window_start = time.time()

            def flush_pending():
                last = None
                for step_no, dev_logs in pending:
                    flogs = {k: float(v) for k, v in dev_logs.items()}
                    self.keep_avg_train.update_values({f"avg_{k}": v for k, v in flogs.items()})
                    if self.dashboard_logger is not None:
                        for k, v in flogs.items():
                            self.dashboard_logger.add_scalar(f"train/{k}", v, step_no)
                    last = (step_no, flogs)
                pending.clear()
                return last

            for batch in train_loader:
                logs = self.train_step(batch)
                self.total_steps_done += 1
                pending.append((self.total_steps_done, logs))
                if self.total_steps_done % c.print_step == 0:
                    n_window = len(pending)
                    last = flush_pending()  # waits for the device: the window's true wall time
                    if last is not None:
                        step_no, flogs = last
                        flogs["step_time"] = round((time.time() - window_start) / n_window, 4)
                        _print_stats(step_no, flogs)
                    window_start = time.time()
                if c.save_step > 0 and self.total_steps_done % c.save_step == 0 and getattr(c, "save_checkpoints",
                                                                                              True):
                    flush_pending()
                    self.save_checkpoint()
            flush_pending()
            self.epochs_done = epoch + 1
            print(f" > Epoch time: {time.time() - epoch_start:.2f} s")

            eval_loss = None
            if eval_loader is not None and epoch >= getattr(c, "test_delay_epochs", 0):
                eval_loss = self.eval_epoch(eval_loader)
            target = eval_loss if eval_loss is not None else self.keep_avg_train.avg_values.get("avg_loss")
            if target is not None:
                self.best_loss = ckpt_io.save_best_model(target, self.best_loss, self._state_dict(),
                                                         self.output_path, self.total_steps_done, c)
            if self.dashboard_logger is not None:
                self.dashboard_logger.flush()
        self.save_checkpoint()
        self.model.train(False)

    @torch.no_grad()
    def eval_epoch(self, eval_loader) -> float:
        """Every optimizer's loss over the eval batches, in train mode as the
        JAX trainer evaluates; the sum over optimizers of each one's mean.
        The net's buffers (BatchNorm running statistics) are put back after
        it, as the JAX trainer drops its eval steps' `batch_stats`."""
        self.model.train(True)
        losses_by_opt: List[List] = [[] for _ in range(self.num_optimizers)]
        net = getattr(self.model, "net", None)
        buffers = [(b, b.clone()) for b in net.buffers()] if isinstance(net, torch.nn.Module) else []
        for batch in eval_loader:
            batch = self._to_device(batch)
            for idx in range(self.num_optimizers):
                losses_by_opt[idx].append(self._loss(batch, idx)[0])
        for b, saved in buffers:
            b.copy_(saved)
        if any(losses_by_opt):
            avg = float(sum(np.mean([float(x) for x in per_opt]) for per_opt in losses_by_opt if per_opt))
        else:
            avg = float("nan")
        print(f" | > EVAL loss: {avg:.5f}")
        if self.dashboard_logger is not None:
            self.dashboard_logger.add_scalar("eval/loss", avg, self.total_steps_done)
        return avg

    # ------------------------------------------------------------- checkpoint
    def _rng_state(self) -> Dict:
        state = {"generator": self.generator.get_state(), "torch": torch.get_rng_state()}
        if self.device.type == "cuda":
            state["cuda"] = torch.cuda.get_rng_state(self.device)
        return state

    def _state_dict(self) -> Dict:
        return {
            "model": {k: v.detach().cpu() for k, v in self.model.training_state_dict().items()},
            "optimizer": [opt.state_dict() for opt in self.optimizers],
            "step": self.total_steps_done,
            "epoch": self.epochs_done,
            "best_loss": self.best_loss if np.isfinite(self.best_loss) else 1e30,
            "rng": self._rng_state(),
        }

    def save_checkpoint(self):
        path = ckpt_io.save_checkpoint(self._state_dict(), self.output_path, self.total_steps_done,
                                       config=self.config, keep_n=getattr(self.config, "save_n_checkpoints", 5))
        print(f" > CHECKPOINT : {path}")

    def _restore(self, path: str, full_state: bool):
        """Weights from a checkpoint file or the newest in a run directory;
        with `full_state` also the optimizers, step, epoch, best loss and the
        generators' states."""
        if os.path.isdir(path):
            path, _ = ckpt_io.get_last_checkpoint(path)
        print(f" > Restoring from {path} ...")
        state = ckpt_io.load_checkpoint(path)
        self.model.load_training_state(state["model"] if isinstance(state.get("model"), dict) else state, strict=True)
        if not full_state:
            return
        for opt, saved in zip(self.optimizers, state.get("optimizer", [])):
            try:
                opt.load_state_dict(saved)
            except (KeyError, ValueError, TypeError):
                print(" [!] Optimizer state mismatch; reinitializing optimizer.")
        self.total_steps_done = int(state.get("step", 0))
        self.epochs_done = int(state.get("epoch", 0))
        self.best_loss = float(state.get("best_loss", float("inf")))
        rng = state.get("rng")
        if rng is not None:
            self.generator.set_state(rng["generator"])
            torch.set_rng_state(rng["torch"])
            if "cuda" in rng and self.device.type == "cuda":
                torch.cuda.set_rng_state(rng["cuda"], self.device)
