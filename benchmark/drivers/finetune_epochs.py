"""Fine-tune driver: the program's epoch loop on one fold of 8-fold CV.

Set-up makes the traffic's corpus from the seed (songs with exact beats),
runs it through the program's ETL (``build_record``: the configuration's
separation and the log-VQT kernels) and stages it (``StagedDataset``),
splits it as one fold of 8-fold cross-validation (train, validation, test),
makes the weights from the seed and the program's train state on them.
It then takes the first three optimizer steps through the window's own call
(``run_epoch``, one batch of distinct training songs each) and one scored
validation pass, which warms every shape the window uses. The window runs
whole epochs (every training batch, then the scored validation pass) and
ends at the first epoch boundary after ``seconds``.

The check: the ETL's log-VQTs of songs drawn from the seed; the three first
steps (each loss, the first gradient as Adam holds it, the parameters'
change); the window's last training epoch (its mean loss and the
parameters' change), which the reference replays from the parameters and
Adam moments the benchmark copies before each epoch; and the window's last
validation loss, recomputed from the final parameters. Each is against the
reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.reference import counts, hpss, models, train, vqt
from benchmark.reference.songs import make_songs
from benchmark.reference.weights import make_weights

FIRST_STEPS = 3


class Run:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from zeronotesamba_torch.data.annotations import BeatAnnotation
        from zeronotesamba_torch.data.datasets import build_record
        from zeronotesamba_torch.train.supervised import StagedDataset, SupervisedConfig, init_state, run_epoch

        self.run_epoch = run_epoch
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.songs = make_songs(traffic, seed, traffic["songs"])
        names = [f"song{i:03d}" for i in range(len(self.songs))]
        self.index = {n: i for i, n in enumerate(names)}
        records = [build_record(n, sig, BeatAnnotation(list(beats)), separation=config["separation"], device=device)
                   for n, (sig, beats) in zip(names, self.songs)]
        # The fold: within each tempo a seeded order gives its first song to the test fold (which
        # a fold's training never reads), the second to validation, the rest to training, so
        # every seed splits the same tempos.
        rng = np.random.default_rng(int(seed) % 2**64)
        per_tempo = [rng.permutation(np.arange(t, len(names), traffic["tempos"])).tolist()
                     for t in range(traffic["tempos"])]
        self.val = [p[1] for p in per_tempo]
        self.train = rng.permutation(sum((p[2:] for p in per_tempo), [])).tolist()
        self.etl_pick = rng.choice(len(names), size=traffic["check_songs"], replace=False).tolist()
        # The program's log-VQTs of the songs the check reads: the ETL's sample, the training and validation songs.
        self.kept = {i: records[i].vqt for i in sorted(set(self.etl_pick + self.train + self.val))}
        self.staged = StagedDataset(records, traffic["bucket_frames"], device=device)
        del records
        self.cfg = SupervisedConfig(status=config["status"], pre="finetune", lr=traffic["lr"],
                                    eval_method=traffic["decoder"], batch_size=traffic["batch_size"],
                                    bucket_frames=traffic["bucket_frames"], dropout_seed=seed, pos_weight=1.0,
                                    compute_dtype=config["precision"], steps_per_call=traffic["steps_per_call"])
        self.weights = make_weights(config, seed, device)
        self.state = init_state(self.cfg, None, 0, params=self.weights, device=device)
        b = traffic["batch_size"]
        self.first_rows = [self.train[k * b:(k + 1) * b] for k in range(FIRST_STEPS)]
        self.first_losses = []
        for k, rows in enumerate(self.first_rows):
            plan = self.staged.plan([names[i] for i in rows], b)
            _, loss, _ = run_epoch(self.state, self.staged, plan, self.cfg, train=True, epoch=k, score=False)
            self.first_losses.append(loss)
            if k == 0:
                # Adam's first moment after one step is (1 - beta1) g; a leaf it never saw reads 0.
                opt = self.state.optimizer
                self.first_grad = {_key(n): (opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                                             / (1 - train.BETAS[0])).cpu()
                                   for n, p in self.state.model.named_parameters()}
        self.after_first = {_key(n): p.detach().cpu().clone() for n, p in self.state.model.named_parameters()}
        self.val_plan = self.staged.plan([names[i] for i in self.val], b)
        self.train_names = [names[i] for i in self.train]
        self.shuffle = np.random.default_rng([int(seed) % 2**64, 1])
        run_epoch(self.state, self.staged, self.val_plan, self.cfg, train=False, score=True)
        # Where each epoch's starting parameters and Adam moments are copied to, on the device.
        self.snapshot = [t.detach().clone() for t in self._live()]
        self.epoch = FIRST_STEPS
        self.steps = self.val_songs = self.attempted = self.failed = 0
        self.epoch_s: list = []
        self.window_s = 0.0

    def window(self, seconds: float, span) -> None:
        t_start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            plan = self.staged.plan(self.train_names, self.cfg.batch_size, shuffle_rng=self.shuffle)
            self.attempted += len(plan)
            with torch.no_grad():
                torch._foreach_copy_(self.snapshot, self._live())
            self.last = {"plan": plan, "epoch": self.epoch, "steps_before": FIRST_STEPS + self.steps}
            with span("train_epoch"):
                self.state, self.last["loss"], _ = self.run_epoch(self.state, self.staged, plan, self.cfg, train=True,
                                                                  epoch=self.epoch, score=False)
            self.steps += len(plan)
            with span("val_pass"):
                _, self.val_loss, _ = self.run_epoch(self.state, self.staged, self.val_plan, self.cfg, train=False,
                                                     score=True)
            self.val_songs += len(self.val)
            self.epoch += 1
            self.epoch_s.append(time.perf_counter() - t0)
            if time.perf_counter() - t_start >= seconds:
                break
        self.window_s = time.perf_counter() - t_start

    def _live(self) -> list:
        """Each parameter with its Adam moments (zero where Adam holds none),
        in the order of the program's parameters."""
        out = []
        for p in self.state.model.parameters():
            held = self.state.optimizer.state.get(p, {})
            out += [p] + [held[k] if k in held else torch.zeros_like(p) for k in ("exp_avg", "exp_avg_sq")]
        return out

    def end_to_end(self) -> dict:
        e = np.asarray(self.epoch_s)
        print(f"epochs {e.size}, steps {self.steps}: epoch s median {np.median(e):.4f}, min {e.min():.4f}, "
              f"max {e.max():.4f}", flush=True)
        return {self.traffic["step_metric"]: self.window_s / self.steps * 1e3}

    def _frames(self) -> int:
        """The bucket every song is padded to: its frames rounded up to ``bucket_frames``."""
        frames = 1 + int(round(self.traffic["duration_s"] * self.traffic["sample_rate"])) // vqt.HOP
        return -(-frames // self.traffic["bucket_frames"]) * self.traffic["bucket_frames"]

    def facts(self) -> dict:
        t = self._frames()
        return {"flops": self.steps * counts.train_flops(self.config, self.cfg.batch_size, t)
                + counts.forward_flops(self.config, self.val_songs, t)}

    def release(self) -> None:
        keys = [_key(n) for n, _ in self.state.model.named_parameters()]
        self.final = {_key(n): p.detach().cpu().clone() for n, p in self.state.model.named_parameters()}
        snap = [t.cpu() for t in self.snapshot]
        self.last.update(params=dict(zip(keys, snap[0::3])), moments=(dict(zip(keys, snap[1::3])),
                                                                       dict(zip(keys, snap[2::3]))),
                         rows=[[self.index[self.staged.buckets[t].names[r]] for r in rows]
                               for t, rows in self.last["plan"]])
        self.state = self.staged = self.snapshot = None

    # -- the check -------------------------------------------------------------------------------------

    def _ref_vqt(self, i: int, dtype: torch.dtype) -> np.ndarray:
        """The reference's ETL of song ``i``: the configuration's separation
        and the log-VQT in ``dtype``."""
        with models.tf32(False), torch.no_grad():
            y = torch.as_tensor(self.songs[i][0], device=self.device)[None]
            if self.config["separation"] == "hpss":
                y = torch.cat(hpss.hpss(y))
            return vqt.log_vqt(y, dtype).double().cpu().numpy()

    def _batch(self, rows, vqts):
        pad = float(np.log(vqt.LOG_EPS))
        return train.batch([torch.as_tensor(vqts[i], dtype=torch.float32, device=self.device) for i in rows],
                           [self.songs[i][1] for i in rows], self._frames(), pad, self.config["fps"])

    def _stages(self, vqts: dict, final: dict, tf32: bool) -> dict:
        """The reference's training and validation on the given log-VQTs:
        the three first steps from the seed's weights; the window's last
        epoch from the parameters and moments it started from, its rows and
        dropout streams; the validation loss of ``final``."""
        lr = self.traffic["lr"] * self.config["lr_scale"]
        gens = [train.dropout_generator(self.seed, k * 100003, self.device) for k in range(FIRST_STEPS)]
        last = self.last
        last_gens = [train.dropout_generator(self.seed, last["epoch"] * 100003 + i, self.device)
                     for i in range(len(last["rows"]))]
        with models.tf32(tf32):
            steps = train.train_steps(self.weights, self.config, [self._batch(r, vqts) for r in self.first_rows],
                                      gens, lr)
            epoch = train.train_steps({k: v.to(self.device) for k, v in last["params"].items()}, self.config,
                                      [self._batch(r, vqts) for r in last["rows"]], last_gens, lr,
                                      moments=last["moments"], steps_done=last["steps_before"])
            x, pulse, mask = self._batch(self.val, vqts)
            loss, _ = train.evaluate({k: v.to(self.device) for k, v in final.items()}, self.config, x, pulse, mask)
        cpu = lambda d: {k: v.cpu() for k, v in d.items()}  # noqa: E731
        return {"losses": steps["losses"], "first_grad": cpu(steps["first_grad"]), "after_first": cpu(steps["params"]),
                "epoch_loss": float(np.mean(epoch["losses"])), "epoch_grad": cpu(epoch["first_grad"]),
                "after_epoch": cpu(epoch["params"]), "val_loss": loss}

    def readings(self, control: bool = False) -> dict:
        """The compared numbers, stage by stage: the ETL's log-VQTs against
        the reference's from the raw songs; the three first steps, the
        window's last epoch and its last validation loss against the
        reference's on the answer's own log-VQTs. With ``control``, the
        answers are the reference's own one precision below: its log-VQTs
        in bfloat16 (TF32 leaves that transform as it is), its training and
        validation with TF32 on."""
        if control:
            vqts = {i: self._ref_vqt(i, torch.bfloat16) for i in self.kept}
            got = dict(self._stages(vqts, self.final, True), vqt=vqts)
        else:
            got = {"vqt": self.kept, "losses": self.first_losses, "first_grad": self.first_grad,
                   "after_first": self.after_first, "epoch_loss": self.last["loss"], "after_epoch": self.final,
                   "val_loss": self.val_loss}
        ref = self._stages(got["vqt"], self.final, False)
        w0 = {k: v.detach().cpu() for k, v in self.weights.items()}
        update = self._update_gaps(got["after_first"], ref["after_first"], w0, ref["first_grad"])
        epoch = self._update_gaps(got["after_epoch"], ref["after_epoch"], self.last["params"], ref["epoch_grad"])
        self.worst_leaves = [sorted(g.items(), key=lambda kv: -kv[1])[:3] for g in (update, epoch)]
        return {
            "etl_vqt_gap": max(vqt.peak_gap(got["vqt"][i], self._ref_vqt(i, torch.float64)) for i in self.etl_pick),
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])),
            "grad_gap": train.leaf_gap(got["first_grad"], ref["first_grad"], list(ref["first_grad"])),
            "update_gap": max(update.values()),
            "epoch_loss_gap": abs(got["epoch_loss"] - ref["epoch_loss"]) / abs(ref["epoch_loss"]),
            "epoch_update_median_gap": float(np.median(list(epoch.values()))),
            "val_loss_gap": abs(got["val_loss"] - ref["val_loss"]) / abs(ref["val_loss"]),
        }

    @staticmethod
    def _update_gaps(got: dict, ref: dict, before: dict, ref_grad: dict) -> dict:
        """Each moved leaf's gap between the norms of the two changes from ``before``."""
        moved = train.moved_leaves(ref_grad)
        return train.leaf_gaps({k: got[k] - before[k] for k in moved}, {k: ref[k] - before[k] for k in moved}, moved)


def _key(name: str) -> str:
    """The program's parameter name as the configuration's weight key."""
    return name[len("pretext."):] if name.startswith("pretext.") else name
